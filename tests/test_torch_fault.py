"""The port's fault machinery (``runtime/fault.py``) against the JAX
package's classes on the same inputs (the reference's
``tests/test_checkpoint_fault.py::TestFaultMachinery``, each case run
through both), and the port's ``ShardedLoader`` (the reference's
``tests/test_data_serve.py::test_sharded_loader_prefetch``, and at data
2 each rank's rows against the global batch's).

Tolerance: none; the classes are pure logic and the loader moves bits.
"""
import numpy as np
import pytest
import torch

from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.runtime import fault as jfault
from repro_torch.data import MixtureIterator, ShardedLoader, SyntheticConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime import fault as tfault

PACKAGES = [jfault, tfault]


def _both(fn):
    """``fn`` run on the reference's module and on the port's; their
    results, which must be equal."""
    got = [fn(m) for m in PACKAGES]
    assert got[0] == got[1], got
    return got[1]


class TestFaultMachinery:
    def test_straggler_detection(self):
        def run(m):
            mon = m.HeartbeatMonitor(n_workers=4)
            for w in range(4):
                mon.beat(w, step_time=1.0 if w != 2 else 5.0, now=100.0)
            return mon.stragglers(), mon.healthy_quorum(now=100.0), \
                mon.median_step_time()
        assert _both(run)[:2] == ([2], [0, 1, 3])

    def test_dead_detection(self):
        def run(m):
            mon = m.HeartbeatMonitor(n_workers=3, timeout_s=10.0)
            mon.beat(0, 1.0, now=0.0)
            mon.beat(1, 1.0, now=0.0)
            # worker 2 never beats; workers 0, 1 beat recently at t=5
            mon.beat(0, 1.0, now=5.0)
            mon.beat(1, 1.0, now=5.0)
            return (mon.dead(now=6.0), mon.dead(now=100.0),
                    m.HeartbeatMonitor(n_workers=2).dead(now=0.0))
        assert _both(run) == ([2], [0, 1, 2], [0, 1])

    def test_window_keeps_the_last_beats(self):
        def run(m):
            mon = m.HeartbeatMonitor(n_workers=2, window=3)
            for t in range(6):
                mon.beat(0, float(t), now=float(t))
            mon.beat(1, 2.0, now=6.0)
            return mon._beats[0], mon.stragglers(), mon.median_step_time()
        assert _both(run)[0] == [3.0, 4.0, 5.0]

    def test_restart_policy_backoff_and_budget(self):
        def run(m):
            rp = m.RestartPolicy(max_restarts=3, backoff_base_s=1.0)
            delays = [rp.next_delay() for _ in range(4)]
            rp2 = m.RestartPolicy(max_restarts=2)
            rp2.next_delay()
            rp2.record_success(steps_since_restart=50)
            kept = rp2.restarts
            rp2.record_success(steps_since_restart=500)
            capped = m.RestartPolicy(max_restarts=20, backoff_base_s=5.0,
                                     backoff_cap_s=60.0)
            return delays, kept, rp2.restarts, [capped.next_delay()
                                                for _ in range(6)]
        delays, kept, after, capped = _both(run)
        assert delays[:3] == [1.0, 2.0, 4.0] and delays[3] is None
        assert kept == 1 and after == 0    # budget resets after stability
        assert capped[-1] == 60.0

    @pytest.mark.parametrize("healthy", [512, 255, 100, 10, 16, 0])
    def test_elastic_shrink(self, healthy):
        got = _both(lambda m: m.ElasticPlan(
            data_axis=16, model_axis=16).shrink_for(healthy))
        want = {512: (16, 16), 255: (8, 16), 100: (4, 16), 10: None,
                16: (1, 16), 0: None}[healthy]
        assert got == want

    def test_heartbeat_file_roundtrip(self, tmp_path):
        for m in PACKAGES:
            d = str(tmp_path / m.__name__)
            hb = m.HeartbeatFile(d, worker=3)
            hb.write(step=7, step_time=1.25)
            (tmp_path / m.__name__ / "hb_00004.json").write_text("{torn")
            all_hb = tfault.HeartbeatFile.read_all(d)
            assert sorted(all_hb) == [3]
            assert all_hb[3]["step"] == 7
            assert abs(all_hb[3]["step_time"] - 1.25) < 1e-9
        assert tfault.HeartbeatFile.read_all(str(tmp_path / "none")) == {}


class TestShardedLoader:
    def test_sharded_loader_prefetch(self):
        cfg = SyntheticConfig(vocab_size=128, seq_len=16, batch_size=2)
        loader = ShardedLoader(MixtureIterator(cfg), mesh=None, prefetch=2)
        b = next(loader)
        assert b["tokens"].shape == (2, 16)
        assert isinstance(b["tokens"], torch.Tensor)

    def test_batches_bitwise_the_reference_iterator(self):
        cfg = SyntheticConfig(vocab_size=128, seq_len=16, batch_size=4,
                              seed=3)
        loader = ShardedLoader(MixtureIterator(cfg), prefetch=1)
        ref = JMixture(JSynth(vocab_size=128, seq_len=16, batch_size=4,
                              seed=3))
        for _ in range(3):
            got, want = next(loader), next(ref)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])

    @pytest.mark.parametrize("prefetch", [0, 1, 3])
    def test_data_2_rows_and_state(self, prefetch):
        """At data 2 each rank's loader hands out its half of every
        global batch, rows in rank order; ``state_dict`` is the state as
        of the last batch handed out, whatever was prefetched, so an
        iterator restored from it yields the next one."""
        cfg = SyntheticConfig(vocab_size=128, seq_len=8, batch_size=4,
                              seed=1)
        glob = MixtureIterator(cfg)
        loaders = [ShardedLoader(MixtureIterator(cfg), mesh=Mesh(
            shape={"data": 2, "model": 1}, rank=0, data_rank=r,
            device=torch.device("cpu")), prefetch=prefetch)
            for r in range(2)]
        for _ in range(3):
            want = next(glob)
            for r, ld in enumerate(loaders):
                got = next(ld)
                for k, v in want.items():
                    np.testing.assert_array_equal(got[k].numpy(),
                                                  v[2 * r:2 * r + 2])
        state = loaders[0].state_dict()
        assert state == glob.state_dict()
        resumed = MixtureIterator(cfg)
        resumed.load_state_dict(state)
        np.testing.assert_array_equal(next(resumed)["tokens"],
                                      next(glob)["tokens"])

    def test_batch_axes_other_than_data_refused(self):
        with pytest.raises(NotImplementedError, match="pod"):
            ShardedLoader(iter([]), batch_axes=("pod", "data"))
