"""The port's checkpointer against the JAX package's on-disk format, and
its fault-tolerance behaviour (mirrors ``tests/test_checkpoint_fault.py``).

A checkpoint of (params, AdamW state) written by one package restores in
the other, bf16 leaves included, bitwise. Keep-k garbage collection, a
torn ``.tmp`` directory, a crash and resume of ``run_qat`` (which must
continue to the same parameters, bitwise, as an uninterrupted run: every
step is deterministic on the CPU), and the heartbeat file.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_reduced_config
from repro.models import init_params as jinit
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.runtime.fault import HeartbeatFile as JHeartbeatFile
from repro_torch import bridge
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.train import run_qat
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime.fault import HeartbeatFile
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jstate():
    """Reference (params, AdamW state) after one update, so the moments
    and the step are not their initial zeros."""
    cfg = get_reduced_config("qwen2.5-3b")
    params = jinit(cfg, jax.random.PRNGKey(1))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    opt = jadamw_init(params)
    params, opt = jadamw_update(params, grads, opt, lr=jnp.float32(1e-3))
    return params, opt


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _port_template(jparams):
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.no_grad():
        for t in tree_leaves(tp):
            t.zero_()
    return tp, adamw_init(tp)


def _port_flat(params, opt):
    flat = {f"0/{k}": v for k, v in bridge.flatten(
        bridge.params_to_numpy(params, ml_dtypes.bfloat16))}
    flat["1/.step"] = opt.step.numpy()
    for name, tree in ((".m", opt.m), (".v", opt.v)):
        flat.update({f"1/{name}/{k}": v for k, v in bridge.flatten(
            bridge.params_to_numpy(tree))})
    return flat


def _ref_flat(params, opt):
    flat = {f"0/{k}": v for k, v in bridge.flatten(
        jax.tree.map(np.asarray, params))}
    flat["1/.step"] = np.asarray(opt.step)
    for name, tree in ((".m", opt.m), (".v", opt.v)):
        flat.update({f"1/{name}/{k}": v for k, v in bridge.flatten(
            jax.tree.map(np.asarray, tree))})
    return flat


def test_reference_checkpoint_restores_in_port(tmp_path, jstate):
    jparams, jopt = jstate
    JCheckpointer(str(tmp_path)).save(7, (jparams, jopt),
                                      {"step": 7, "data": {"step": 8}})
    tp, topt = _port_template(jparams)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    (tp2, topt2), extra = ck.restore((tp, topt))
    assert tp2 is tp and extra == {"step": 7, "data": {"step": 8}}
    got, want = _port_flat(tp, topt), _ref_flat(jparams, jopt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)
    assert tp["embed"]["w"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_reference(tmp_path, jstate):
    jparams, jopt = jstate
    to_port = lambda t: bridge.params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, t), "cpu")
    topt = AdamWState(step=torch.tensor(int(jopt.step), dtype=torch.int32),
                      m=to_port(jopt.m), v=to_port(jopt.v))
    ck = Checkpointer(str(tmp_path))
    ck.save_async(3, (to_port(jparams), topt), {"step": 3})
    ck.wait()
    template = jax.tree.map(jnp.zeros_like, (jparams, jopt))
    (rp, ropt), extra = JCheckpointer(str(tmp_path)).restore(template)
    assert extra == {"step": 3}
    got, want = _ref_flat(rp, ropt), _ref_flat(jparams, jopt)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)


def _small_tree():
    return {"a": torch.randn(8, 4),
            "nested": {"b": torch.arange(6).reshape(2, 3),
                       "scales": (torch.tensor(0.5),
                                  torch.tensor(3, dtype=torch.int32))},
            "layers": [{"w": torch.randn(3).to(torch.bfloat16)}
                       for _ in range(2)]}


def test_roundtrip_keep_k_and_torn_write(tmp_path):
    tree = _small_tree()
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, tree, {"step": s})
    assert ck.list_steps() == [3, 4]
    os.makedirs(tmp_path / "step_0000000005.tmp")       # crashed writer
    assert ck.latest_step() == 4
    blank = {"a": torch.zeros(8, 4),
             "nested": {"b": torch.zeros(2, 3, dtype=torch.int64),
                        "scales": (torch.tensor(0.0),
                                   torch.tensor(0, dtype=torch.int32))},
             "layers": [{"w": torch.zeros(3, dtype=torch.bfloat16)}
                        for _ in range(2)]}
    restored, extra = ck.restore(blank)
    assert extra == {"step": 4}
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(KeyError, match="missing"):
        ck.restore({"zzz": torch.zeros(1)})
    with pytest.raises(ValueError, match="template"):
        ck.restore({**blank, "a": torch.zeros(4, 8)})


def test_crash_and_resume_continue_to_the_same_parameters(tmp_path):
    """Kill training at step 2 (after the checkpoint of step 2, before the
    step's own); resume; the result equals an uninterrupted run, bitwise
    (parameters, moments and the data iterator come back)."""
    tcfg = TrainConfig(total_steps=4, ref_steps=4, batch_size=2, seq_len=16)
    kw = dict(teacher_steps=1, device="cpu", log_every=100, ckpt_every=2)
    _, straight, _ = run_qat("qwen2.5-3b", tcfg, **kw)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(SystemExit) as exc:
        run_qat("qwen2.5-3b", tcfg, ckpt_dir=ckpt, simulate_failure_at=2,
                **kw)
    assert exc.value.code == 42
    assert Checkpointer(ckpt).latest_step() == 2
    _, resumed, _ = run_qat("qwen2.5-3b", tcfg, ckpt_dir=ckpt, resume=True,
                            **kw)
    assert Checkpointer(ckpt).latest_step() == 4
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_heartbeat_file_roundtrip_and_reference_reads_it(tmp_path):
    hb = HeartbeatFile(str(tmp_path), worker=3)
    hb.write(17, 0.25)
    (tmp_path / "hb_00004.json").write_text("{torn")
    beats = HeartbeatFile.read_all(str(tmp_path))
    assert list(beats) == [3]
    assert beats[3]["step"] == 17 and beats[3]["step_time"] == 0.25
    assert JHeartbeatFile.read_all(str(tmp_path))[3]["step"] == 17
    assert HeartbeatFile.read_all(str(tmp_path / "absent")) == {}
