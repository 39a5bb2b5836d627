"""The port's sharding rules (``repro_torch/runtime/sharding.py``) against
the JAX package's (``repro/runtime/sharding.py``), and the mesh's errors.

The rules are pure functions of (config, mesh, path, shape), so both
packages' are called on the same leaves of the ten archs' reduced trees
(bf16, and the w4a8 export trees where the layout allows) on the
reference's ``FakeMesh`` at model 2 and 4: every spec must be equal
(the reference's ``PartitionSpec`` padded with None to the leaf's rank).
The port's per-layer tree (``bridge.params_from_numpy``) must get the
reference's spec of its stacked leaf without the layer axis, and
``shard_params`` must hand each rank exactly the ``np.split`` piece of
the reference's leaf that its spec names.

Tolerance: none; specs and slices are compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config, get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.runtime import sharding as jsh
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_get_reduced_config
from repro_torch.core.qat import make_ctx
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import init_cache, init_params
from repro_torch.runtime import sharding as tsh
from repro_torch.runtime.sharding import (local_bytes, param_spec,
                                          serve_cache_spec, shard_params)
from repro_torch.serve.engine import ServeEngine

POLICY = "A8d-C8-W4"
# the reduced xlstm's sLSTM up-projection is odd (no int4 packing) and
# whisper's reference export needs its encoder's calibration: their w4a8
# trees are not built in either package's tests
W4A8_ARCHS = tuple(a for a in ARCH_IDS
                   if a not in ("xlstm-125m", "whisper-large-v3"))


class FakeMesh:
    axis_names = ("data", "model")

    def __init__(self, data=4, model=2):
        self.shape = {"data": data, "model": model}


def _ref(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jsh._path_str(p), leaf) for p, leaf in flat]


_TREES = {}


def _tree(arch, w4a8):
    key = (arch, w4a8)
    if key not in _TREES:
        cfg = get_reduced_config(arch)
        params = jax_init_params(cfg, jax.random.PRNGKey(0))
        if w4a8:
            # uncalibrated scales export from each channel's absmax: the
            # planes' shapes are what the rules read
            params = jqat.attach_w4a8_exports(params, parse_policy(POLICY))
            params = jqat.attach_w4a8_ref_planes(params)
        _TREES[key] = (cfg, params)
    return _TREES[key]


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_spec_equals_reference(arch, model):
    """Every leaf of the arch's reduced tree (bf16, and its w4a8 export
    tree where built): the port's spec of the reference's (path, shape)
    is the reference's."""
    mesh = FakeMesh(model=model)
    trees = [False] + ([True] if arch in W4A8_ARCHS else [])
    n = 0
    for w4a8 in trees:
        cfg, params = _tree(arch, w4a8)
        tcfg = t_get_reduced_config(arch)
        for path, leaf in _flat(params):
            want = _ref(jsh.param_spec(cfg, mesh, path, leaf.shape),
                        leaf.ndim)
            got = param_spec(tcfg, mesh, path, leaf.shape)
            assert got == want, (arch, path, leaf.shape, got, want)
            n += 1
    assert n > 10


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b",
                                  "recurrentgemma-2b", "whisper-large-v3"])
def test_port_tree_gets_the_stacked_leafs_spec(arch):
    """The port's per-layer leaves (no layer axis) get the reference's
    spec of the stacked leaf they came from, minus its layer axis."""
    cfg, params = _tree(arch, arch in W4A8_ARCHS)
    tcfg = t_get_reduced_config(arch)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       "cpu")
    mesh = FakeMesh(model=2)
    ref = {p: _ref(jsh.param_spec(cfg, mesh, p, leaf.shape), leaf.ndim)
           for p, leaf in _flat(params)}
    period = len(tcfg.block_pattern)
    want = {}
    for path, leaves in bridge.stacked_layers(tparams["layers"], period):
        want[path] = ref[path][1:]
    if "encoder" in tparams:
        for path, _ in bridge.stacked_layers(tparams["encoder"]["layers"]):
            want["encoder/" + path] = ref["encoder/" + path][1:]
    checked = 0
    for i, (seg, _) in enumerate(bridge.segment_index(
            len(tparams["layers"]), period)):
        for path, t in bridge.flatten(tparams["layers"][i]):
            got = param_spec(tcfg, mesh, f"layers/{i}/{path}",
                             tuple(t.shape))
            assert got == want[f"{seg}/{path}"], (path, got)
            checked += 1
    for path, t in bridge.flatten(tparams):
        if not path.startswith(("layers/", "encoder/layers/")):
            assert param_spec(tcfg, mesh, path, tuple(t.shape)) == \
                ref[path], path
    assert checked > 0


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_serve_cache_spec_equals_reference(paged, model):
    """Dense and paged serving caches (reduced qwen2.5-3b at 4 KV heads,
    and at 2 on the 4-way axis: the GQA fallback to replication)."""
    for kv in (4, 2):
        cfg = get_reduced_config("qwen2.5-3b").replace(n_kv_heads=kv)
        tcfg = t_get_reduced_config("qwen2.5-3b").replace(n_kv_heads=kv)
        kw = dict(num_blocks=8, page_size=16, table_len=4) if paged else {}
        jc = jax_init_cache(cfg, jqat.make_ctx(POLICY), 2, 64, **kw)
        mesh = FakeMesh(model=model)
        for path, leaf in _flat(jc):
            want = _ref(jsh.serve_cache_spec(cfg, mesh, path, leaf.shape),
                        leaf.ndim)
            assert serve_cache_spec(tcfg, mesh, path, leaf.shape) == want
        tc = init_cache(tcfg, make_ctx(POLICY), 2, 64, device="cpu", **kw)
        for path, t in bridge.flatten(tc):
            spec = serve_cache_spec(tcfg, mesh, path, tuple(t.shape))
            key = path.split("/")[-1]
            if key in ("k_q", "v_q", "s_k", "s_v"):
                hdim = t.dim() - (3 if key in ("k_q", "v_q") else 2)
                assert spec[hdim] == ("model" if kv % model == 0 else None)
                assert spec[:hdim] == (None,) * hdim   # never the blocks
            else:
                assert all(ax is None for ax in spec), path


def test_training_cache_and_batch_specs_equal_reference():
    cfg = get_reduced_config("qwen2.5-3b").replace(n_kv_heads=4)
    for mesh in (FakeMesh(model=2), FakeMesh(data=1, model=4),
                 FakeMesh(data=8, model=2)):
        for path, shape in (("segments/0/0/self/k_q", (2, 8, 4, 64, 16)),
                            ("segments/0/0/self/s_k", (2, 8, 4, 64)),
                            ("segments/0/0/self/k_q", (2, 1, 2, 64, 16)),
                            ("segments/0/0/self/s_v", (2, 1, 3, 6)),
                            ("segments/0/0/rec/state_q", (2, 4, 64)),
                            ("segments/0/0/self/length", (2, 4)),
                            ("position", (4,))):
            assert tsh.cache_spec(cfg, mesh, path, shape) == _ref(
                jsh.cache_spec(cfg, mesh, path, shape), len(shape))
        for name, shape in (("tokens", (8, 16)), ("tokens", (1, 64)),
                            ("positions", (3, 8, 16)), ("tokens", (3, 5))):
            assert tsh.batch_spec(mesh, shape, name) == _ref(
                jsh.batch_spec(mesh, shape, name), len(shape))


class TestShardingRules:
    """``tests/test_distributed.py::TestShardingRules`` on the port."""

    class Prod:
        shape = {"pod": 2, "data": 16, "model": 16}
        axis_names = ("pod", "data", "model")

    def test_moe_expert_parallel_choice(self):
        class M:
            shape = {"data": 16, "model": 16}
            axis_names = ("data", "model")

        moon = param_spec(get_config("moonshot-v1-16b-a3b"), M(),
                          "segments/0/0/moe/wg/w", (48, 64, 2048, 1408))
        assert moon == (None, "model", None, None)
        mix = param_spec(get_config("mixtral-8x7b"), M(),
                         "segments/0/0/moe/wg/w", (32, 8, 4096, 14336))
        assert mix == (None, None, None, "model")
        # the port's per-layer bank (no layer axis)
        assert param_spec(get_config("mixtral-8x7b"), M(),
                          "layers/3/moe/wd/w", (8, 14336, 4096)) == \
            (None, "model", None)

    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_full_width_specs_divide(self, arch):
        """Every spec of the arch's full-width tree divides its dims on
        the production mesh (shapes only: ``jax.eval_shape``)."""
        from repro.launch.specs import param_struct
        cfg = get_config(arch)
        for path, leaf in _flat(param_struct(cfg)):
            spec = param_spec(cfg, self.Prod(), path, leaf.shape)
            assert spec == _ref(jsh.param_spec(cfg, self.Prod(), path,
                                               leaf.shape), leaf.ndim)
            for dim, ax in zip(leaf.shape, spec):
                if ax is not None:
                    assert dim % tsh._size(self.Prod(), ax) == 0, (path,)


class TestFallbacks:
    def test_nondivisible_falls_back_to_replication(self):
        """A model axis dividing nothing replicates every w4a8 plane."""
        cfg, params = _tree("qwen2.5-3b", True)
        for path, leaf in _flat(params):
            if "w4a8" in path.split("/"):
                spec = param_spec(cfg, FakeMesh(model=3), path, leaf.shape)
                assert all(ax is None for ax in spec), (path, spec)

    def test_odd_packed_axis_replicates(self):
        cfg = get_reduced_config("qwen2.5-3b")
        assert param_spec(cfg, FakeMesh(model=2),
                          "segments/0/0/attn/wo/w4a8/wq", (2, 64, 7)) == \
            (None, None, None)
        assert param_spec(cfg, FakeMesh(model=2),
                          "layers/0/attn/wo/w4a8/wq", (64, 7)) == \
            (None, None)

    def test_vocab_fallback_to_d_model(self):
        cfg = get_reduced_config("qwen2.5-3b")
        assert param_spec(cfg, FakeMesh(model=2), "embed/w", (255, 64)) == \
            (None, "model")
        assert param_spec(cfg, FakeMesh(model=2), "embed/w", (256, 64)) == \
            ("model", None)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_hands_each_rank_its_split(tp):
    """Each rank's leaf is the ``np.split`` piece of the reference's leaf
    (after ``bridge``) on the dim its spec maps to "model"; replicated
    leaves are the same tensor."""
    cfg = get_reduced_config("qwen2.5-3b").replace(n_kv_heads=4)
    jparams = jax_init_params(cfg, jax.random.PRNGKey(1))
    pol = parse_policy(POLICY)
    jparams = jqat.attach_w4a8_exports(
        jqat.calibrate_weight_scales(jparams, pol), pol)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
    tcfg = t_get_reduced_config("qwen2.5-3b").replace(n_kv_heads=4)
    full = dict(bridge.flatten(tparams))
    sharded = 0
    for rank in range(tp):
        mesh = Mesh(shape={"data": 1, "model": tp}, rank=rank,
                    device=torch.device("cpu"))
        local = dict(bridge.flatten(shard_params(tparams, tcfg, mesh)))
        assert local.keys() == full.keys()
        for path, t in full.items():
            spec = param_spec(tcfg, mesh, path, tuple(t.shape))
            want = t
            if "model" in spec:
                dim = spec.index("model")
                want = _np_split(t, tp, dim)[rank]
                sharded += 1
                assert local[path].is_contiguous()
            assert local[path].shape == want.shape, path
            assert torch.equal(local[path], want), path
    assert sharded > 0
    # local_bytes of the full tree under the specs is one rank's bytes
    mesh = Mesh(shape={"data": 1, "model": tp}, rank=0,
                device=torch.device("cpu"))
    specs = {p: param_spec(tcfg, mesh, p, tuple(t.shape))
             for p, t in bridge.flatten(tparams)}
    local0 = shard_params(tparams, tcfg, mesh)
    assert local_bytes(tparams, specs, tp) == sum(
        t.numel() * t.element_size() for _, t in bridge.flatten(local0))


def _np_split(t, n, dim):
    """``np.split`` of a tensor (a bf16 one through its bits)."""
    bf16 = t.dtype == torch.bfloat16
    arr = (t.view(torch.int16) if bf16 else t).numpy()
    out = [torch.from_numpy(p.copy()) for p in np.split(arr, n, axis=dim)]
    return [p.view(torch.bfloat16) for p in out] if bf16 else out


class TestMeshErrors:
    def test_local_mesh_rejects_nondividing_tp(self):
        with pytest.raises(ValueError) as ei:
            make_local_mesh(model_parallel=4)
        assert "4" in str(ei.value) and "1 processes" in str(ei.value)

    def test_engine_rejects_mesh_without_model_axis(self):
        class DataOnly:
            axis_names = ("data",)
            shape = {"data": 1}
            device = torch.device("cpu")

        cfg = t_get_reduced_config("qwen2.5-3b")
        with pytest.raises(ValueError, match="model"):
            ServeEngine(cfg, None, mesh=DataOnly())

    @pytest.mark.parametrize("arch", ["mixtral-8x7b", "recurrentgemma-2b",
                                      "xlstm-125m", "whisper-large-v3",
                                      "moonshot-v1-16b-a3b"])
    def test_engine_refuses_uncovered_archs(self, arch):
        """An encoder-decoder is refused at tp > 1 (its cross caches; the
        engine serves none at tp=1 either: Queue 1 item 3d). An MoE is
        served where tp divides its experts (expert parallelism) or their
        d_ff (TP inside experts: ``tests/test_torch_tp_moe.py``) and
        refused where it divides neither: tp=3 on the reduced MoEs' 4 or
        8 experts of d_ff 64. The recurrent archs are served where tp
        divides the widths their rules cut
        (``tests/test_torch_tp_recurrent.py``) and refused where it does
        not: tp=3 on reduced recurrentgemma's RG-LRU width 64 and on
        reduced xLSTM's 4 mLSTM heads."""
        cfg = t_get_reduced_config(arch)
        tp = 2 if cfg.is_encdec else 3
        mesh = Mesh(shape={"data": 1, "model": tp}, rank=0,
                    device=torch.device("cpu"))
        err, match = ((NotImplementedError, "Queue 1 item 3d")
                      if cfg.is_encdec else
                      (ValueError, "divides neither") if cfg.is_moe else
                      (ValueError, "does not divide"))
        with pytest.raises(err, match=match):
            ServeEngine(cfg, None, mesh=mesh, weights_layout="w4a8")

    def test_engine_still_refuses(self):
        """What ``_check_tp`` still refuses besides the blocks above: a
        dense d_ff that tp divides while its packed rows (d_ff / 2) it
        does not (wd's plane would stay whole under a cut input). Query
        heads that tp does not divide are served now, the whole attention
        on every rank (qwen2-7b's 28 at tp=8, reduced qwen2.5-3b's 4 at
        tp=3, 12 heads on 3 KV heads at tp=2: ``attn_replicated``;
        ``tests/test_torch_tp_serve.py`` serves 6 heads on 3 at tp=4)."""
        from repro_torch.configs import get_config
        from repro_torch.serve.engine import _check_tp
        cfg = t_get_reduced_config("qwen2.5-3b")
        mesh = Mesh(shape={"data": 1, "model": 4}, rank=0,
                    device=torch.device("cpu"))
        with pytest.raises(ValueError, match="packed rows"):
            ServeEngine(cfg.replace(d_ff=132), None, mesh=mesh,
                        weights_layout="w4a8")
        for c, tp in ((get_config("qwen2-7b"), 8), (cfg, 3),
                      (cfg.replace(n_heads=12, n_kv_heads=3), 2)):
            assert tsh.attn_replicated(c, tp)
            _check_tp(c, tp, "w4a8")
        assert not tsh.attn_replicated(cfg, 4)      # one KV head a rank
        assert not tsh.attn_replicated(cfg, 1)

    def test_engine_refuses_the_bf16_layout(self):
        """The bf16 layout is served at tp > 1 now (its row-parallel
        linears sum f32 partials: ``tests/test_torch_tp_recurrent.py``),
        and the refusals that come of packing int4 do not apply to it: a
        dense d_ff whose packed rows tp does not divide (132 at tp=4) is
        refused under w4a8 only; a width tp does not divide is refused
        under either layout."""
        from repro_torch.serve.engine import _check_tp
        cfg = t_get_reduced_config("qwen2.5-3b")
        _check_tp(cfg, 2, "bf16")
        _check_tp(cfg.replace(d_ff=132), 4, "bf16")
        with pytest.raises(ValueError, match="packed rows"):
            _check_tp(cfg.replace(d_ff=132), 4, "w4a8")
        rg = t_get_reduced_config("recurrentgemma-2b")
        _check_tp(rg.replace(lru_width=36), 4, "bf16")
        with pytest.raises(ValueError, match="packed rows"):
            _check_tp(rg.replace(lru_width=36), 4, "w4a8")
        for layout in ("bf16", "w4a8"):
            with pytest.raises(ValueError, match="does not divide"):
                _check_tp(rg, 3, layout)

    def test_spawn_refuses_nccl_off_cuda(self):
        from repro_torch.launch.mesh import spawn_tp
        with pytest.raises(ValueError, match="gloo"):
            spawn_tp(print, 2, device="cpu", backend="nccl")
