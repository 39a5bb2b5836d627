"""The port's int8 gradient sync (``runtime/compression.py``) and exact
f32 sync (``runtime/collectives.py:DPComm``) over gloo ranks on the CPU
(``launch.mesh.spawn``, one spawn a rank count), against the JAX
package's ``compressed_psum`` run under ``jax.vmap(...,
axis_name="data")``, which binds the axis without devices (its own
``shard_map`` test needs eight of them).

Tolerance: none where bits are compared. ``compressed_psum`` is the
reference's arithmetic step for step (f32 division, round half to even,
the int8 clip, the payloads' f32 sum, whose terms are integers and so
exact in any order), so ``g_sync`` and every rank's residual are bitwise
the reference's over two steps of error feedback. The exact sync at two
ranks is one f32 addition a element, bitwise numpy's; at four the ring's
order is its own: three f32 roundings, so within ``2 eps sum|g_r|`` of
the f64 sum, and bitwise the same on every rank. The reference's own test (a Gaussian gradient: the
mean within 2% relative L2, the residual below max|g| / 100) is run on
the port at four ranks.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.runtime.compression import compressed_psum as jcompressed_psum
from repro_torch.launch.mesh import spawn
from repro_torch.runtime.collectives import DPComm
from repro_torch.runtime.compression import (compressed_psum,
                                             init_error_feedback, wire_bytes)

TIMEOUT_S = 90
SHAPES = {"w": (16, 24), "b": (24,), "s": (), "zero": (3, 5),
          "h": (7, 9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global_grads(n, seed):
    """Every rank's gradient tree stacked on a leading axis of ``n``: f32
    leaves of mixed scale, one all zero, and a bf16 leaf ``h`` (as bf16
    bits), so the cast back is held too."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shp in SHAPES.items():
        v = rng.standard_normal((n,) + shp).astype(np.float32)
        if k == "zero":
            v[:] = 0
        elif k == "b":
            v *= np.float32(1e-3)
        out[k] = v
    out["h"] = out["h"].astype(ml_dtypes.bfloat16)
    return out


def _to_torch(v):
    v = np.asarray(v)
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(v.copy())


def _to_np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _gathered(obj):
    import torch.distributed as dist
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, obj)
    return objs


def rank_sync(mesh, inp):
    """This rank's share of two steps of ``compressed_psum`` (a residual
    carried from the first into the second), the exact sync of a
    gradient list (in small buckets, one leaf larger than a bucket), and
    the reference's Gaussian case; every rank's results, gathered."""
    import torch.distributed as dist
    r = mesh.data_rank
    comm = DPComm(mesh)
    mine = {"steps": []}
    err = init_error_feedback({k: _to_torch(v[r]) for k, v in
                               inp["g1"].items()})
    for g in (inp["g1"], inp["g2"]):
        g_sync, err = compressed_psum({k: _to_torch(v[r]) for k, v in
                                       g.items()}, err, mesh.data_group)
        mine["steps"].append(({k: _to_np(v) for k, v in g_sync.items()},
                              {k: v.numpy().copy() for k, v in err.items()}))
    leaves = [torch.from_numpy(v[r].copy()) for v in inp["exact"]]
    leaves.insert(1, None)
    synced = comm.sync_grads(leaves, bucket_elems=100)
    mine["exact"] = [None if t is None else t.numpy().copy()
                     for t in synced]
    mine["wire"] = comm.wire["f32"]
    gs, e = compressed_psum({"w": torch.from_numpy(inp["gauss"][r].copy())},
                            {"w": torch.zeros(inp["gauss"].shape[1:])},
                            mesh.data_group)
    mine["gauss"] = (gs["w"].numpy().copy(), e["w"].numpy().copy())
    mine["world"] = dist.get_world_size(mesh.data_group)
    return _gathered(mine)


def _jax_reference(g1, g2, n):
    """The reference's two steps under ``vmap`` over the data axis: the
    per-rank outputs stacked on the leading axis."""
    fn = jax.vmap(lambda g, e: jcompressed_psum(g, e, "data"),
                  axis_name="data")
    j1 = {k: jnp.asarray(v) for k, v in g1.items()}
    err = jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), j1)
    out = []
    for g in (j1, {k: jnp.asarray(v) for k, v in g2.items()}):
        g_sync, err = fn(g, err)
        out.append((jax.tree.map(np.asarray, g_sync),
                    jax.tree.map(np.asarray, err)))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def synced(request):
    n = request.param
    rng = np.random.default_rng(5)
    inp = {"g1": _global_grads(n, 1), "g2": _global_grads(n, 2),
           "exact": [rng.standard_normal((n, 130)).astype(np.float32),
                     rng.standard_normal((n, 40)).astype(np.float32),
                     rng.standard_normal((n, 3, 30)).astype(np.float32)],
           "gauss": rng.standard_normal((n, 64)).astype(np.float32)}
    ranks = spawn(rank_sync, n, inp, device="cpu", backend="gloo",
                  timeout_s=TIMEOUT_S)
    return n, inp, ranks


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else \
        a.view(np.uint32)


class TestCompressedPsum:
    def test_bitwise_the_reference_under_vmap(self, synced):
        n, inp, ranks = synced
        ref = _jax_reference(inp["g1"], inp["g2"], n)
        assert all(r["world"] == n for r in ranks)
        for step in range(2):
            want_g, want_e = ref[step]
            for r, got in enumerate(ranks):
                g_sync, err = got["steps"][step]
                for k in SHAPES:
                    assert g_sync[k].dtype == want_g[k].dtype, k
                    np.testing.assert_array_equal(
                        _bits(g_sync[k]), _bits(want_g[k][r]),
                        err_msg=f"g_sync {k} step {step} rank {r}")
                    np.testing.assert_array_equal(
                        _bits(err[k]), _bits(want_e[k][r]),
                        err_msg=f"new_err {k} step {step} rank {r}")

    def test_every_rank_gets_the_same_mean(self, synced):
        _, _, ranks = synced
        for step in range(2):
            for k in SHAPES:
                first = _bits(ranks[0]["steps"][step][0][k])
                for got in ranks[1:]:
                    np.testing.assert_array_equal(
                        _bits(got["steps"][step][0][k]), first)

    def test_reference_gaussian_case(self, synced):
        """The reference's ``test_compressed_psum_matches_mean`` on the
        port: the mean within 2% relative L2, the residual below one
        hundredth of the largest gradient."""
        n, inp, ranks = synced
        g = inp["gauss"]
        true_mean = g.mean(0)
        for got in ranks:
            out, err = got["gauss"]
            rel = np.linalg.norm(out - true_mean) / np.linalg.norm(true_mean)
            assert rel < 0.02, rel
            assert np.max(np.abs(err)) < np.max(np.abs(g)) / 100.0


class TestExactSync:
    def test_bucketed_sum(self, synced):
        n, inp, ranks = synced
        for i, want in zip((0, 2, 3), inp["exact"]):
            total = want.astype(np.float64).sum(0)
            for got in ranks:
                v = got["exact"][i]
                if n == 2:
                    np.testing.assert_array_equal(v, want[0] + want[1])
                else:
                    bound = 2 * np.finfo(np.float32).eps * np.abs(
                        want).astype(np.float64).sum(0)
                    assert np.all(np.abs(v - total) <= bound), i
                np.testing.assert_array_equal(v, ranks[0]["exact"][i])
        assert all(got["exact"][1] is None for got in ranks)
        assert ranks[0]["wire"] == wire_bytes([130, 40, 90], n, "f32")


def test_wire_bytes():
    assert wire_bytes([1000], 1, "f32") == 0
    assert wire_bytes([1000, 24], 2, "f32") == 4096
    assert wire_bytes([1000, 24], 2, "int8") == 1024 + 8
    assert wire_bytes([1000], 4, "int8") == 3000 + 6
    with pytest.raises(ValueError):
        wire_bytes([1], 2, "bf16")


def test_init_error_feedback():
    g = {"a": torch.ones(3, dtype=torch.bfloat16), "b": None,
         "c": [torch.ones((2, 2))]}
    e = init_error_feedback(g)
    assert e["b"] is None
    assert e["a"].dtype == torch.float32 and e["a"].shape == (3,)
    assert torch.equal(e["c"][0], torch.zeros((2, 2)))
