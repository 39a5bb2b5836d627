"""The port's expert-parallel streams against the JAX package's engine.

The JAX package's tp=1 paged engine on reduced moonshot-v1-16b-a3b (8
experts, top 2; the port's calibrated params from a seed, bridged to the
reference's layout), run op by op (``jax.disable_jit``, ``w4a8_backend=
"ref"``: the compiled reference flips greedy near-ties on this model,
``test_torch_moonshot_engine.py``), on the reference's ``ENG_KW`` and
the short ``_small_reqs`` workload, against the port at tp=2 (two gloo
ranks, 4 experts a rank: ``launch.mesh.spawn_tp``). The rest of the MoE
tensor-parallel checks are in ``test_torch_tp_moe.py``.

Tolerance: none; greedy and sampled token streams are equal.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from repro.configs import get_reduced_config
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.launch.mesh import spawn_tp
from test_torch_tp_moe import MS, _cfg, _params, rank_small
from test_torch_tp_serve import ENG_KW, TIMEOUT_S, _small_reqs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tp2_streams_equal_jax_engine():
    """The port's streams (greedy and sampled) at tp=2, each rank with 4
    of the 8 experts, are the JAX package's tp=1 paged engine's."""
    cfg = get_reduced_config(MS)
    tree = bridge.params_to_numpy(_params(_cfg(MS)), ml_dtypes.bfloat16)
    reqs = _small_reqs(cfg, cls=JRequest)
    with jax.disable_jit():
        eng = JServeEngine(cfg, jax.tree.map(jnp.asarray, tree),
                           w4a8_backend="ref", **ENG_KW)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    want = [tuple(r.generated) for r in reqs]
    assert len(set(want)) > 1
    assert spawn_tp(rank_small, 2, tree, device="cpu", backend="gloo",
                    timeout_s=TIMEOUT_S) == want
