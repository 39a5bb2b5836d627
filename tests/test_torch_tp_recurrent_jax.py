"""The port's tensor-parallel recurrent streams against the JAX
package's engine.

The JAX package's tp=1 dense engine on reduced recurrentgemma-2b (run op
by op, ``jax.disable_jit``, as ``test_torch_recurrentgemma.py`` runs it:
the compiled reference's fused gates give other streams) and on reduced
xlstm-125m at ``slstm_proj_factor=1.5`` (compiled, as
``test_torch_xlstm.py`` runs it), ``w4a8_backend="ref"``, on the
recurrent tests' workloads (exact-length waves, greedy), against the
port at tp=2 (two gloo ranks, ``launch.mesh.spawn_tp``; the params are
the reference's, bridged). The rest of the recurrent tensor-parallel
checks are in ``test_torch_tp_recurrent.py``.

Tolerance: none; the streams are equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.core import qat as jqat
from repro.core.precision import parse_policy
from repro.models import init_params as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.launch.mesh import spawn_tp
from test_torch_tp_recurrent import (JAX_ENGINE, JAX_PROMPTS, POLICY, RG,
                                     TIMEOUT_S, XL, jax_prompts,
                                     rank_jax_trees, serve_prompts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(name):
    cfg = get_reduced_config(name)
    return cfg.replace(slstm_proj_factor=1.5) if name == XL else cfg


def test_tp2_streams_equal_jax_engine():
    """At tp=2 (the RG-LRU's width and the mLSTM's heads cut over the
    ranks, the sLSTM's recurrence whole), both archs' greedy streams are
    the JAX package's tp=1 engine's, recurrentgemma's from a 20-token
    prompt whose ring wrapped."""
    jparams, want = {}, {}
    kw = {k: v for k, v in JAX_ENGINE.items() if k != "policy"}
    for name in (RG, XL):
        cfg = _jcfg(name)
        jparams[name] = jqat.calibrate_weight_scales(
            jinit(cfg, jax.random.PRNGKey(0)), parse_policy(POLICY))
        eng = JServeEngine(cfg, jparams[name], w4a8_backend="ref", **kw)
        prompts = jax_prompts(cfg, name)
        if name == RG:
            with jax.disable_jit():
                want[name] = serve_prompts(eng, JRequest, prompts,
                                           JAX_PROMPTS[name][1])
        else:
            want[name] = serve_prompts(eng, JRequest, prompts,
                                       JAX_PROMPTS[name][1])
        assert len({t for s in want[name] for t in s}) > 1
    trees = {n: jax.tree.map(np.asarray, p) for n, p in jparams.items()}
    got = spawn_tp(rank_jax_trees, 2, trees, device="cpu",
                   backend="gloo", timeout_s=TIMEOUT_S)
    assert got == want
