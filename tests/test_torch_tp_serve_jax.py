"""The port's tensor-parallel streams against the JAX package's engine.

The JAX package's tp=1 paged engine, run op by op (``jax.disable_jit``,
as ``test_torch_engine.py`` runs it: the compiled reference flips greedy
near-ties), on the reference's ``ENG_KW`` and a shorter ``_mixed_reqs``
workload (op by op, a reference decode step takes seconds), against the
port at tp=1 and at tp=2 (two gloo ranks, ``launch.mesh.spawn_tp``).
The rest of the tensor-parallel checks are in ``test_torch_tp_serve.py``.

Tolerance: none; greedy and sampled token streams are equal.
"""
import jax
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import bridge
from test_torch_tp_serve import (ENG_KW, _cfg, _jax_tree, _run,
                                 _small_reqs, _spawn)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_streams_equal_jax_engine():
    """The port's streams (greedy and sampled) at tp=1 and at tp=2 are
    the JAX package's tp=1 paged engine's."""
    jcfg, jparams, tree = _jax_tree(4)
    reqs = _small_reqs(jcfg, cls=JRequest)
    with jax.disable_jit():
        eng = JServeEngine(jcfg, jparams, w4a8_backend="ref", **ENG_KW)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    want = [tuple(r.generated) for r in reqs]
    assert len(set(want)) > 1
    base = _run(_cfg(4), bridge.params_from_numpy(tree, "cpu"), None,
                ENG_KW, _small_reqs(_cfg(4)))[0]
    assert base == want
    assert _spawn(tree, 4, 2, ("small",))["small"] == want
