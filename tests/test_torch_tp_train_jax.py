"""Tensor-parallel QAT against the JAX package, on the same bridged
parameters and global batches (reduced qwen2.5-3b, A8d-C8-W4, B 4 x S
16):

* op by op: the JAX one-device ``make_train_step`` under
  ``jax.disable_jit()`` against the port at model 4 in ``kv_rep`` (what
  ``attn_shard_mode_for`` picks) and a forced ``seq``: the first batch's
  loss and gradients, three steps' losses and the parameters after them;
* sharded: the JAX package's own sharded step, ``make_train_step(
  attn_shard_mode=...)`` jitted over a ``("data", "model")`` mesh of 1 x
  4 forced host devices with ``param_shardings`` / ``opt_shardings`` /
  ``batch_shardings`` (as ``tests/test_distributed.py::TestMiniDryRun``
  lowers it), in a subprocess: its loss for both modes against the
  port's at model 4.

Tolerances (measured beside each): against the op-by-op reference those
of ``tests/test_torch_dp_train.py``'s comparison with it, whose reasons
hold here (``LOSS_RTOL`` 1e-6 on the loss: measured 8.7e-8; gradients
within ``GRAD_RTOL`` 2e-2 of the leaf plus 1e-6 of the whole: measured
1.2e-2 on ``wk``'s and ``wq``'s scales; the key bias, whose true
gradient is zero, within ``TP_KEY_BIAS_RTOL`` 4e-2: measured 2.7e-2; the
movement bound ``UPD_RTOL``); against the compiled sharded step
``SHARDED_RTOL`` (1e-5; measured 0, bitwise): XLA may fuse the
compiled step's f32 reductions in its own order.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.launch import steps as jsteps
from repro.launch.train import calibrate as jcalibrate
from repro.models import init_params as jinit
from repro.optim import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch.launch.mesh import spawn
from test_torch_tp_train import (B, POLICIES, S, STEPS, TIMEOUT_S,
                                 TP_KEY_BIAS_RTOL, _assert_moved_alike,
                                 rank_bridged)

LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6       # tests/test_torch_train.py
SHARDED_RTOL = 1e-5
MODES = ("kv_rep", "seq")
SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_ref(tree):
    """{path: f32 numpy} of a JAX tree, in the port's per-layer layout."""
    t = bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    return {k: v.float().numpy() for k, v in bridge.flatten(t)}


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced_config("qwen2.5-3b")
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    jt = JTrainConfig(precision=POLICIES[0], total_steps=STEPS,
                      ref_steps=STEPS, batch_size=B, seq_len=S)
    student = jcalibrate(cfg, teacher, jt, data)
    it = JMixture(data, start_step=0)
    batches = [next(it) for _ in range(STEPS)]
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"cfg": cfg, "jt": jt, "teacher": teacher, "student": student,
            "batches": batches,
            "inp": {"teacher": np_tree(teacher),
                    "students": {POLICIES[0]: np_tree(student)},
                    "batches": batches}}


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX package's one-device step on the global batches, op by
    op: the first batch's loss and gradients, then three steps."""
    cfg, teacher, student = setup["cfg"], setup["teacher"], setup["student"]
    jstep = jsteps.make_train_step(cfg, setup["jt"])
    jb = [{k: jnp.asarray(v) for k, v in b.items()}
          for b in setup["batches"]]
    from repro.core import distill as jdistill
    from repro.core import qat as jqat
    from repro.models import forward as jforward
    with jax.disable_jit():
        t_logits, _ = jforward(cfg, teacher, jqat.make_ctx(
            "A16-C16-W16", mode="off"), jb[0])

        def loss_fn(p):
            logits, _ = jforward(cfg, p, jqat.make_ctx(POLICIES[0]), jb[0])
            return jdistill.silq_loss(logits, t_logits, jb[0]["labels"],
                                      mask=jb[0]["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
        p, opt, losses, lrs = student, jadamw_init(student), [], []
        for i, b in enumerate(jb):
            p, opt, m = jstep(p, teacher, opt, b, jnp.int32(i))
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
    return {"loss": float(jl), "grads": _flat_ref(jg), "losses": losses,
            "lrs": lrs, "params": _flat_ref(p),
            "before": _flat_ref(student)}


@pytest.fixture(scope="module")
def model4(setup):
    cases = {mode: dict(policy=POLICIES[0], mode=mode) for mode in MODES}
    return spawn(rank_bridged, 4, dict(setup["inp"], cases=cases),
                 model_parallel=4, device="cpu", backend="gloo",
                 timeout_s=TIMEOUT_S)


SHARDED = """
import json, pickle, sys
import jax, jax.numpy as jnp
from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig
from repro.launch.steps import make_train_step
from repro.optim import adamw_init
from repro.runtime.sharding import (batch_shardings, opt_shardings,
                                    param_shardings)
with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
cfg = get_reduced_config("qwen2.5-3b")
mesh = jax.make_mesh((1, 4), ("data", "model"))
teacher = jax.tree.map(jnp.asarray, inp["teacher"])
student = jax.tree.map(jnp.asarray, inp["student"])
batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
psh = param_shardings(cfg, mesh, student)
opt = adamw_init(student)
out = {}
for mode in inp["modes"]:
    tc = TrainConfig(precision=inp["policy"], total_steps=inp["steps"],
                     ref_steps=inp["steps"], batch_size=inp["B"],
                     seq_len=inp["S"])
    with mesh:
        fn = make_train_step(cfg, tc, attn_shard_mode=mode,
                             batch_axes=("data",))
        step = jax.jit(fn, in_shardings=(
            psh, psh, opt_shardings(psh, opt), batch_shardings(mesh, batch),
            None))
        _, _, m = step(student, teacher, opt, batch, jnp.int32(0))
    out[mode] = float(m["loss"])
print("LOSSES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def sharded_losses(setup, tmp_path_factory):
    """The JAX package's step jitted over 4 host devices, each mode."""
    path = str(tmp_path_factory.mktemp("tp_jax") / "inp.pkl")
    with open(path, "wb") as f:
        pickle.dump({"teacher": setup["inp"]["teacher"],
                     "student": setup["inp"]["students"][POLICIES[0]],
                     "batch": setup["batches"][0], "modes": MODES,
                     "policy": POLICIES[0], "steps": STEPS, "B": B,
                     "S": S}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(SHARDED),
                        path], env=env, capture_output=True, text=True,
                       timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("LOSSES ")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][len("LOSSES "):])


@pytest.mark.parametrize("mode", MODES)
def test_model_4_matches_op_by_op_reference(jax_steps, model4, mode):
    got = model4[mode]
    assert got["mode"] == mode
    np.testing.assert_allclose(got["loss"], jax_steps["loss"],
                               rtol=LOSS_RTOL)
    gw, gt = jax_steps["grads"], got["grads"]
    assert gw.keys() == gt.keys()
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        rtol = TP_KEY_BIAS_RTOL if k.endswith("attn/wk/b") else GRAD_RTOL
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= rtol * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err)
    np.testing.assert_allclose(got["losses"][0], jax_steps["losses"][0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], jax_steps["losses"],
                               rtol=1e-5)
    assert got["lrs"] == jax_steps["lrs"]
    _assert_moved_alike(got["params"], jax_steps["params"],
                        jax_steps["before"], jax_steps["lrs"], got["bf16"])


@pytest.mark.parametrize("mode", MODES)
def test_model_4_matches_sharded_reference(sharded_losses, model4, mode):
    """The JAX package's own sharded step in ``mode`` (its GSPMD
    inserting the collectives from the hints) and the port's model-4
    step give the same global loss."""
    np.testing.assert_allclose(model4[mode]["loss"], sharded_losses[mode],
                               rtol=SHARDED_RTOL)
