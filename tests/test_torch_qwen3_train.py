"""One QAT step of the port's qwen3 slice against the JAX package: the
student's loss against the reference's teacher logits and every gradient
leaf, ``q_norm`` and ``k_norm`` included, at qwen3-14b's reduced config
and at ``"qwen3-32b-wide"`` (8 heads of 16: q_dim 128 > d 64; see
``test_torch_qwen3.py``), and the train CLI.

Same params (the reference's, bridged), same batches (the same numpy
generator); the JAX side runs op by op. Tolerances, the bounds of
``test_torch_mixtral_train.py`` with their reasons: the teacher's logits
(quantization off) within ``TEACHER_RTOL`` (a bf16 GEMM near a tie
rounds one ulp apart in XLA's dot and torch's GEMM); with the teacher's
logits shared, the loss within ``LOSS_RTOL`` and each gradient leaf
within ``GRAD_RTOL * |g_leaf| + GRAD_ATOL_GLOBAL * |g|`` (GEMMs and
reductions accumulate in another order).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.core import qat as jqat
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.launch.train import calibrate as jcalibrate
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import distill as tdistill
from repro_torch.core import qat as tqat
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import main as train_main
from repro_torch.models import forward
from repro_torch.tree import tree_map

POLICY = "A8d-C8-W4"
TEACHER_RTOL = 1e-2
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6
WIDE = dict(n_heads=8, head_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant):
    arch = variant.replace("-wide", "")
    kw = WIDE if variant.endswith("-wide") else {}
    return (get_reduced_config(arch).replace(**kw),
            t_reduced(arch).replace(**kw))


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _flat_ref(tree):
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in bridge.flatten(jax.tree.map(np.asarray, tree))}


def _flat_port(params):
    return {k: np.asarray(v, np.float32) for k, v in bridge.flatten(
        bridge.params_to_numpy(params))}


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-32b-wide"])
def test_qat_step_matches_op_by_op_reference(arch):
    """The student's loss against the reference's teacher logits and
    every gradient leaf, ``q_norm`` and ``k_norm`` included (non-zero),
    within the mixtral slice's bounds; the teacher's logits within
    TEACHER_RTOL."""
    cfg, tcfg = _cfgs(arch)
    B, S = 2, 24
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    jt = JTrainConfig(precision=POLICY, total_steps=3, ref_steps=3,
                      batch_size=B, seq_len=S)
    student = jcalibrate(cfg, teacher, jt, data)
    batch = next(JMixture(data, start_step=1))
    tstudent = _port(student)
    for _, p in bridge.flatten(tstudent):
        p.requires_grad_(True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jctx = jqat.make_ctx(POLICY)
    off = jqat.make_ctx("A16-C16-W16", mode="off")
    with jax.disable_jit():
        t_logits, _ = jforward(cfg, teacher, off, jb)

        def loss_fn(p):
            logits, _ = jforward(cfg, p, jctx, jb)
            return jdistill.silq_loss(logits, t_logits, jb["labels"],
                                      mask=jb["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
    with torch.no_grad():
        tt_logits, _ = forward(tcfg, _port(teacher),
                               tqat.make_ctx("A16-C16-W16", mode="off"), tb)
    tl = _f32(tt_logits)
    assert np.linalg.norm(tl - _f32(t_logits)) <= \
        TEACHER_RTOL * np.linalg.norm(_f32(t_logits))
    shared = torch.from_numpy(_f32(t_logits).copy()).to(torch.bfloat16)
    logits, _ = forward(tcfg, tstudent, tqat.make_ctx(POLICY), tb)
    loss = tdistill.silq_loss(logits, shared, tb["labels"],
                              mask=tb["loss_mask"])
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    tg = tsteps.grads_of(loss, tstudent)
    tg = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, tg,
                  tstudent)
    gw, gt = _flat_ref(jg), _flat_port(tg)
    assert gw.keys() == gt.keys()
    for k in ("attn/q_norm/w", "attn/k_norm/w"):
        key = f"segments/0/0/{k}"
        assert np.any(gw[key]) and np.all(np.isfinite(gt[key])), key
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err, np.linalg.norm(gw[k]))


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen3-32b"])
def test_train_cli_on_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--arch", arch, "--device", "cpu", "--steps", "2",
                    "--teacher-steps", "2", "--batch-size", "2",
                    "--seq-len", "24"])
    lines = [ln for ln in out.getvalue().splitlines() if "kd-loss" in ln]
    assert [ln.split(":")[0].strip() for ln in lines] == ["step 0", "step 1"]
