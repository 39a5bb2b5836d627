"""One QAT step of the port's qwen2-vl-2b slice against the JAX package,
at the reduced config (2 layers, d 64, 8 patch positions): the student's
loss against the reference's teacher logits, both through
``_text_logits`` (the patch positions dropped), and every gradient leaf;
and one ``make_train_step`` step: its loss the reference's and every
``s_w`` moved.

Same params (the reference's, MSE-calibrated, bridged), same batch (the
reference's synthetic mixture, bf16 patches from a seeded numpy
generator and Qwen2-VL's position streams); the JAX side runs op by op. Tolerances, the bounds of
``test_torch_qwen3_train.py`` with their reasons: the teacher's logits
(quantization off) within ``TEACHER_RTOL``; with the teacher's logits
shared, the loss within ``LOSS_RTOL`` and each gradient leaf within
``GRAD_RTOL * |g_leaf| + GRAD_ATOL_GLOBAL * |g|``; the step's loss (its
own teacher) within ``STEP_RTOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import distill as jdistill
from repro.core import qat as jqat
from repro.data import MixtureIterator as JMixture
from repro.data import SyntheticConfig as JSynth
from repro.launch.steps import _text_logits as j_text_logits
from repro.launch.train import calibrate as jcalibrate
from repro.models import forward as jforward
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs import get_reduced_config as t_reduced
from repro_torch.core import distill as tdistill
from repro_torch.core import qat as tqat
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import _trainable
from repro_torch.models import forward
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_map

ARCH = "qwen2-vl-2b"
POLICY = "A8d-C8-W4"
TEACHER_RTOL = 1e-2
LOSS_RTOL = 1e-6
STEP_RTOL = 1e-3
GRAD_RTOL, GRAD_ATOL_GLOBAL = 2e-2, 1e-6


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


def test_qat_step_matches_op_by_op_reference():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_step()
    finally:
        torch.set_num_threads(n_threads)


def _check_step():
    cfg, tcfg = get_reduced_config(ARCH), t_reduced(ARCH)
    B, S = 2, 16
    teacher = jinit(cfg, jax.random.PRNGKey(0))
    data = JSynth(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                  seed=0)
    jt = JTrainConfig(precision=POLICY, total_steps=3, ref_steps=3,
                      batch_size=B, seq_len=S)
    student = jcalibrate(cfg, teacher, jt, data)
    batch = dict(next(JMixture(data, start_step=1)))
    V = cfg.vision_tokens
    patches = np.random.default_rng(5).standard_normal(
        (B, V, cfg.d_model)).astype(np.float32)
    # patches at t 0 on a 2 x 4 raster, the text from max + 1
    text = 4 + np.arange(S)
    pos = np.stack([np.concatenate([np.zeros(V, np.int64), text]),
                    np.concatenate([np.arange(V) // 4, text]),
                    np.concatenate([np.arange(V) % 4, text])])
    batch["positions"] = np.broadcast_to(pos[:, None], (3, B, V + S)).astype(
        np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["patches"] = jnp.asarray(patches).astype(jnp.bfloat16)
    tb = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}
    tb["patches"] = torch.from_numpy(patches).to(torch.bfloat16)
    jctx = jqat.make_ctx(POLICY)
    off = jqat.make_ctx("A16-C16-W16", mode="off")
    with jax.disable_jit():
        t_logits = j_text_logits(cfg, jforward(cfg, teacher, off, jb)[0])

        def loss_fn(p):
            logits = j_text_logits(cfg, jforward(cfg, p, jctx, jb)[0])
            return jdistill.silq_loss(logits, t_logits, jb["labels"],
                                      mask=jb["loss_mask"])

        jl, jg = jax.value_and_grad(loss_fn)(student)
    tteacher, tstudent = _port(teacher), _port(student)
    with torch.no_grad():
        tt_all, _ = forward(tcfg, tteacher,
                            tqat.make_ctx("A16-C16-W16", mode="off"), tb)
    assert tt_all.shape == (B, V + S, cfg.vocab_size)
    tt_logits = tsteps._text_logits(tcfg, tt_all)
    assert tt_logits.shape == (B, S, cfg.vocab_size)
    assert np.linalg.norm(_f32(tt_logits) - _f32(t_logits)) <= \
        TEACHER_RTOL * np.linalg.norm(_f32(t_logits))
    for _, p in bridge.flatten(tstudent):
        p.requires_grad_(True)
    shared = torch.from_numpy(_f32(t_logits).copy()).to(torch.bfloat16)
    logits = tsteps._text_logits(
        tcfg, forward(tcfg, tstudent, tqat.make_ctx(POLICY), tb)[0])
    loss = tdistill.silq_loss(logits, shared, tb["labels"],
                              mask=tb["loss_mask"])
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    tg = tsteps.grads_of(loss, tstudent)
    tg = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g, tg,
                  tstudent)
    gw, gt = _flat_ref(jg), _flat_port(tg)
    assert gw.keys() == gt.keys()
    for k in ("segments/0/0/attn/wq/b", "segments/0/0/attn/wk/w",
              "embed/w"):
        assert np.any(gw[k]) and np.any(gt[k]), k
    total = np.sqrt(sum(np.sum(v ** 2) for v in gw.values()))
    for k in gw:
        err = np.linalg.norm(gt[k] - gw[k])
        assert err <= GRAD_RTOL * np.linalg.norm(gw[k]) + \
            GRAD_ATOL_GLOBAL * total, (k, err, np.linalg.norm(gw[k]))

    # the whole step: its own teacher, AdamW
    step = tsteps.make_train_step(tcfg, TrainConfig(
        precision=POLICY, total_steps=3, ref_steps=3, batch_size=B,
        seq_len=S))
    params = _trainable(_port(student))
    before = {k: v.detach().clone() for k, v in bridge.flatten(params)
              if k.endswith("s_w")}
    params, _, metrics = step(params, tteacher, adamw_init(params), tb, 0)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=STEP_RTOL)
    after = dict(bridge.flatten(params))
    assert len(before) == 7 * cfg.n_layers + 1
    unmoved = [k for k, v in before.items() if torch.equal(after[k], v)]
    assert not unmoved, unmoved
