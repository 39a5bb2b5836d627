"""Weight-rotation analysis (paper §3.4 / Fig. 3) and a QuaRot/SpinQuant-
style rotation PTQ transform to compare against.

Procrustes factorization of a weight change A -> B::

    d_p(A,B)   = min_R ||RA - B||_F  (left)  or  min_R ||AR - B||_F (right)
               = sqrt(||A||^2 + ||B||^2 - 2 * sum(svdvals(B A^T)))
    non-rotational distance = min(d_p_left, d_p_right)
    rotational distance     = d_F(A,B) - non-rotational

both normalized by ||A||_F. SiLQ's claim: its weight changes are ~43%
rotational vs ~90% for SpinQuant, i.e. QAT finds solutions rotation-based
PTQ cannot.

The distances run in float64 on the device of their inputs. Of the two
products ``B A^T`` (m x m) and ``A^T B`` (n x n) of an (m, n) weight, the
larger square is never formed: its singular values are those of the
min(m, n)-square ``R_x R_y^T`` from reduced QR factorizations of the two
tall factors (for ``A^T B`` with n > m: ``A^T = Q_a R_a``,
``B^T = Q_b R_b``). The singular values come from an SVD, never from the
eigenvalues of a Gram matrix, whose square roots lose the digits a pure
rotation's near-zero distance needs.

The rotation transform is the exactly function-preserving residual
rotation (R1 of SpinQuant) for RMSNorm transformers: fold norm scales
into the adjacent linears (RMSNorm is then rotation-equivariant), then
rotate the residual stream basis with a random orthogonal R. Under a
tied head the final norm stays unfolded (folding it would break the
tie), as in the reference: the rotation then preserves the function
only while the final norm's weight is uniform. In an MoE layer ln2 is
folded into the router alone, as in the reference, and the expert banks
(``(e, d_in, d_out)``) are rotated only: their normed input is then
unscaled once ln2's weight is not uniform.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ATTENTION_BLOCKS, ModelConfig
from repro_torch.tree import tree_map

# elements of one float64 operand stack in rotation_report (2 GB)
_REPORT_CHUNK = 1 << 28


# --------------------------------------------------------------------------
# Procrustes distances
# --------------------------------------------------------------------------

def _nuclear_of_product(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """sum(svdvals(X @ Y^T)) for (..., p, q) stacks X, Y, through a q x q
    matrix where p > q."""
    if X.shape[-2] > X.shape[-1]:
        X = torch.linalg.qr(X, mode="r").R
        Y = torch.linalg.qr(Y, mode="r").R
    # cuSOLVER's QR-iteration SVD (torch's default on CUDA is Jacobi)
    routine = "gesvd" if X.is_cuda else None
    return torch.linalg.svdvals(X @ Y.transpose(-1, -2),
                                driver=routine).sum(-1)


def _procrustes(A: torch.Tensor, B: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Normalized distances of (..., m, n) stacks, float64, per matrix."""
    A, B = A.to(torch.float64), B.to(torch.float64)
    nA = torch.linalg.matrix_norm(A)
    total = torch.linalg.matrix_norm(B - A)
    sq = nA ** 2 + torch.linalg.matrix_norm(B) ** 2

    def d_p(nuc):
        return torch.sqrt(torch.clamp_min(sq - 2.0 * nuc, 0.0))

    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
    non_rot = torch.minimum(d_p(_nuclear_of_product(B, A)),    # B A^T
                            d_p(_nuclear_of_product(At, Bt)))  # A^T B
    return {"total": total / nA,
            "non_rotational": non_rot / nA,
            "rotational": torch.clamp_min(total - non_rot, 0.0) / nA}


def procrustes_distances(A, B) -> Dict[str, float]:
    """Rotational / non-rotational / total distance, normalized by ||A||.

    ``A``, ``B``: (m, n) tensors (or arrays) on one device."""
    d = _procrustes(torch.as_tensor(A), torch.as_tensor(B))
    return {k: float(v) for k, v in d.items()}


# --------------------------------------------------------------------------
# Function-preserving residual rotation (R1)
# --------------------------------------------------------------------------

def random_rotation(d: int, gen: torch.Generator) -> torch.Tensor:
    """A random (d, d) orthonormal f32 matrix on ``gen``'s device."""
    x = torch.randn((d, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    q, r = torch.linalg.qr(x)
    return q * torch.sign(torch.diagonal(r))[None, :]


def _fold_norm_into(norm_p: Dict, linears) -> None:
    """W' = diag(norm_w) @ W; norm_w := 1 (RMSNorm becomes rotation-equiv)."""
    nw = norm_p["w"].float()                          # (d,)
    for lin in linears:
        lin["w"] = (lin["w"].float() * nw[:, None]).to(lin["w"].dtype)
    norm_p["w"] = torch.ones_like(norm_p["w"])


def _rot_in(lin: Dict, R: torch.Tensor) -> None:
    """Reading the rotated residual: W' = R^T W (input side; a bank
    (e, d, o) expert by expert)."""
    lin["w"] = (R.T @ lin["w"].float()).to(lin["w"].dtype)


def _rot_out(lin: Dict, R: torch.Tensor) -> None:
    """Writing to the rotated residual: W' = W R (output side; a bank
    (e, o, d) expert by expert)."""
    lin["w"] = (lin["w"].float() @ R).to(lin["w"].dtype)


def _rotate_with(cfg: ModelConfig, params: Dict, R: torch.Tensor) -> Dict:
    """Fold norms, then rotate the residual-stream basis by ``R`` (d, d).
    Returns a new tree; tensors not rotated are shared."""
    if cfg.norm_type != "rms" or cfg.is_encdec or any(
            k not in ATTENTION_BLOCKS for k in cfg.layer_kinds()):
        raise NotImplementedError(
            "residual rotation targets rms-norm attention decoders without "
            "an encoder")
    params = tree_map(lambda x: x, params)            # fresh containers
    emb = params["embed"]
    R = R.to(emb["w"].device, torch.float32)
    with torch.no_grad():
        emb["w"] = (emb["w"].float() @ R).to(emb["w"].dtype)
        if not cfg.tie_embeddings:
            _fold_norm_into(params["final_norm"], [params["head"]])
            _rot_in(params["head"], R)
        # a tied head reads embed^T: folding the final norm would break the
        # tie, so it stays (exact only while its weight is uniform)
        for blk in params["layers"]:
            attn = blk["attn"]
            _fold_norm_into(blk["ln1"], [attn["wq"], attn["wk"], attn["wv"]])
            for k in ("wq", "wk", "wv"):
                _rot_in(attn[k], R)
            _rot_out(attn["wo"], R)
            if "moe" in blk:
                mlp = blk["moe"]
                # ln2 folds into the router only; the experts share the
                # normed input and get the rotation alone (the reference)
                _fold_norm_into(blk["ln2"], [mlp["router"]])
                _rot_in(mlp["router"], R)
            else:
                mlp = blk["mlp"]
                _fold_norm_into(blk["ln2"], [mlp["wg"], mlp["wu"]])
            _rot_in(mlp["wg"], R)
            _rot_in(mlp["wu"], R)
            _rot_out(mlp["wd"], R)
    return params


def rotate_residual(cfg: ModelConfig, params: Dict,
                    gen: torch.Generator) -> Dict:
    """Fold norms, then rotate the residual-stream basis with a random
    orthonormal R drawn from ``gen``. Only for rms-norm attention decoder
    families (the paper's setting); raises NotImplementedError otherwise."""
    return _rotate_with(cfg, params, random_rotation(cfg.d_model, gen))


# --------------------------------------------------------------------------
# Per-layer-type rotation report (Fig. 3)
# --------------------------------------------------------------------------

_LAYER_TYPES = ("wq", "wk", "wg", "wu", "wd")   # v/o omitted (paper §3.4)


def rotation_report(cfg: ModelConfig, params_before: Dict,
                    params_after: Dict) -> Dict[str, Dict[str, float]]:
    """Average rotational / non-rotational distance by layer type, over
    the attention layers and, for an MoE's banks, over their experts (the
    Procrustes SVDs batched over layers and experts)."""
    layers = [i for i, k in enumerate(cfg.layer_kinds())
              if k in ATTENTION_BLOCKS]
    report = {}
    for name in _LAYER_TYPES:
        group = ("attn" if name in ("wq", "wk")
                 else "moe" if cfg.is_moe else "mlp")
        w0 = [params_before["layers"][i][group][name]["w"] for i in layers]
        w1 = [params_after["layers"][i][group][name]["w"] for i in layers]
        if not w0:
            continue
        chunk = max(1, _REPORT_CHUNK // w0[0].numel())
        parts = []
        with torch.no_grad():
            for s in range(0, len(w0), chunk):
                parts.append(_procrustes(torch.stack(w0[s:s + chunk]),
                                         torch.stack(w1[s:s + chunk])))
        report[name] = {k: float(torch.cat([p[k] for p in parts]).mean())
                        for k in ("total", "rotational", "non_rotational")}
    return report


def rotational_share(report: Dict[str, Dict[str, float]]) -> float:
    """Fig. 3's share: rotational over total distance, summed over a
    :func:`rotation_report`'s layer types."""
    tot = sum(v["rotational"] + v["non_rotational"] for v in report.values())
    return sum(v["rotational"] for v in report.values()) / max(tot, 1e-12)
