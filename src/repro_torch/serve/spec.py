"""Speculative decoding: a truncated-layer draft proposes, the target
verifies every resident's window in one verify-wave, rejected suffixes
roll back.

* **Draft construction** (:func:`make_draft`): the draft is the target's
  first ``draft_layers`` layers. Embedding, final norm and head are the
  target's own tensors, shared by reference (no second copy on the
  card); ``draft_layers == n_layers`` with the target's policy is the
  self-draft, the target itself.
* **Acceptance** (:func:`accept_exact`, :func:`accept_rejection`):

  - ``exact``: position ``j`` is accepted iff the draft token equals the
    token the target samples there with the plain-decode key stream
    (``fold_in(slot_key, n_gen + j)``). The committed stream is plain
    decode's by construction, greedy and sampled, for any draft, across
    preemption, swap and rollback.
  - ``rejection``: speculative rejection sampling: accept draft token
    ``d`` with probability ``min(1, p(d) / q(d))`` and sample the first
    rejection from the normalized residual ``max(p - q, 0)``. The
    committed-token distribution equals the target's; a self-draft with
    the coupled keys accepts everything and reproduces plain decode.

* **Rollback** is the allocator's ``BlockAllocator.trim``: the
  verify-wave writes all ``k + 1`` candidate KVs through the block table
  first, and the rejected suffix is undone by re-clamping the device
  ``length``/``position`` counters and releasing the whole blocks past
  the accepted extent.

All randomness derives from the slot key and the generated-token counter
only (never from wave packing), so a preempted and resumed slot replays
the same stream.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serve.sampling import categorical, fold_keys, uniform

# fold_in tags deriving the rejection-sampling streams from the plain-
# decode step key (the step key itself draws the target, bonus and
# residual tokens, so the exact and full-acceptance paths reuse it)
_COIN_TAG = 0x5BEC
_RESID_TAG = 0x5BED


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (the engine's ``spec=`` argument).

    ``k``: draft tokens proposed per slot per wave (the wave verifies
    ``k + 1`` positions and commits 1..k+1 tokens).
    ``draft_layers``: draft depth; None = half the target's layers (at
    least 1); equal to ``n_layers`` = self-draft.
    ``draft_policy``: the draft's deployment policy (None = the
    target's).
    ``accept_mode``: ``"exact"`` (plain-decode streams, the default) or
    ``"rejection"`` (rejection sampling for temperature / top-k rows;
    greedy rows always match exactly).
    """
    k: int = 4
    draft_layers: Optional[int] = None
    draft_policy: Optional[str] = None
    accept_mode: str = "exact"

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.accept_mode not in ("exact", "rejection"):
            raise ValueError(f"accept_mode must be 'exact' or 'rejection', "
                             f"got {self.accept_mode!r}")

    def resolved_layers(self, cfg: ModelConfig) -> int:
        d = self.draft_layers
        if d is None:
            d = max(1, cfg.n_layers // 2)
        if not 1 <= d <= cfg.n_layers:
            raise ValueError(f"draft_layers={d} outside [1, {cfg.n_layers}]")
        return d


def make_draft(cfg: ModelConfig, params: Dict,
               spec: SpecConfig) -> Tuple[ModelConfig, Dict]:
    """The draft's (config, params): the target's first ``draft_layers``
    entries of ``params["layers"]``, with every other entry (embedding,
    final norm, head) the target's own object. On a tensor-parallel mesh
    the engine passes its rank's config and sharded tree, so the draft
    is the rank's slice of the draft's layers."""
    L = spec.resolved_layers(cfg)
    if L == cfg.n_layers and spec.draft_policy is None:
        return cfg, params          # self-draft: the target itself
    dcfg = replace(cfg, name=f"{cfg.name}-draft{L}", n_layers=L)
    if L == cfg.n_layers:
        return dcfg, params         # the same trunk at another policy
    dparams = dict(params)
    dparams["layers"] = params["layers"][:L]
    return dcfg, dparams


# --------------------------------------------------------------------------
# Acceptance
# --------------------------------------------------------------------------

def accept_exact(draft: torch.Tensor, target: torch.Tensor,
                 n_draft: torch.Tensor) -> torch.Tensor:
    """Leading-match acceptance count.

    draft (S, k) proposals; target (S, k+1) the token the target samples
    at each window position with the plain-decode key stream; n_draft
    (S,) proposals in play this wave. Returns n_acc (S,) int32 in
    [0, n_draft]: the length of the leading run of matches.
    """
    k = draft.shape[1]
    live = torch.arange(k, device=draft.device)[None] < n_draft[:, None]
    match = (draft == target[:, :-1]) & live
    return torch.cumprod(match.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)


def accept_rejection(draft: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
                     target: torch.Tensor, keys: torch.Tensor,
                     n_gen: torch.Tensor, n_draft: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling over a wave of drafts.

    draft (S, k) proposals; q (S, k, V) the draft's sampling distribution
    at each proposal; p (S, k+1, V) the target's; target (S, k+1) the
    target's own samples under the plain-decode key stream (the bonus
    token, so full acceptance reproduces plain decode when q == p); keys
    (S, 2) slot keys; n_gen (S,) generated-token counters; n_draft (S,)
    live proposals.

    Returns (n_acc (S,), committed (S, k+1)): committed[:, j] is the
    draft token below ``n_acc``, the residual sample at the first
    rejection, and the target's sample beyond it.
    """
    S, k = draft.shape
    dev = draft.device
    jk = torch.arange(k, device=dev)[None]
    step_keys = fold_keys(keys[:, None, :].expand(S, k, 2),
                          n_gen.long()[:, None] + jk)          # (S, k, 2)
    coin_keys = fold_keys(step_keys, _COIN_TAG)
    resid_keys = fold_keys(step_keys, _RESID_TAG)
    dl = draft.long()[..., None]
    p_d = torch.gather(p[:, :k], 2, dl)[..., 0]
    q_d = torch.gather(q, 2, dl)[..., 0]
    u = uniform(coin_keys.reshape(S * k, 2), 1, minval=0.0).reshape(S, k)
    live = jk < n_draft[:, None]
    # strict <: uniforms live in [0, 1), so u == 0 must not accept a token
    # the target gives zero probability; u < 1 keeps the self-draft
    # (p == q) accepting everything
    ok = (u * q_d < p_d) & live
    n_acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1,
                                                         dtype=torch.int32)
    # the residual at every draft position; only the first rejection's is
    # used. A numerically empty residual falls back to the target's p.
    resid = torch.clamp_min(p[:, :k] - q, 0.0)
    rsum = torch.sum(resid, dim=-1, keepdim=True)
    resid = torch.where(rsum > 1e-9, resid / torch.clamp_min(rsum, 1e-20),
                        p[:, :k])
    V = p.shape[-1]
    rtok = categorical(resid_keys.reshape(S * k, 2),
                       torch.log(resid + 1e-20).reshape(S * k, V)
                       ).to(torch.int32).reshape(S, k)
    # committed: drafts below n_acc; at n_acc the residual sample, but only
    # where a draft was rejected there (n_acc < n_draft); where every live
    # draft survived, the bonus: the target's own plain-decode sample
    jj = torch.arange(k + 1, device=dev)[None]
    dpad = torch.cat([draft.to(torch.int32), target[:, -1:]], dim=1)
    rpad = torch.cat([rtok, target[:, -1:]], dim=1)
    rejected = (jj == n_acc[:, None]) & (n_acc < n_draft)[:, None]
    committed = torch.where(jj < n_acc[:, None], dpad,
                            torch.where(rejected, rpad, target))
    return n_acc, committed
