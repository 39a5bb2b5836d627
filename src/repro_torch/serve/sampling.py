"""Token sampling for the serve engine: greedy, temperature and top-k.

Batched over slots and free of host syncs: greedy rows are an argmax, and
a sampled row draws from its own ``torch.Generator`` on the logits'
device, seeded from the request's (seed, uid) and the slot's
generated-token count. The draw is the exponential race
``argmax(p / E)``, ``E ~ Exp(1)``, which samples the categorical ``p``.

The reference derives its per-step keys with jax's threefry
(``fold_in``); a torch generator cannot reproduce those bits, so sampled
streams are deterministic per seed but not equal to the reference's.
Greedy streams are equal.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG = -1e30
TOP_K_CAP = 64      # static bound on per-request top_k

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64 finalizer: a well-spread 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, uid: int, n_gen: int) -> int:
    """Generator seed of one request's ``n_gen``-th sampled token."""
    h = _mix(_mix(_mix(seed & _MASK64) ^ (uid & _MASK64)) ^ (n_gen & _MASK64))
    return h & ((1 << 63) - 1)


def topk_masked(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Logits with everything below each row's k-th largest pushed to
    -1e30 (top_k == 0 disables)."""
    V = logits.shape[-1]
    kc = min(TOP_K_CAP, V)
    desc = torch.topk(logits, kc, dim=-1).values                  # (B, kc)
    kth = torch.gather(desc, 1,
                       torch.clamp(top_k.long() - 1, 0, kc - 1)[:, None])
    drop = (top_k[:, None] > 0) & (logits < kth)
    return torch.where(drop, torch.full_like(logits, _NEG), logits)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor,
                  seeds: Optional[Sequence[Optional[int]]] = None,
                  greedy_only: bool = False) -> torch.Tensor:
    """Batched greedy / temperature / top-k sampling.

    logits (B, V); temperature (B,) f32 (<= 0 means greedy); top_k (B,)
    int32 (0 disables); ``seeds`` one generator seed per row, None for
    rows the host knows are greedy. Returns (B,) int32 tokens.
    ``greedy_only`` skips the draw when no row samples.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy_only or seeds is None:
        return greedy
    masked = topk_masked(logits, top_k)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    probs = torch.softmax(masked / temp, dim=-1)
    noise = torch.ones_like(probs)
    for row, seed in enumerate(seeds):
        if seed is not None:
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(seed)
            noise[row].exponential_(generator=gen)
    drawn = torch.argmax(probs / noise, dim=-1).to(torch.int32)
    return torch.where(temperature > 0.0, drawn, greedy)
