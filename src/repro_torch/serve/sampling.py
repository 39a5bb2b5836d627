"""Token sampling for the serve engine: greedy, temperature and top-k.

Batched over slots and free of host syncs. Each slot carries a jax-style
PRNG key (two uint32 words) on the device, set at admission to
``fold_in(PRNGKey(seed), uid)``; every step folds in the slot's
generated-token count and draws ``categorical`` as the reference does
(``argmax(logits + gumbel)``). The bits are jax's own: ``threefry2x32``
in the partitionable counter layout that jax's default configuration
uses, written here as 32-bit add / rotate / xor on int64 tensors masked
to 32 bits (torch has no uint32 arithmetic worth trusting). The random
bits equal jax's bit for bit; the gumbel noise goes through ``log``
twice and may differ from XLA's by an ulp, so sampled streams equal the
reference's except at near-ties.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG = -1e30
TOP_K_CAP = 64      # static bound on per-request top_k

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = 1.1754943508222875e-38        # float32 finfo.tiny


# --------------------------------------------------------------------------
# threefry2x32 on tensors (int64 holding uint32 values) and on Python ints
# --------------------------------------------------------------------------

def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M32


def _threefry2x32(k1, k2, x1, x2):
    """jax's threefry2x32 hash (prng.py ``_threefry2x32_lowering``) of the
    count pair (x1, x2) under the key (k1, k2); works on Python ints and
    on int64 tensors alike (every value a uint32)."""
    ks = (k1, k2, (k1 ^ k2 ^ _KS_PARITY) & _M32)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a uint32 seed, as two ints."""
    seed &= _M32
    return 0, seed


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in`` on the host: hash (0, data) under ``key``."""
    return _threefry2x32(key[0], key[1], 0, data & _M32)


def slot_key(seed: int, uid: int) -> Tuple[int, int]:
    """A request's persistent key: ``fold_in(PRNGKey(seed), uid)``."""
    return fold_in(prng_key(seed), uid)


def split(key: Tuple[int, int]):
    """``jax.random.split(key)`` on the host: in the partitionable layout
    key i of the two is the hash of the count pair (0, i), the same as
    ``fold_in(key, i)``."""
    return [fold_in(key, 0), fold_in(key, 1)]


def key_uniform(key: Tuple[int, int], shape, dtype,
                device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval=tiny, maxval=1)``
    with one key for the whole array, float32 or bfloat16: counter i (the
    flat index) hashes to the xor of its two words, the dtype's top
    mantissa bits of it (bfloat16, with 7 mantissa bits, draws 8: the
    word's low byte) make a float in [1, 2), minus 1, scaled and floored
    at tiny, each step rounded in ``dtype``. Drawn on ``device``."""
    n = 1
    for d in shape:
        n *= d
    lo = torch.arange(n, dtype=torch.int64, device=device)
    a, b = _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    bits = a ^ b
    if dtype == torch.float32:
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.bfloat16:
        f = (((bits & 0xFF) >> 1) | 0x3F80).to(torch.int16).view(
            torch.bfloat16)
    else:
        raise ValueError(f"key_uniform draws float32 or bfloat16, not {dtype}")
    one = torch.tensor(1.0, dtype=dtype, device=device)
    lo_v = torch.tensor(_F32_TINY, dtype=dtype, device=device)
    u = torch.maximum(lo_v, (f - one) * (one - lo_v) + lo_v)
    return u.reshape(shape)


def key_categorical(key: Tuple[int, int],
                    logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis with one
    key for the whole (..., V) array: argmax(gumbel + logits), the gumbel
    noise drawn and added in the logits' dtype."""
    u = key_uniform(key, tuple(logits.shape), logits.dtype, logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=-1)


def fold_keys(keys: torch.Tensor, data) -> torch.Tensor:
    """Elementwise ``fold_in(keys[...], data[...])`` on the device.

    keys (..., 2) int64 holding uint32 words; data an int or an int
    tensor of shape ``keys.shape[:-1]``. Returns (..., 2) int64. This is
    ``jax.vmap(jax.random.fold_in)`` over any batch of keys, e.g. the
    (S, k) step keys that rejection sampling folds its tags into.
    """
    k = keys.long()
    if not isinstance(data, torch.Tensor):
        data = torch.full(k.shape[:-1], data, dtype=torch.int64,
                          device=k.device)
    c = data.long() & _M32
    a, b = _threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(c), c)
    return torch.stack([a, b], dim=-1)


def fold_step(keys: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Per-row ``fold_in(keys[i], counters[i])`` on the device.

    keys (B, 2) int64 holding uint32 words; counters (B,) int. Returns
    (B, 2) int64.
    """
    return fold_keys(keys, counters)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of shape (n,) for each row's key, in the
    partitionable layout: counter i is the 64-bit pair (0, i) and the
    word is the xor of the two hash outputs. keys (B, 2) -> (B, n) int64."""
    k = keys.long()
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    a, b = _threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(lo), lo)
    return a ^ b


def uniform(keys: torch.Tensor, n: int,
            minval: float = _F32_TINY) -> torch.Tensor:
    """f32 ``jax.random.uniform(key, (n,), minval=minval, maxval=1)`` per
    row: the top 23 bits as a mantissa in [1, 2), minus 1, scaled, and
    floored at ``minval``."""
    bits = random_bits(keys, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=keys.device) - lo
    return torch.maximum(lo, f * span + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """f32 gumbel noise as ``jax.random.gumbel`` draws it in its default
    ("low") mode: ``-log(-log(uniform(minval=tiny)))``."""
    return -torch.log(-torch.log(uniform(keys, n)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` per row: argmax(gumbel + logits)."""
    g = gumbel(keys, logits.shape[-1])
    return torch.argmax(g + logits.float(), dim=-1)


# --------------------------------------------------------------------------
# sampling
# --------------------------------------------------------------------------

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


def sample_tokens(logits: torch.Tensor, keys: Optional[torch.Tensor],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  greedy_only: bool = False) -> torch.Tensor:
    """Batched greedy / temperature / top-k sampling.

    logits (B, V); keys (B, 2) int64 uint32 words, this step's keys
    (unused, and may be None, under ``greedy_only``); temperature (B,)
    f32 (<= 0 means greedy); top_k (B,) int32 (0 disables). Returns (B,)
    int32 tokens. ``greedy_only`` skips the draw when no row samples.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy_only:
        return greedy
    masked = topk_masked(logits, top_k)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    drawn = categorical(keys, masked / temp).to(torch.int32)
    return torch.where(temperature > 0.0, drawn, greedy)


def token_probs(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor) -> torch.Tensor:
    """The categorical distribution :func:`sample_tokens` draws from.

    logits (B, V); temperature (B,); top_k (B,). Stochastic rows get the
    post-temperature, top-k-filtered softmax; greedy rows (temp <= 0) a
    one-hot at the argmax, so rejection sampling against these
    probabilities reduces to exact argmax matching for greedy requests.
    Returns (B, V) f32 rows summing to 1.
    """
    logits = logits.float()
    masked = topk_masked(logits, top_k)
    temp = torch.clamp_min(temperature, 1e-6)[:, None]
    p = torch.softmax(masked / temp, dim=-1)
    one_hot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    return torch.where(temperature[:, None] > 0.0, p, one_hot)
