"""Synthetic token pipeline standing in for DCLM / SFT mixtures (a copy of
the reference's ``data/synthetic.py``: numpy only, and bitwise the same
batches from the same seed).

The container is offline, so the data substrate generates structured
synthetic language: a seeded first-order Markov chain over the vocabulary
(Zipf-distributed unigrams, low-entropy bigram structure) — enough signal
that (a) a small model trained on it learns something distillable, and
(b) activation statistics exercise realistic dynamic ranges for percentile
calibration.

Two "sources" emulate the paper's mixture: ``dclm`` (long-range, uniform
documents) and ``sft`` (prompt/response with a loss mask on the response
only). ``MixtureIterator`` samples sources per example (paper: 25% DCLM /
75% SFT for instruct models) and is checkpointable (state = step counter;
regeneration is deterministic).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    dclm_ratio: float = 0.25
    seed: int = 0
    zipf_a: float = 1.2
    n_states: int = 64      # Markov states (coarse "topics")


class MixtureIterator:
    """Deterministic, checkpointable mixture of synthetic sources."""

    def __init__(self, cfg: SyntheticConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian unigram over vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = ranks ** -cfg.zipf_a
        self._unigram /= self._unigram.sum()
        # per-state token-bias: each state prefers a band of the vocab
        self._state_shift = rng.integers(0, v, size=cfg.n_states)
        self._trans = rng.dirichlet(np.ones(cfg.n_states) * 0.2,
                                    size=cfg.n_states)

    # ---- checkpointing ----
    def state_dict(self) -> Dict:
        return {"step": self.step}

    def load_state_dict(self, d: Dict) -> None:
        self.step = int(d["step"])

    # ---- generation ----
    def _sample_doc(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cfg = self.cfg
        states = np.zeros(n, np.int64)
        s = rng.integers(0, cfg.n_states)
        for i in range(0, n, 16):          # state persists ~16 tokens
            s = rng.choice(cfg.n_states, p=self._trans[s])
            states[i:i + 16] = s
        toks = rng.choice(cfg.vocab_size, size=n, p=self._unigram)
        return (toks + self._state_shift[states]) % cfg.vocab_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.step))
        B, S = cfg.batch_size, cfg.seq_len
        tokens = np.zeros((B, S + 1), np.int32)
        mask = np.ones((B, S), np.float32)
        is_dclm = rng.random(B) < cfg.dclm_ratio
        for b in range(B):
            doc = self._sample_doc(rng, S + 1)
            tokens[b] = doc
            if not is_dclm[b]:
                # SFT-style: mask the "prompt" third from the loss
                cut = S // 3 + int(rng.integers(0, S // 8))
                mask[b, :cut] = 0.0
        self.step += 1
        return {"tokens": tokens[:, :-1],
                "labels": tokens[:, 1:].astype(np.int32),
                "loss_mask": mask}


def calibration_batches(cfg: SyntheticConfig, n_batches: int):
    """The paper's 5x128 calibration sample stream (deterministic)."""
    it = MixtureIterator(cfg, start_step=10_000_019)  # disjoint from training
    return [next(it) for _ in range(n_batches)]
