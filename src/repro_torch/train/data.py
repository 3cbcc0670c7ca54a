"""Synthetic-but-learnable data pipeline (a copy of ``repro.train.data``).

Token streams are drawn from a fixed random first-order Markov chain over
the vocabulary (seeded), so a language model has real structure to learn:
loss starts near ln(V) and should approach the chain's conditional
entropy. Deterministic, shardable, infinite.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4        # out-degree of the Markov chain


class MarkovDataset:
    """Infinite batches of (tokens, labels) from a sparse Markov chain."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, k = cfg.vocab_size, cfg.branching
        self._succ = rng.integers(0, v, size=(v, k), dtype=np.int32)
        probs = rng.dirichlet(np.ones(k) * 0.5, size=v).astype(np.float32)
        self._cum = np.cumsum(probs, axis=1)
        self._probs = probs

    def entropy(self) -> float:
        """Conditional entropy of the chain (loss floor, nats)."""
        p = self._probs
        h = -(p * np.log(np.maximum(p, 1e-12))).sum(axis=1)
        return float(h.mean())

    def _walk(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        out = np.empty(length + 1, dtype=np.int32)
        s = int(rng.integers(0, v))
        for i in range(length + 1):
            out[i] = s
            r = rng.random()
            j = int(np.searchsorted(self._cum[s], r))
            s = int(self._succ[s, min(j, self._succ.shape[1] - 1)])
        return out

    def batches(self, start_step: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = start_step
        while True:
            toks = np.stack([
                self._walk(np.random.default_rng((self.cfg.seed, step, b)),
                           self.cfg.seq_len)
                for b in range(self.cfg.batch_size)
            ])
            yield toks[:, :-1], toks[:, 1:]
            step += 1
