"""Deterministic synthetic token pipeline (the port's own copy of
``repro/data/pipeline.py``, numpy only: its batches are the reference's bit
for bit).

Generates a reproducible "language" (Zipfian unigrams with a Markov
low-rank structure so the loss actually decreases) without external data.
Shard-aware: each (data-parallel) host slice can be produced independently
from the (seed, step, shard) triple.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    num_states: int = 16   # Markov states -> learnable structure


class SyntheticTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        base = ranks ** (-cfg.zipf_a)
        # Per-state token distributions: Zipf re-permuted per Markov state.
        self._state_dists = []
        for _ in range(cfg.num_states):
            p = base[rng.permutation(v)]
            self._state_dists.append(p / p.sum())
        self._trans = rng.dirichlet(np.ones(cfg.num_states) * 0.5, size=cfg.num_states)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        states = np.zeros((b, s), np.int64)
        states[:, 0] = rng.integers(0, cfg.num_states, b)
        for t in range(1, s):
            u = rng.random(b)
            cum = np.cumsum(self._trans[states[:, t - 1]], axis=1)
            states[:, t] = (u[:, None] < cum).argmax(1)
        tokens = np.zeros((b, s), np.int32)
        for st in range(cfg.num_states):
            m = states == st
            n = int(m.sum())
            if n:
                tokens[m] = rng.choice(cfg.vocab_size, size=n, p=self._state_dists[st])
        labels = np.concatenate([tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
