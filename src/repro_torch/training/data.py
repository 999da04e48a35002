"""Synthetic data pipeline: deterministic, shardable token streams.

A copy of :mod:`repro.training.data` (numpy only): batches are numpy
arrays, so both packages train on identical tokens.

Generates Zipf-distributed token documents with BOS-delimited boundaries —
enough structure that a small LM's loss visibly decreases (used by the
end-to-end training example and the convergence test).  Each data-parallel
rank draws a disjoint PRNG stream, so the pipeline scales to any DP degree
without coordination (and restarts deterministically from a step index —
required for checkpoint/restart to be exactly reproducible).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.3
    bos_id: int = 1
    mean_doc_len: int = 64
    seed: int = 1234


class SyntheticStream:
    """Deterministic per-(rank, step) batch generator."""

    def __init__(self, cfg: DataConfig, rank: int = 0, world: int = 1):
        assert cfg.global_batch % world == 0
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self.local_batch = cfg.global_batch // world

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, self.rank, step))  # restart-deterministic
        n = self.local_batch * (cfg.seq_len + 1)
        toks = rng.zipf(cfg.zipf_a, size=n).astype(np.int64)
        toks = np.minimum(toks + 1, cfg.vocab_size - 1).astype(np.int32)
        # Inject document boundaries; make position-after-BOS predictable
        # (a learnable bigram structure).
        doc_mask = rng.random(n) < 1.0 / cfg.mean_doc_len
        toks[doc_mask] = cfg.bos_id
        after = np.roll(doc_mask, 1)
        toks[after] = (toks[np.roll(np.arange(n), 2)][after] % 16) + 2
        toks = toks.reshape(self.local_batch, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
