"""Deterministic, restart-stable synthetic data pipeline (the port's
copy of the JAX package's ``data/pipeline.py``, numpy only; within one
process its batches are byte-equal to the reference's).

Every batch is a pure function of (seed, step, host_slice): after a
preemption the loop resumes at step k and regenerates the *identical*
token stream with no host coordination — the property the fault-tolerance
tests assert.  The token distribution is a order-2 Markov chain derived
from a hashed transition structure, giving a learnable (loss-decreasing)
signal for the integration tests, unlike uniform noise.

Each batch's generator is seeded with ``hash(what)``, as in the
reference: Python salts ``str`` hashes per process unless
``PYTHONHASHSEED`` is set, so a step's batch is drawn again the same
within one process (a ``Trainer`` resumed in the process that wrote the
checkpoint), not in another.

Sharding: ``host_batch_slice`` carves the global batch by data-parallel
rank so multi-host loaders feed disjoint slices of the same global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    markov_states: int = 64


def _rng_for(cfg: DataConfig, step: int, what: str) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, hash(what) & 0x7FFFFFFF]))


class SyntheticLM:
    """Order-1 Markov token stream over a hashed transition table."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(np.random.SeedSequence([cfg.seed, 999]))
        s = cfg.markov_states
        # sparse-ish row-stochastic transitions over state buckets
        logits = base.normal(size=(s, s)) * 2.0
        self.trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        self.state_to_token = base.integers(
            0, cfg.vocab_size, size=(s, max(1, cfg.vocab_size // s)))

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        cfg = self.cfg
        rng = _rng_for(cfg, step, "tokens")
        b = cfg.global_batch
        s = cfg.seq_len + 1
        states = np.empty((b, s), np.int64)
        states[:, 0] = rng.integers(0, cfg.markov_states, b)
        for t in range(1, s):
            u = rng.random((b, 1))
            cdf = np.cumsum(self.trans[states[:, t - 1]], axis=1)
            states[:, t] = (u < cdf).argmax(axis=1)
        sub = rng.integers(0, self.state_to_token.shape[1], size=(b, s))
        toks = self.state_to_token[states, sub].astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if host_slice is not None:
            batch = {k: v[host_slice] for k, v in batch.items()}
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def host_batch_slice(global_batch: int, dp_rank: int, dp_size: int) -> slice:
    per = global_batch // dp_size
    return slice(dp_rank * per, (dp_rank + 1) * per)
