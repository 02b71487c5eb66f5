"""Prompt-lookup drafting for speculative decoding (the port's own copy
of the JAX package's ``runtime/drafter.py``; pure numpy).

No draft model: the draft distribution is the sequence's *own history*.
Serving traffic is dominated by continuations that literally repeat
spans the context already contains — extraction, summarization, code
edits, chat with a long shared system prompt — so the cheapest possible
drafter is an n-gram match: find the most recent earlier occurrence of
the trailing n-gram of ``prompt + tokens-so-far`` and propose the k
tokens that followed it.  Zero FLOPs, zero HBM, pure numpy on the host
between decode dispatches.

Correctness never depends on the drafter: the engine verifies every
proposal with a real model dispatch and greedy argmax acceptance, so a
bad drafter costs wasted verification width, never a wrong token.  The
contract is deliberately tiny — ``propose(context) -> up to k token
ids`` — so a trie-backed or model-based drafter can slot in later
without touching the engine.
"""

from __future__ import annotations

import numpy as np


class PromptLookupDrafter:
    """Match the last n-gram of the context against its own history.

    ``max_ngram`` down to ``min_ngram``: longer matches are tried
    first (a 3-gram hit is far more predictive than a 1-gram hit).
    Within one n the *most recent* earlier occurrence wins — recency
    tracks the local topic better than frequency on serving streams.
    """

    def __init__(self, k: int, max_ngram: int = 3, min_ngram: int = 1):
        if k < 1:
            raise ValueError(f"drafter k must be >= 1, got {k}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram} max_ngram={max_ngram}")
        self.k = k
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, context: np.ndarray, k: int | None = None
                ) -> np.ndarray:
        """Up to ``k`` drafted continuation tokens for ``context``
        (empty array when no n-gram recurs — the engine then runs an
        ordinary single-token step for this row)."""
        ctx = np.asarray(context, np.int32)
        k = self.k if k is None else min(k, self.k)
        n_ctx = len(ctx)
        if k < 1 or n_ctx < self.min_ngram + 1:
            return np.zeros((0,), np.int32)
        # one vectorized scan for the last token, then extend to longer
        # n-grams only at those candidate sites — this runs on the host
        # between decode dispatches every tick, so it has to cost
        # microseconds, not a fraction of the dispatch itself.
        # ``cand`` holds continuation positions: indices right after an
        # earlier occurrence of ctx[-1], excluding the trailing match
        # itself (it has no continuation yet).
        cand = np.flatnonzero(ctx[:n_ctx - 1] == ctx[-1]) + 1
        if len(cand) == 0:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, n_ctx - 1),
                       self.min_ngram - 1, -1):
            ok = cand[cand >= n]
            for j in range(2, n + 1):      # extend the match backwards
                if len(ok) == 0:
                    break
                ok = ok[ctx[ok - j] == ctx[-j]]
            if len(ok):
                s = int(ok[-1])            # most recent occurrence
                return ctx[s:s + k].copy()
        return np.zeros((0,), np.int32)


__all__ = ["PromptLookupDrafter"]
