"""Fault-tolerance utilities: straggler watchdog, preemption signals,
bounded retry.

A copy of the JAX package's ``runtime/fault_tolerance.py`` (which imports no JAX):
the port imports nothing of that package, so it keeps its own.

On a real multi-pod deployment the watchdog feeds the control plane
(slow-host eviction / job restart from the latest atomic checkpoint);
here the same logic is exercised by tests via simulated step times and a
file-based preemption flag (examples/train_tiny_lm.py kills itself
mid-run and resumes bit-exactly).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from pathlib import Path
from typing import Callable

import numpy as np


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor.

    A step slower than ``threshold`` x EWMA is flagged; ``patience``
    consecutive flags trigger ``on_straggler`` (default: record only —
    production hook would evict/rebalance; see DESIGN.md §6).
    """

    threshold: float = 2.5
    alpha: float = 0.1
    patience: int = 3
    warmup_steps: int = 5
    on_straggler: Callable[[int, float, float], None] | None = None

    ewma: float = 0.0
    seen: int = 0
    consecutive: int = 0
    flagged_steps: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.seen += 1
        if self.seen <= self.warmup_steps:
            self.ewma = dt if self.ewma == 0 else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.consecutive += 1
            self.flagged_steps.append((step, dt, self.ewma))
            if self.consecutive >= self.patience and self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        else:
            self.consecutive = 0
            self.ewma = self.alpha * dt + (1 - self.alpha) * self.ewma
        return slow


@dataclasses.dataclass
class LatencyTracker:
    """Bounded per-step latency reservoir with percentile readout.

    Serving SLOs live in tails, not means — a mean TTFT hides the one
    request that waited behind a 4k prefill.  The tracker keeps an
    evenly-strided subsample (deterministic: when full, every other
    sample is dropped and the keep-stride doubles), so ``percentile``
    stays honest over arbitrarily long runs at O(capacity) memory.
    """

    capacity: int = 4096
    samples: list = dataclasses.field(default_factory=list)
    count: int = 0          # total observations (not just retained)
    total_s: float = 0.0
    _stride: int = 1
    _skip: int = 0

    def observe(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        if self._skip:
            self._skip -= 1
            return
        self._skip = self._stride - 1
        self.samples.append(dt)
        if len(self.samples) >= self.capacity:
            self.samples = self.samples[::2]
            self._stride *= 2

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 when nothing observed yet."""
        if not self.samples:
            return 0.0
        return float(np.percentile(self.samples, q))

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    def summary(self) -> dict:
        """The distribution as one JSON-ready dict — what a registry
        Histogram snapshot reports."""
        return {"count": self.count,
                "mean_s": self.mean_s,
                "p50_s": self.percentile(50),
                "p99_s": self.percentile(99)}


class PreemptionSignal:
    """Cooperative preemption: SIGTERM handler + file flag (tests)."""

    def __init__(self, flag_path: str | Path | None = None):
        self.flag_path = Path(flag_path) if flag_path else None
        self._hit = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass  # non-main thread (tests)

    def _handler(self, *_):
        self._hit = True

    def should_stop(self) -> bool:
        if self._hit:
            return True
        if self.flag_path is not None and self.flag_path.exists():
            return True
        return False


def with_retries(fn: Callable, max_attempts: int = 3,
                 retry_on=(RuntimeError,), backoff_s: float = 0.1):
    """Bounded retry for transient device errors (collective timeouts,
    slice restarts)."""
    def wrapped(*a, **kw):
        err = None
        for attempt in range(max_attempts):
            try:
                return fn(*a, **kw)
            except retry_on as e:  # pragma: no cover (exercised in tests)
                err = e
                time.sleep(backoff_s * (2 ** attempt))
        raise err
    return wrapped
