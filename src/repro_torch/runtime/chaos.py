"""Seeded chaos harness for the serving Engine: deterministic fault
injectors at the failure sites the serving failure model defines
(DESIGN.md "Failure model & request lifecycle"): four single-engine
sites plus the cluster's KV-migration site.

A copy of the JAX package's ``runtime/chaos.py`` (which imports no JAX):
the port imports nothing of that package, so it keeps its own.

The PIM methodology literature (Oliveira et al., 2022) names robust
system-integration/validation tooling as the gap blocking data-centric
architectures: an in-DRAM LUT engine assumes the *host runtime* absorbs
faults the near-memory compute cannot.  This module is that runtime's
proof harness — every injector draws from one ``numpy`` Generator
seeded by ``ChaosConfig.seed``, so a chaos run is a pure function of
(code, request stream, seed): the soak test replays bit-identically
and a failure reproduces from its replay artifact.

Injection sites (wired in ``engine.Engine``):

- **allocator** (``alloc_fault``): a page allocation transiently fails.
  Admission-time faults leave the request queued for the next tick;
  growth-time faults preempt the sequence onto the queue front (greedy
  decoding makes the recompute token-identical), so an allocator fault
  never changes tokens — only latency.
- **jitted tick** (``nan_slot``): one active slot's logits are declared
  non-finite.  Detection is real (the jitted steps return per-row
  ``isfinite`` flags; chaos merely forces a flag low), so a genuine
  device NaN takes the identical path: the request fails with a replay
  artifact, the slot lane is quarantined for a few ticks, and the rest
  of the batch keeps running.
- **KV pages** (``corrupt_page``): one checksummed page's bytes flip
  (``PagedKVCache.corrupt_page``).  The engine's per-tick CRC audit
  (auto-enabled whenever ``corrupt_rate > 0``) catches it at the start
  of the *next* tick — before any dispatch attends the corrupt KV — and
  fails exactly the sequences reading that page.
- **tick latency** (``tick_delay``): the scheduler sleeps, exercising
  the :class:`~repro_torch.runtime.fault_tolerance.StragglerWatchdog` wired
  into ``Engine.step``.
- **migration** (``migration_fault``, wired in ``runtime.cluster``):
  a prefill->decode KV page handoff drops in transit.  The cluster
  re-queues the request on its prefill worker; the retry re-prefills
  (a trie hit when the prefix cache is on, since handoff retirement
  inserted the pages) and hands off again — latency, never tokens.

Determinism contract: the engine calls each injector at fixed points
in the tick (one ``tick_delay`` per step, one ``nan_slot`` per
dispatch, one ``corrupt_page`` per step, one ``alloc_fault`` per
allocation attempt), so for a fixed request stream the rng call
sequence — and therefore every injected fault — is reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ChaosConfig:
    """Per-site fault rates; 0.0 disables a site.  All draws come from
    one Generator seeded by ``seed``."""

    seed: int = 0
    alloc_fail_rate: float = 0.0   # per allocation attempt
    nan_rate: float = 0.0          # per dispatch: one slot's logits go NaN
    corrupt_rate: float = 0.0      # per tick: one checksummed page flips
    slow_tick_rate: float = 0.0    # per tick: the scheduler stalls
    slow_tick_s: float = 0.05      # injected stall duration
    migration_fail_rate: float = 0.0  # per handoff: KV transfer drops

    @classmethod
    def storm(cls, seed: int, *, rate: float = 0.03,
              slow_tick_s: float = 0.002) -> "ChaosConfig":
        """All five sites live at a uniform rate — the soak preset
        behind ``launch/serve.py --chaos <seed>``.  The migration site
        only fires on cluster (prefill/decode-disaggregated) runs —
        single-engine serving never hands pages off."""
        return cls(seed=seed, alloc_fail_rate=rate, nan_rate=rate,
                   corrupt_rate=rate, slow_tick_rate=rate,
                   slow_tick_s=slow_tick_s, migration_fail_rate=rate)


class ChaosInjector:
    """Stateful injector: one seeded rng + per-site fire counters."""

    def __init__(self, config: ChaosConfig):
        self.cfg = config
        self.rng = np.random.default_rng(config.seed)
        self.alloc_faults = 0
        self.nan_faults = 0
        self.corrupt_faults = 0
        self.slow_ticks = 0
        self.migration_faults = 0

    # ------------------------------------------------------------ sites
    def alloc_fault(self) -> bool:
        """One allocation attempt: does it transiently fail?"""
        if self.cfg.alloc_fail_rate <= 0.0:
            return False
        hit = bool(self.rng.random() < self.cfg.alloc_fail_rate)
        self.alloc_faults += hit
        return hit

    def nan_slot(self, slots: list[int]) -> int | None:
        """One dispatch: pick a slot whose logits 'went NaN', or None.
        ``slots`` is the eligible set (rows whose logits this tick
        actually consumes: decoding slots, or prefill rows sampling
        their first token)."""
        if self.cfg.nan_rate <= 0.0 or not slots:
            return None
        if self.rng.random() >= self.cfg.nan_rate:
            return None
        self.nan_faults += 1
        return int(slots[self.rng.integers(len(slots))])

    def corrupt_page(self, pages: list[int]) -> int | None:
        """One tick: pick a checksummed page to bit-flip, or None."""
        if self.cfg.corrupt_rate <= 0.0 or not pages:
            return None
        if self.rng.random() >= self.cfg.corrupt_rate:
            return None
        self.corrupt_faults += 1
        return int(pages[self.rng.integers(len(pages))])

    def migration_fault(self) -> bool:
        """One prefill->decode KV handoff: does the transfer drop?  A
        dropped handoff re-queues the request on its prefill worker —
        with the prefix cache on, the retry's re-prefill is a trie hit,
        so the fault costs latency, never tokens (greedy re-sampling of
        the first token is identical)."""
        if self.cfg.migration_fail_rate <= 0.0:
            return False
        hit = bool(self.rng.random() < self.cfg.migration_fail_rate)
        self.migration_faults += hit
        return hit

    def tick_delay(self) -> float:
        """One tick: seconds of injected scheduler stall (0.0 = none)."""
        if self.cfg.slow_tick_rate <= 0.0:
            return 0.0
        if self.rng.random() >= self.cfg.slow_tick_rate:
            return 0.0
        self.slow_ticks += 1
        return self.cfg.slow_tick_s

    # ------------------------------------------------------------ stats
    def bind_metrics(self, registry) -> None:
        """Register this injector's fire counters as callback gauges
        under root-level ``chaos.*`` keys (no worker prefix: one
        injector is shared by every worker in a cluster, so its
        counts are fleet-wide by construction).  Registration is
        get-or-create, so each worker binding the shared injector is
        idempotent.  ``registry`` is duck-typed (a
        ``telemetry.MetricsRegistry``) — this module stays importable
        without the telemetry machinery."""
        registry.gauge("chaos.seed", lambda: self.cfg.seed)
        registry.gauge("chaos.alloc_faults", lambda: self.alloc_faults)
        registry.gauge("chaos.nan_faults", lambda: self.nan_faults)
        registry.gauge("chaos.corrupt_faults", lambda: self.corrupt_faults)
        registry.gauge("chaos.slow_ticks", lambda: self.slow_ticks)
        registry.gauge("chaos.migration_faults",
                       lambda: self.migration_faults)

    def stats(self) -> dict:
        """Legacy dict view (deprecated in favor of the ``chaos.*``
        registry gauges bound by :meth:`bind_metrics`); the key shape
        is frozen for existing consumers."""
        return {"chaos_seed": self.cfg.seed,
                "chaos_alloc_faults": self.alloc_faults,
                "chaos_nan_faults": self.nan_faults,
                "chaos_corrupt_faults": self.corrupt_faults,
                "chaos_slow_ticks": self.slow_ticks,
                "chaos_migration_faults": self.migration_faults}


__all__ = ["ChaosConfig", "ChaosInjector"]
