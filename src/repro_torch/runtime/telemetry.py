"""Telemetry: the serving stack's measurement plane.

A copy of the JAX package's ``runtime/telemetry.py`` (which imports no JAX):
the port imports nothing of that package, so it keeps its own.

The paper's whole case is an accounting argument — LamaAccel wins
because it *counts* ACT commands, HBM bytes, and energy per op and
shows where they go (PAPER.md §VI) — and the PIM-methodologies
literature (Oliveira et al.) makes the same point at the system level:
adoption is gated on tooling that makes data movement *visible*.  The
serving stack grew continuous batching, chunked prefill, a chaos
harness, and a disaggregated prefill/decode cluster, but its
visibility stayed a pile of ad-hoc dicts and print statements; nobody
could answer "where did this request's 900 ms go" once a KVHandoff
crossed a worker boundary.  This module replaces that with four
pieces, shared by every worker in a process:

- a **metrics registry** (:class:`MetricsRegistry`): typed
  Counter/Gauge/Histogram metrics under namespaced keys
  (``engine.prefill.chunks``, ``cluster.handoff.bytes``).  Every
  stats producer registers into one store; the legacy dict readouts
  (``fault_stats()``, ``Cluster.stats()``) are thin views over it.
- **per-request tracing** (:class:`Trace` + :class:`Tracer`): each
  request carries a ``Trace`` stamped at submit / route / admit /
  every prefill chunk / handoff export / handoff import / first token
  / every decode tick / terminal.  The ``Trace`` rides *through* the
  ``KVHandoff``, so a request's timeline is contiguous across the
  prefill→decode worker boundary — all stamps come from the ONE
  monotonic clock the :class:`Telemetry` bundle owns.
- **Chrome-trace/Perfetto export** (:meth:`Tracer.export`): standard
  ``trace_event`` JSON — one process track per worker, one thread row
  per slot lane (plus a ``requests`` process with one row per
  request), counter tracks for queue depth / live slots / free pages
  / tok-s, and flow arrows linking a handoff's export to its import.
  Load the file in https://ui.perfetto.dev or ``chrome://tracing``.
  A JSONL sink (:meth:`MetricsRegistry.dump_jsonl`,
  :meth:`Tracer.write_jsonl`) serves machine consumers.
- a **flight recorder** (:class:`FlightRecorder`): a bounded ring of
  the last N per-tick records (queue depth, live slots, free pages,
  tokens, tick latency) that the engine dumps alongside the chaos
  replay artifact whenever a request ends ``failed`` — the black box
  for post-mortems.

Clock discipline: latency math wants *monotonic* time (wall clock can
step backwards under NTP), so ``Telemetry.clock`` defaults to
``time.monotonic`` and every engine/router/cluster stamp — deadlines,
TTFT, span boundaries — reads it.  Wall-clock time appears exactly
once, at the submit boundary (``Trace.wall_submit_s``), to anchor a
trace to human time.  Workers sharing one ``Telemetry`` share one
clock, which is what makes handoff-crossing spans provably monotonic.

Overhead budget: with tracing off (the default) the cost is counter
increments — the same integer adds the ad-hoc dicts paid.  With
tracing on, each event is one dict append; the bench row
``telemetry/trace_overhead_frac`` asserts the traced ``disagg``
scenario stays within 5% tok/s of untraced.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Callable, Iterable

from repro_torch.runtime.fault_tolerance import LatencyTracker

# The virtual "process" holding one row per request (tid = uid): the
# request-phase spans (queued / prefill / decode / request) nest there,
# while the per-worker processes hold the lane timelines.
REQUESTS_PID = 9999

# Thread-row scheme inside a worker process: row 0 is the scheduler
# (admission, queue-phase work), row 1+slot is that decode lane.
SCHED_TID = 0


def lane_tid(slot: int) -> int:
    """Trace thread row for a decode slot lane."""
    return 1 + slot


# --------------------------------------------------------------- metrics


class Counter:
    """Monotonically increasing integer metric."""

    __slots__ = ("name", "help", "_value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def inc(self, n: int | bool = 1) -> None:
        self._value += int(n)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Point-in-time metric: either set explicitly or backed by a
    callback (the registry evaluates it at read time — how the legacy
    stat holders like ``PrefixStats`` stay the source of truth while
    the registry is the one place to look)."""

    __slots__ = ("name", "help", "fn", "_value")
    kind = "gauge"

    def __init__(self, name: str, fn: Callable[[], float] | None = None,
                 help: str = ""):
        self.name = name
        self.help = help
        self.fn = fn
        self._value = 0.0

    @property
    def value(self) -> float:
        return self.fn() if self.fn is not None else self._value

    def set(self, v: float) -> None:
        assert self.fn is None, f"gauge {self.name} is callback-backed"
        self._value = v


class Histogram:
    """Latency distribution over a deterministic strided reservoir
    (:class:`~repro_torch.runtime.fault_tolerance.LatencyTracker`): honest
    p50/p99 over arbitrarily long runs at bounded memory."""

    __slots__ = ("name", "help", "tracker")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 tracker: LatencyTracker | None = None):
        self.name = name
        self.help = help
        self.tracker = tracker or LatencyTracker()

    def observe(self, v: float) -> None:
        self.tracker.observe(v)

    def percentile(self, q: float) -> float:
        return self.tracker.percentile(q)

    @property
    def count(self) -> int:
        return self.tracker.count

    @property
    def mean(self) -> float:
        return self.tracker.mean_s

    @property
    def value(self) -> dict:
        return self.tracker.summary()


class MetricsRegistry:
    """One namespaced store for every metric a process produces.

    Keys are dot-namespaced (``engine.prefill.chunks``,
    ``cluster.handoff.bytes``); in a multi-worker cluster each worker
    registers through a :class:`Scope` that prefixes its name
    (``prefill0.engine.prefill.chunks``), so one registry holds the
    whole fleet.  ``counter``/``gauge``/``histogram`` are
    get-or-create: re-registering an existing key returns the existing
    metric (and raises if the kind differs), which is what lets a
    shared producer — e.g. the one chaos injector every worker holds —
    bind its gauges exactly once.
    """

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    # ------------------------------------------------------ registration
    def _get_or_create(self, cls, name: str, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            return m
        m = cls(name, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(self, name: str, fn: Callable[[], float] | None = None,
              help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, fn=fn, help=help)

    def histogram(self, name: str, help: str = "",
                  tracker: LatencyTracker | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help=help,
                                   tracker=tracker)

    def scope(self, prefix: str) -> "Scope":
        return Scope(self, prefix)

    # ------------------------------------------------------------ access
    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics.get(name)

    def value(self, name: str):
        """Scalar value of a counter/gauge, summary dict of a
        histogram.  Raises KeyError for unknown names."""
        return self._metrics[name].value

    def keys(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Flat ``{key: value}`` over every metric — counters as ints,
        gauges evaluated, histograms as summary dicts."""
        return {k: self._metrics[k].value for k in sorted(self._metrics)}

    def render(self, prefix: str = "") -> str:
        """Human-readable dump, one ``key = value`` line per metric,
        sorted — the serve launcher's stats printout."""
        lines = []
        for k in sorted(self._metrics):
            if prefix and not k.startswith(prefix):
                continue
            v = self._metrics[k].value
            if isinstance(v, dict):
                v = " ".join(f"{a}={_fmt(b)}" for a, b in v.items())
            else:
                v = _fmt(v)
            lines.append(f"{k} = {v}")
        return "\n".join(lines)

    def dump_jsonl(self, path: str, label: str | None = None) -> None:
        """Append one timestamped snapshot line to a JSONL file — the
        machine-readable metrics sink (CI uploads it as an artifact)."""
        rec = {"t_wall_s": time.time(), "metrics": self.snapshot()}
        if label is not None:
            rec["label"] = label
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


class Scope:
    """Registry view that prefixes every key with a namespace — how a
    cluster worker keeps its metrics distinct in the shared store.  An
    empty prefix is the identity scope (standalone engines)."""

    __slots__ = ("_reg", "_prefix")

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self._reg = registry
        self._prefix = f"{prefix}." if prefix else ""

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    def key(self, name: str) -> str:
        return self._prefix + name

    def counter(self, name: str, help: str = "") -> Counter:
        return self._reg.counter(self.key(name), help=help)

    def gauge(self, name: str, fn: Callable[[], float] | None = None,
              help: str = "") -> Gauge:
        return self._reg.gauge(self.key(name), fn=fn, help=help)

    def histogram(self, name: str, help: str = "",
                  tracker: LatencyTracker | None = None) -> Histogram:
        return self._reg.histogram(self.key(name), help=help,
                                   tracker=tracker)

    def value(self, name: str):
        return self._reg.value(self.key(name))


# --------------------------------------------------------------- tracing


class Trace:
    """One request's stamp timeline, carried with the request through
    its whole lifecycle — *including* across the prefill→decode worker
    boundary inside the :class:`~repro_torch.runtime.engine.KVHandoff`.

    ``stamps`` is an ordered list of ``(phase, t, args)`` with ``t``
    from the shared monotonic clock, so ``assert_monotonic`` is a real
    invariant even when consecutive stamps come from different
    workers.  Wall-clock appears once, at the submit boundary."""

    __slots__ = ("uid", "stamps", "wall_submit_s", "status")

    def __init__(self, uid: int, t: float, wall: float | None = None):
        self.uid = uid
        self.stamps: list[tuple[str, float, dict]] = []
        self.wall_submit_s = time.time() if wall is None else wall
        self.status: str | None = None      # terminal status once set
        self.stamp("submit", t)

    @property
    def submit_t(self) -> float:
        return self.stamps[0][1]

    @property
    def last_t(self) -> float:
        return self.stamps[-1][1]

    def stamp(self, phase: str, t: float, **args) -> None:
        self.stamps.append((phase, t, args))

    def phases(self) -> list[str]:
        return [p for p, _, _ in self.stamps]

    def times(self, phase: str) -> list[float]:
        return [t for p, t, _ in self.stamps if p == phase]

    def assert_monotonic(self) -> None:
        ts = [t for _, t, _ in self.stamps]
        for a, b, (pa, _, _), (pb, _, _) in zip(ts, ts[1:], self.stamps,
                                                self.stamps[1:]):
            assert b >= a, (self.uid, pa, a, pb, b)

    def to_dict(self) -> dict:
        return {"uid": self.uid, "wall_submit_s": self.wall_submit_s,
                "status": self.status,
                "stamps": [{"phase": p, "t": t, **a}
                           for p, t, a in self.stamps]}


class Tracer:
    """Bounded Chrome-trace event sink shared by every worker.

    Emission is gated on ``enabled`` — each emit call is one dict
    append, and when disabled the calls are single-branch no-ops, so
    tracing costs nothing unless armed.  ``ts`` is microseconds
    relative to the tracer's construction instant on the shared
    monotonic clock, which keeps every track on one timeline."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 enabled: bool = False, max_events: int = 500_000):
        self.clock = clock
        self.enabled = enabled
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._flow_seq = 0
        self._t0 = clock()
        # (pid, None) -> process name; (pid, tid) -> thread name
        self._names: dict[tuple[int, int | None], str] = {}

    # ------------------------------------------------------------- emit
    def next_flow_id(self) -> int:
        """Fresh id for a flow arrow.  Per-export (not per-request):
        a chaos-dropped handoff re-exports under a NEW id, so every
        start/end pair stays 1:1 and orphan detection is exact."""
        self._flow_seq += 1
        return self._flow_seq

    def ts(self, t: float | None = None) -> float:
        return ((self.clock() if t is None else t) - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1           # bounded: count, never grow
            return
        self.events.append(ev)

    def process_name(self, pid: int, name: str) -> None:
        self._names[(pid, None)] = name

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self._names[(pid, tid)] = name

    def complete(self, pid: int, tid: int, name: str, t0: float,
                 t1: float, **args) -> None:
        """One finished span (``ph: X``) on a track row."""
        if not self.enabled:
            return
        self._push({"ph": "X", "pid": pid, "tid": tid, "name": name,
                    "ts": self.ts(t0), "dur": max(self.ts(t1)
                                                  - self.ts(t0), 0.0),
                    "args": args})

    def instant(self, pid: int, tid: int, name: str,
                t: float | None = None, **args) -> None:
        if not self.enabled:
            return
        self._push({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                    "name": name, "ts": self.ts(t), "args": args})

    def counter(self, pid: int, name: str, t: float | None = None,
                **values) -> None:
        """One sample on a counter track (queue depth, free pages...)."""
        if not self.enabled:
            return
        self._push({"ph": "C", "pid": pid, "tid": 0, "name": name,
                    "ts": self.ts(t), "args": values})

    def flow_start(self, pid: int, tid: int, name: str, flow_id: int,
                   t: float | None = None, **args) -> None:
        """Open a flow arrow (``ph: s``) — the handoff-export side."""
        if not self.enabled:
            return
        self._push({"ph": "s", "cat": "handoff", "id": int(flow_id),
                    "pid": pid, "tid": tid, "name": name,
                    "ts": self.ts(t), "args": args})

    def flow_end(self, pid: int, tid: int, name: str, flow_id: int,
                 t: float | None = None, **args) -> None:
        """Close a flow arrow (``ph: f``) — the handoff-import side."""
        if not self.enabled:
            return
        self._push({"ph": "f", "bp": "e", "cat": "handoff",
                    "id": int(flow_id), "pid": pid, "tid": tid,
                    "name": name, "ts": self.ts(t), "args": args})

    # ----------------------------------------------------------- export
    def _metadata_events(self) -> list[dict]:
        out = []
        for (pid, tid), name in sorted(self._names.items(),
                                       key=lambda kv: (kv[0][0],
                                                       kv[0][1] or -1)):
            if tid is None:
                out.append({"ph": "M", "pid": pid, "tid": 0,
                            "name": "process_name",
                            "args": {"name": name}})
            else:
                out.append({"ph": "M", "pid": pid, "tid": tid,
                            "name": "thread_name",
                            "args": {"name": name}})
        return out

    def export(self, path: str | None = None) -> dict:
        """The Chrome-trace/Perfetto document; written to ``path`` when
        given.  ``metadata.dropped_events`` surfaces the ring bound —
        a truncated trace says so instead of silently looking short."""
        doc = {"traceEvents": self._metadata_events() + self.events,
               "displayTimeUnit": "ms",
               "metadata": {"clock": "monotonic-relative-us",
                            "dropped_events": self.dropped}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc

    def write_jsonl(self, path: str) -> int:
        """Stream every event (one JSON object per line) — the sink for
        consumers that don't want the whole document in memory."""
        with open(path, "w") as f:
            for ev in self._metadata_events() + self.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.events)


# -------------------------------------------------------- flight recorder


class FlightRecorder:
    """Bounded ring of the last N per-tick engine records — the black
    box a post-mortem reads.  Always on (one small dict per tick), and
    dumped alongside the chaos replay artifact whenever a request ends
    ``failed``, so "what was the engine doing just before" ships with
    the reproduction recipe."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self._ring: deque[dict] = deque(maxlen=capacity)
        self.recorded = 0

    def record(self, **fields) -> None:
        self.recorded += 1
        self._ring.append(fields)

    def dump(self) -> list[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


# ------------------------------------------------------------- the bundle


class Telemetry:
    """The per-process telemetry bundle: ONE monotonic clock, one
    metrics registry, one trace sink, and the archive of finished
    request traces.  A standalone engine makes its own; a cluster makes
    one and hands it to every worker, which is exactly what makes
    cross-worker timelines share a clock and land in one trace."""

    def __init__(self, tracing: bool = False,
                 clock: Callable[[], float] | None = None,
                 max_trace_events: int = 500_000):
        self.clock = clock or time.monotonic
        self.registry = MetricsRegistry()
        self.tracer = Tracer(clock=self.clock, enabled=tracing,
                             max_events=max_trace_events)
        self.traces: dict[int, Trace] = {}   # uid -> finished Trace

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    def finish_trace(self, trace: Trace) -> None:
        """Archive a finished request trace.  Only while tracing is
        armed — an untraced long-lived server must not accumulate one
        Trace per request forever."""
        if self.tracer.enabled:
            self.traces[trace.uid] = trace

    def bind_chaos(self, injector) -> None:
        """Register the chaos injector's fire counters as root-level
        gauges.  Get-or-create semantics make this idempotent, so the
        one injector every cluster worker shares binds exactly once."""
        injector.bind_metrics(self.registry)


# ------------------------------------------------------------- validation


def _check_row_nesting(row: tuple, events: list[dict]) -> None:
    """Spans on one (pid, tid) row must be disjoint or strictly
    nested — the invariant a sane timeline renders under."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    stack: list[float] = []              # open span end-times
    eps = 1e-3                           # 1 ns in us units
    for e in evs:
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        while stack and stack[-1] <= t0 + eps:
            stack.pop()
        if stack and t1 > stack[-1] + eps:
            raise ValueError(
                f"span {e['name']!r} on row {row} overlaps its "
                f"enclosing span: [{t0}, {t1}] vs end {stack[-1]}")
        stack.append(t1)


def validate_chrome_trace(doc: dict, *,
                          require_boundary: bool = False) -> dict:
    """Validate an exported trace document and return its shape.

    Checks (raising ``ValueError`` on the first violation):
    - structure: a ``traceEvents`` list of well-formed events;
    - per-row timestamps: on every (pid, tid) row the ``X`` spans are
      monotone (sorted emission) and nest-or-disjoint;
    - request spans: every ``request`` span's uid appears exactly once
      (one terminal span per request — nothing vanishes, nothing
      double-terminates);
    - flows: every handoff flow-start has exactly one matching
      flow-end (no orphan handoff spans);
    - with ``require_boundary``: at least one request has spans on two
      different worker processes (a timeline that genuinely crosses
      the prefill→decode boundary).

    Returns ``{"events", "spans", "tracks", "requests",
    "boundary_requests", "flows"}``.
    """
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    rows: dict[tuple, list[dict]] = {}
    request_uids: list = []
    flow_starts: dict[int, int] = {}
    flow_ends: dict[int, int] = {}
    uid_worker_pids: dict[int, set[int]] = {}
    spans = 0
    for e in events:
        ph = e.get("ph")
        if ph not in ("X", "i", "C", "M", "s", "f"):
            raise ValueError(f"unknown event phase {ph!r}: {e}")
        if ph == "M":
            continue
        if "ts" not in e or not isinstance(e["ts"], (int, float)):
            raise ValueError(f"event without numeric ts: {e}")
        if e["ts"] < 0:
            raise ValueError(f"negative ts: {e}")
        if ph == "X":
            spans += 1
            if e.get("dur", -1.0) < 0:
                raise ValueError(f"X event with bad dur: {e}")
            rows.setdefault((e["pid"], e["tid"]), []).append(e)
            if e["name"] == "request":
                request_uids.append(e["args"]["uid"])
            uid = e.get("args", {}).get("uid")
            if uid is not None and e["pid"] != REQUESTS_PID:
                uid_worker_pids.setdefault(uid, set()).add(e["pid"])
        elif ph == "s":
            flow_starts[e["id"]] = flow_starts.get(e["id"], 0) + 1
        elif ph == "f":
            flow_ends[e["id"]] = flow_ends.get(e["id"], 0) + 1
    for row, evs in rows.items():
        ts = [e["ts"] for e in sorted(evs, key=lambda e: e["ts"])]
        if any(b < a for a, b in zip(ts, ts[1:])):  # pragma: no cover
            raise ValueError(f"non-monotone timestamps on row {row}")
        _check_row_nesting(row, evs)
    dupes = {u for u in request_uids if request_uids.count(u) > 1}
    if dupes:
        raise ValueError(f"requests with multiple terminal spans: "
                         f"{sorted(dupes)}")
    orphans = ({i for i, n in flow_starts.items()
                if flow_ends.get(i, 0) != n}
               | {i for i in flow_ends if i not in flow_starts})
    if orphans:
        raise ValueError(f"orphan handoff flows (unpaired s/f): "
                         f"{sorted(orphans)}")
    boundary = [u for u, pids in uid_worker_pids.items() if len(pids) > 1]
    if require_boundary and not boundary:
        raise ValueError("no request span crosses a worker boundary")
    return {"events": sum(e.get("ph") != "M" for e in events),
            "spans": spans,
            "tracks": len(rows),
            "requests": len(set(request_uids)),
            "boundary_requests": len(boundary),
            "flows": sum(flow_starts.values())}


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "Scope",
           "Trace", "Tracer", "FlightRecorder", "Telemetry",
           "validate_chrome_trace", "REQUESTS_PID", "SCHED_TID",
           "lane_tid"]
