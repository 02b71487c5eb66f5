"""Disaggregated serving: prefill workers, decode workers, a
prefix-sharded router, and real KV page handoffs between them (port of
the JAX package's ``runtime/cluster.py``).

Why split the tick loop: prefill is a bandwidth-bound burst (hundreds of
prompt tokens a dispatch, KV written once), decode a latency-bound
steady state (one token a tick a sequence, KV read every tick).  In one
engine each is the other's straggler: a prompt chunk stretches the tick
every decoding sequence waits on.  This module runs the two phases on
separate workers in one process, cooperatively, with the page content
really moving:

- N **prefill workers**: ``Engine(role="prefill")``, each with its own
  ``PagedKVCache`` and prefix-trie shard.  When a request's last prompt
  chunk lands, the engine exports its KV pages as a
  :class:`~repro_torch.runtime.engine.KVHandoff` (pages, first token,
  lifecycle stamps) instead of decoding.
- M **decode workers**: ``Engine(role="decode")``, whose requests all
  arrive through ``inject_prefilled``: admission imports the pages into
  the worker's pool (``PagedKVCache.import_slot``) and the slot decodes
  from its first tick.  Greedy decoding over the migrated pages gives
  the unified engine's tokens.
- a :class:`Router` in front that shards the prefix cache over the
  prefill fleet: the request's first page of tokens is consistent-hashed
  onto a ring (:class:`HashRing`), so requests sharing a system prompt
  land on one worker's trie, and the router steers a request to the
  shard holding its longest cached prefix (``PrefixCache.match_len``,
  read-only) when that beats the hash default.

Backpressure composes per worker: the router holds a request back
(``router.held``) rather than submit past a worker's ``max_queue``;
handoffs wait in the decode worker's queue until its pool has room.

Failure model: the chaos ``migration`` site drops a handoff in transit;
the request re-queues on its source prefill worker, whose trie holds the
prompt's pages (the export retired them into it), so the retry is a trie
hit and the same first token comes again: a drop costs latency, never
tokens.

On the card every worker runs on the one device given, shares one weight
tree (the workers' weight tensors are the same tensors) and, with
``kv_codes``, one calibration (the same tables and fingerprint); the
handoff is a host copy standing in for an inter-host link, and
``cluster.handoff.bytes`` counts what such a link would carry.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
from repro_torch.runtime.engine import (Completion, Engine, EngineConfig,
                                        KVHandoff, Request)
from repro_torch.runtime.telemetry import SCHED_TID, Telemetry, Trace


@dataclasses.dataclass
class ClusterConfig:
    """Topology of the disaggregated cluster."""

    prefill_workers: int = 2
    decode_workers: int = 2
    ring_points: int = 64         # consistent-hash virtual nodes a worker

    def __post_init__(self):
        if self.prefill_workers < 1 or self.decode_workers < 1:
            raise ValueError(
                f"need >= 1 worker of each role, got "
                f"{self.prefill_workers}P/{self.decode_workers}D")


class HashRing:
    """Consistent hashing over worker indices: each worker owns
    ``points`` positions on a 32-bit ring (``zlib.crc32`` of
    ``worker{w}:vnode{v}``, as the reference hashes them), and a key maps
    to the first position at or after its CRC, wrapping.  Adding a
    worker remaps only about 1/N of the keys."""

    def __init__(self, workers: Sequence[int], points: int = 64):
        assert workers, "empty ring"
        self._ring: list[tuple[int, int]] = sorted(
            (zlib.crc32(f"worker{w}:vnode{v}".encode()), w)
            for w in workers for v in range(points))

    def owner(self, key: bytes) -> int:
        h = zlib.crc32(key)
        lo, hi = 0, len(self._ring)
        while lo < hi:              # first ring point at or after h
            mid = (lo + hi) // 2
            if self._ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return self._ring[lo % len(self._ring)][1]


def first_page_key(prompt: np.ndarray, block_size: int) -> bytes:
    """The shard key: the request's first page of tokens (int32 bytes).
    Prompts sharing a system prefix share it, so they hash to one
    prefill worker, whose trie then serves the fleet's copies."""
    return np.asarray(prompt[:block_size], np.int32).tobytes()


@dataclasses.dataclass
class RouterStats:
    routed: int = 0               # requests sent to a prefill worker
    hash_routed: int = 0          # placed by the consistent-hash default
    steered: int = 0              # a prefix owner beat the hash default
    prefix_hits: int = 0          # routed to a shard holding >= 1 page
    held: int = 0                 # held back by a worker's max_queue

    @property
    def cross_worker_hit_rate(self) -> float:
        """Share of routed requests whose longest cached prefix lived on
        some prefill worker and went there."""
        return self.prefix_hits / max(self.routed, 1)


class Router:
    """Prefix-aware front end over the prefill fleet."""

    def __init__(self, prefill: Sequence[Engine], block_size: int,
                 ring_points: int = 64):
        self._prefill = list(prefill)
        self._block_size = block_size
        self.ring = HashRing(range(len(self._prefill)), ring_points)
        self.stats = RouterStats()

    def route(self, prompt: np.ndarray) -> tuple[int, int]:
        """``(worker, cached tokens)`` for ``prompt``: the shard holding
        its longest cached prefix, else the consistent-hash owner of its
        first page (which also wins a tie).  The probe only reads; the
        chosen worker's admission walks the trie again and pins."""
        hash_owner = self.ring.owner(first_page_key(prompt, self._block_size))
        best, best_len = hash_owner, 0
        for w, eng in enumerate(self._prefill):
            if eng.prefix is None:
                continue
            mlen = eng.prefix.match_len(prompt)
            if mlen > best_len or (mlen == best_len and w == hash_owner):
                best, best_len = w, mlen
        self.stats.routed += 1
        if best_len > 0:
            self.stats.prefix_hits += 1
        if best != hash_owner:
            self.stats.steered += 1
        else:
            self.stats.hash_routed += 1
        return best, best_len


class Cluster:
    """Prefill/decode-disaggregated serving of one model, with the
    Engine's ``submit`` / ``step`` / ``run`` / ``generate`` /
    ``pending``.  One tick steps every worker in a fixed order: the
    router's backlog, the prefill workers (their exports), delivery of
    each handoff to the least-loaded decode worker (or a chaos drop that
    re-queues on the source), the decode workers, then the harvest.  One
    seeded injector and one telemetry bundle serve the fleet, so every
    injected fault falls on the reference's event.

    ``device`` (the card unless ``"cpu"``) goes to every worker."""

    def __init__(self, cfg: ModelConfig, params=None, rng_seed: int = 0,
                 quant_bits: int | None = None,
                 act_quant: int | None = None,
                 calib_prompts=None,
                 cluster: ClusterConfig | None = None,
                 engine: EngineConfig | None = None,
                 kv_dtype="float32",
                 kv_codes: bool = False,
                 chaos: ChaosConfig | ChaosInjector | None = None,
                 telemetry: Telemetry | None = None,
                 device=None):
        self.cluster_cfg = cc = cluster or ClusterConfig()
        # one bundle for the fleet: one clock for every trace stamp, one
        # registry with a scope a worker (prefill0., decode1., ...)
        self.telemetry = telemetry or Telemetry()
        template = engine or EngineConfig()
        if template.role != "unified":
            raise ValueError("pass a role-free EngineConfig: the cluster "
                             "assigns roles per worker")
        # one seeded injector for every worker and the migration site:
        # the tick visits them in a fixed order, so each fault is a pure
        # function of (code, request stream, seed)
        self.chaos: ChaosInjector | None = (
            ChaosInjector(chaos) if isinstance(chaos, ChaosConfig) else chaos)

        def worker_cfg(role: str) -> EngineConfig:
            kw = dataclasses.asdict(template)
            kw["role"] = role
            if role == "decode":
                # a decode worker never prefills: a trie would only pin
                # pages nothing can match
                kw["prefix_cache"] = False
            return EngineConfig(**kw)

        common = dict(kv_dtype=kv_dtype, kv_codes=kv_codes, chaos=self.chaos,
                      telemetry=self.telemetry, device=device)
        self.prefill: list[Engine] = []
        for i in range(cc.prefill_workers):
            eng = Engine(cfg, params=params, rng_seed=rng_seed,
                         quant_bits=quant_bits if params is None else None,
                         act_quant=act_quant if params is None else None,
                         calib_prompts=calib_prompts,
                         engine=worker_cfg("prefill"),
                         worker_name=f"prefill{i}", worker_id=i, **common)
            if params is None:
                # quantize and calibrate once, on worker 0, and share the
                # tree: with kv_codes its tables are every pool's, so all
                # handoffs carry one fingerprint
                params = eng.params
            self.prefill.append(eng)
        self.decode: list[Engine] = [
            Engine(cfg, params=params, engine=worker_cfg("decode"),
                   worker_name=f"decode{j}",
                   worker_id=cc.prefill_workers + j, **common)
            for j in range(cc.decode_workers)]
        self.params = params
        self.quant_report = self.prefill[0].quant_report
        self.act_report = self.prefill[0].act_report
        self.router = Router(self.prefill, template.block_size,
                             cc.ring_points)

        # router-held work: (request, forced worker, submit_t, trace)
        self._backlog: deque[
            tuple[Request, int | None, float | None, Trace | None]] = deque()
        self._done: list[Completion] = []
        # the cluster's counters live in the shared registry under root
        # keys; the attribute names are properties over them
        reg = self.telemetry.registry
        self._c = {attr: reg.counter(key, help=hint)
                   for attr, (key, hint) in _CLUSTER_COUNTERS.items()}
        rs = self.router.stats
        reg.gauge("router.routed", lambda: rs.routed)
        reg.gauge("router.hash_routed", lambda: rs.hash_routed)
        reg.gauge("router.steered", lambda: rs.steered)
        reg.gauge("router.prefix_hits", lambda: rs.prefix_hits)
        reg.gauge("router.held", lambda: rs.held)
        reg.gauge("router.cross_worker_hit_rate",
                  lambda: rs.cross_worker_hit_rate)
        backlog = self._backlog
        reg.gauge("cluster.backlog.depth", lambda: len(backlog))

    # ---------------------------------------------------------------- api
    def submit(self, request: Request) -> int:
        """Route a request to its prefill worker (or hold it while that
        worker's queue is full).  Returns the handle (uid)."""
        self._dispatch(request, None, None, None)
        return request.uid

    def _dispatch(self, request: Request, forced: int | None,
                  submit_t: float | None, trace: Trace | None) -> bool:
        """Submit to a prefill worker within its queue bound; ``forced``
        pins the worker (a migration retry goes back to the shard holding
        its pages) and ``trace`` continues a retried request's timeline.
        False when held back."""
        w = forced if forced is not None else (
            self.router.route(request.prompt)[0])
        eng = self.prefill[w]
        mq = eng.engine_cfg.max_queue
        if mq is not None and eng.queue_depth >= mq:
            self.router.stats.held += 1
            self._backlog.append((request, w, submit_t, trace))
            return False
        eng.submit(request)
        st = eng._states[request.uid]
        if submit_t is not None:
            # a retry keeps its first submit stamp: TTFT and deadlines
            # count from there
            st.submit_t = submit_t
        if trace is not None:
            st.trace = trace
        if st.trace is not None:
            st.trace.stamp("route", self.telemetry.clock(),
                           worker=f"prefill{w}", forced=forced is not None)
        return True

    @property
    def pending(self) -> bool:
        return (bool(self._backlog)
                or any(e.pending for e in self.prefill)
                or any(e.pending for e in self.decode))

    def step(self) -> list[Completion]:
        """One cluster tick, in the reference's order: backlog, prefill
        workers, delivery (or a chaos drop re-queued at the source),
        decode workers, harvest.  Returns this tick's completions by
        uid."""
        self.ticks += 1
        for _ in range(len(self._backlog)):
            req, forced, t0, tr = self._backlog.popleft()
            if not self._dispatch(req, forced, t0, tr):
                break               # still full; keep FIFO order
        for w, eng in enumerate(self.prefill):
            if eng.pending:
                eng.step()
            for h in eng.take_handoffs():
                h.source = w
                self._deliver(h)
        for eng in self.decode:
            if eng.pending:
                eng.step()
        out: list[Completion] = []
        for eng in self.prefill + self.decode:
            out += eng.collect()
        self._done += out
        return sorted(out, key=lambda c: c.uid)

    def _deliver(self, h: KVHandoff) -> None:
        """Hand ``h`` to the least-loaded decode worker, or drop it at the
        chaos migration site and re-queue the request on its source
        prefill worker (whose trie holds the prompt's pages)."""
        if self.chaos is not None and self.chaos.migration_fault():
            self.migration_faults += 1
            tr = h.trace
            if tr is not None:
                t = self.telemetry.clock()
                tr.stamp("handoff_dropped", t, source=h.source)
                # close the export's arrow where the transfer died: every
                # flow stays paired (the retry opens a new one)
                self.telemetry.tracer.flow_end(
                    h.source, SCHED_TID, "kv_handoff", h.flow_id, t,
                    uid=int(h.request.uid), dropped=True)
            self._dispatch(h.request, h.source, h.submit_t, tr)
            return
        dw = min(range(len(self.decode)),
                 key=lambda j: (self.decode[j].live_slots
                                + self.decode[j].queue_depth, j))
        self.decode[dw].inject_prefilled(h)
        self.handoffs += 1
        self.handoff_bytes += h.nbytes

    def run(self) -> list[Completion]:
        """Drain everything; return every uncollected completion."""
        while self.pending:
            self.step()
        done, self._done = self._done, []
        return sorted(done, key=lambda c: c.uid)

    def generate(self, requests: Sequence[Request]) -> list[Completion]:
        for r in requests:
            self.submit(r)
        return self.run()

    # ------------------------------------------------------- diagnostics
    def check_partition(self) -> None:
        """The page-partition audit on every worker's pool: an export
        copies content, the source retires into its trie, the importer
        allocates fresh pages, so it holds on both sides after every
        migration."""
        for eng in self.prefill + self.decode:
            eng.check_partition()

    def stats(self) -> dict:
        """The reference's cluster counters (reads of the shared
        registry, plus sums over the workers)."""
        rs = self.router.stats
        d = {
            "ticks": self.ticks,
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "migration_faults": self.migration_faults,
            "router_routed": rs.routed,
            "router_steered": rs.steered,
            "router_held": rs.held,
            "cross_worker_prefix_hit_rate": rs.cross_worker_hit_rate,
            "prefill_tokens_computed": sum(e.prefill_tokens_computed
                                           for e in self.prefill),
            "decode_prefill_tokens": sum(e.prefill_tokens_computed
                                         for e in self.decode),
            "decode_steps": sum(e.total_decode_steps for e in self.decode),
            "shard_pages": [e.prefix.num_pages if e.prefix is not None
                            else 0 for e in self.prefill],
        }
        if self.chaos is not None:
            d.update(self.chaos.stats())
        return d


# The cluster's counters in the fleet's registry, under root keys; the
# attribute names stay, as int properties over them (the Engine's
# pattern).
_CLUSTER_COUNTERS = {
    "ticks": ("cluster.ticks", "cluster scheduler ticks run"),
    "handoffs": ("cluster.handoff.delivered", "KV migrations delivered"),
    "handoff_bytes":
        ("cluster.handoff.bytes", "page bytes moved prefill -> decode"),
    "migration_faults":
        ("cluster.handoff.dropped", "handoffs dropped by chaos"),
}


def _install_counter_views(cls, mapping) -> None:
    for attr in mapping:
        def _get(self, _a=attr):
            return self._c[_a].value

        def _set(self, v, _a=attr):
            self._c[_a]._value = int(v)

        setattr(cls, attr, property(_get, _set))


_install_counter_views(Cluster, _CLUSTER_COUNTERS)


__all__ = ["Cluster", "ClusterConfig", "Router", "RouterStats", "HashRing",
           "first_page_key"]
