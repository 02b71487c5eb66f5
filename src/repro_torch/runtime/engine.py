"""Serving engine: continuous batching over a paged KV cache with chunked
flash prefill (port of the core of the JAX package's
``runtime/engine.py``).

- ``submit(request) -> handle``: enqueue; nothing runs yet.
- ``step() -> [Completion]``: one scheduler tick -- admit waiting
  requests into free slots, advance every admitted-but-not-prefilled
  sequence by ONE prompt chunk in one full-width dispatch, run ONE
  batched decode step across all decoding slots, retire finished ones.
- ``stream(handle)`` / ``run()`` / ``generate(requests)``.

Scheduling is the reference's: FIFO admission of up to
``max_batched_prefill`` heads per tick, pages for the prompt tail only
(no worst-case reservation); when the head cannot get its pages, the
next four waiting requests are scanned and prefix-cache hits admitted
first (``admission_reorders``); when the free list runs dry, unpinned
trie pages are evicted (LRU leaves first) and then the youngest running
sequence is preempted (pages released, sequence re-queued to be
recomputed; greedy decoding makes the recompute token-identical).  The
chunk width and the block-table column count follow the reference's
pow2 ladders (``_chunk_width``/``_live_cols``), so the kernels see the
same M and page-column counts as the reference's.

Prefix cache (``EngineConfig.prefix_cache``, on by default as in the
reference): a retired sequence's pages go into a radix trie
(:class:`~repro_torch.runtime.prefix_cache.PrefixCache`) keyed by the
tokens they hold.  Admission matches the prompt against the trie (the
match is kept across ticks until the trie changes), pins the longest
cached prefix (at most ``plen - 1`` tokens, so the last prompt token is
always computed), splices those pages into the block table and
prefills only the tail, whose first chunk starts at the hit length --
anywhere inside a page.  The boundary page the tail writes into is
copied first (``cow_slot_page``, on the device, at admission, between
two steps): a shared page is never written.

Speculative decoding (``spec_k > 0``): each tick a prompt-lookup
drafter (:class:`~repro_torch.runtime.drafter.PromptLookupDrafter`)
proposes up to ``spec_k`` tokens a decoding slot, clamped to the
request's budget and the pages the slot owns; if any slot has a
proposal, the tick is one verify dispatch of width ``spec_k + 1``
(``transformer.spec_verify_into_cache``) that commits ``drafts[:accept]``
plus the model's own token, cut at the stop token.  Only ``lengths``
advances, so a rejected tail needs no undo.  A tick with no proposal
runs the vanilla decode step.

Greedy argmax and the per-row ``isfinite`` flag are computed in the same
step as the logits and cross to the host in one transfer per tick.  On
the card each tick is one dispatch, as the reference's jitted
``_jit_prefill`` / ``_jit_decode`` are: a
:class:`~repro_torch.runtime.step_graph.StepGraph` per decode width
(the pow2 block-table column ladder) and per prefill (chunk width,
columns) takes the tick's host inputs in one copy, replays the step as a
CUDA graph captured after the first eager tick at that key, and returns
the argmax and flags in one copy back; a verify dispatch is one more
key, ``("spec", cols)``, whose step packs the argmax at every window
position, the accepted count and the flag into one int32 ``[B, S + 2]``.
``cuda_graphs=False`` runs every tick eagerly (the A/B); on the CPU
ticks always run eagerly.  Trie and drafter state live on the host and
are read between steps, never inside one.

Activations as codes (``act_quant``: per-(layer, site) tables fit on
sample prompts at construction, on the engine's device, disk-cached),
KV pages as codes (``kv_codes``: uint8 pages under per-head tables) and
narrow KV pages (``kv_dtype="float8_e4m3fn"``: cast at the write as the
reference casts, upcast in the attention kernels after the load) are
served; the engine counts the attention boundary's traffic from shapes
(``attn_bytes_read``, ``attn_act_bytes``, ``attn_dequants``).  Weights
of mixed bit widths (``core.lama_layers.quantize_tree_mixed``) serve
through the same kernels: a code's width travels in its table.

Request lifecycle, as the reference's: every request ends in exactly one
terminal status -- ``ok``, ``cancelled`` (:meth:`Engine.cancel`, queued,
between prefill chunks or mid-decode), ``deadline_exceeded``
(``Request.deadline_s``, a budget from submit), ``rejected`` (a bounded
queue, ``max_queue``, sheds by ``shed_policy``; :meth:`drain_queue`) or
``failed``.  A non-finite logits row (the step's per-row flag) fails
its request alone: a replay artifact is kept (and written under
``replay_dir``), the lane rests ``quarantine_ticks`` ticks, the batch
keeps running.  ``checksum_pages`` records a CRC of every page a
dispatch writes and verifies them at the top of the next tick, so a
corrupt page fails its readers (and drops its trie subtree) before any
dispatch attends it.  A seeded chaos injector
(:class:`~repro_torch.runtime.chaos.ChaosInjector`) forces each fault at
the reference's sites.
:meth:`snapshot` / :meth:`restore` rebuild the bookkeeping after a
crash: live requests re-prefill prompt plus tokens so far.

Telemetry (:mod:`~repro_torch.runtime.telemetry`): the counters are
views over one metrics registry (``metrics``, ``fault_stats``), gauges
read the live state, a flight recorder keeps the last ticks for the
replay artifacts, and ``Telemetry(tracing=True)`` records per-request
traces and a Chrome trace.  The calibration drift guard
(``drift_check_every``) re-measures the act-quant sites' SQNR on a live
prompt every N ticks and warns past ``drift_threshold_db``.

Disaggregation roles (``EngineConfig.role``, the reference's): a
``"unified"`` engine interleaves prefill and decode; a ``"prefill"``
engine runs prompts only, and when a request's last chunk lands and its
first token is sampled it exports the slot's KV pages as a
:class:`KVHandoff` (``take_handoffs``) instead of decoding; a
``"decode"`` engine takes handoffs through :meth:`Engine.inject_prefilled`,
whose admission imports the pages into its own pool and enters the
decode loop at once.  :class:`~repro_torch.runtime.cluster.Cluster` runs
the two roles side by side.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
import warnings
import weakref
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.models import api as mapi
from repro_torch.models.params import ParamTree
from repro_torch.runtime import calibration as cal
from repro_torch.runtime.chaos import ChaosConfig, ChaosInjector
from repro_torch.runtime.drafter import PromptLookupDrafter
from repro_torch.runtime.fault_tolerance import LatencyTracker, StragglerWatchdog
from repro_torch.runtime.paged_cache import PagedKVCache
from repro_torch.runtime.prefix_cache import PrefixCache, PrefixNode
from repro_torch.runtime.step_graph import StepGraph
from repro_torch.runtime.telemetry import (REQUESTS_PID, SCHED_TID,
                                           FlightRecorder, Telemetry, Trace,
                                           lane_tid)

# terminal statuses: every request ends in exactly one of these
ST_OK = "ok"
ST_CANCELLED = "cancelled"
ST_DEADLINE = "deadline_exceeded"
ST_REJECTED = "rejected"
ST_FAILED = "failed"
TERMINAL_STATUSES = (ST_OK, ST_CANCELLED, ST_DEADLINE, ST_REJECTED,
                     ST_FAILED)
SHED_POLICIES = ("reject-new", "shed-oldest")
ENGINE_ROLES = ("unified", "prefill", "decode")   # see the module docstring
KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    stop_token: int | None = None
    deadline_s: float | None = None  # wall-clock budget from submit()


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray
    prefill_s: float              # this request's own prefill wall time
    decode_s: float               # wall time of the steps it was active in
    decode_steps: int = 0
    ttft_s: float = 0.0           # submit -> first token available
    queue_wait_s: float = 0.0     # submit -> first admission into a slot
    status: str = ST_OK           # terminal status (TERMINAL_STATUSES)


@dataclasses.dataclass
class EngineConfig:
    """The reference's fields and defaults."""

    num_slots: int = 4            # concurrent decode lanes
    block_size: int = 16          # tokens per KV page
    max_seq_len: int = 512        # per-sequence cap (prompt + generated)
    num_blocks: int | None = None  # page-pool size; None -> full occupancy
    prefix_cache: bool = True     # radix-trie KV reuse across requests
    max_batched_prefill: int = 4  # admissions per scheduler tick
    prefill_chunk: int = 256      # max prompt tokens advanced per row/tick
    max_queue: int | None = None  # waiting-queue bound; None: unbounded
    shed_policy: str = "reject-new"  # overload: reject-new | shed-oldest
    max_preemptions: int = 3      # starvation guard: never a victim after N
    checksum_pages: bool = False  # per-tick KV page CRC audit
    quarantine_ticks: int = 8     # lane rest after a non-finite dispatch
    replay_dir: str | None = None  # where failed requests' artifacts land
    role: str = "unified"         # unified | prefill | decode (cluster)
    spec_k: int = 0               # drafted tokens a slot a tick; 0: off
    spec_max_ngram: int = 3       # longest n-gram the drafter matches
    spec_min_ngram: int = 1       # shortest n-gram worth proposing from
    drift_check_every: int = 0    # drift-guard period in ticks; 0: off
    drift_threshold_db: float = 6.0


@dataclasses.dataclass
class KVHandoff:
    """One finished prefill leaving a prefill worker: the request, the
    tokens sampled so far (the first one), and the KV page content in
    block-table order, host-resident (``PagedKVCache.export_slot``) --
    what the decode worker's ``import_slot`` scatters into its pool.
    The lifecycle stamps ride along, so the completion reports
    end-to-end TTFT and queue wait across the two workers."""

    request: Request
    tokens: list[int]             # sampled so far (the first token)
    length: int                   # KV tokens written (the prompt)
    k_pages: torch.Tensor         # [L, n_pages, bs, n_kv, hd], host
    v_pages: torch.Tensor
    block_size: int
    submit_t: float = 0.0
    admit_t: float | None = None
    first_token_t: float | None = None
    prefill_s: float = 0.0
    preemptions: int = 0
    source: int | None = None     # the cluster's prefill worker index
    # codes pages decode only under the tables they were written with:
    # the exporter's table fingerprint (None for float pages), checked
    # by inject_prefilled
    kv_fingerprint: int | None = None
    # the request's trace crosses with the handoff; flow_id pairs the
    # export's flow arrow with the import's
    trace: Trace | None = None
    flow_id: int = 0

    @property
    def nbytes(self) -> int:
        """Bytes a deployment would move across the interconnect."""
        return self.k_pages.nbytes + self.v_pages.nbytes


def kv_dtype_of(kv_dtype) -> torch.dtype:
    """The KV page dtype of a name or dtype: float32, bfloat16 or
    float8_e4m3fn."""
    name = kv_dtype if isinstance(kv_dtype, str) else str(kv_dtype).split(".")[-1]
    if name not in KV_DTYPES:
        raise ValueError(f"kv_dtype {name!r}: one of {tuple(KV_DTYPES)}")
    return KV_DTYPES[name]


_QUEUED, _RUNNING, _FINISHED = "queued", "running", "finished"


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """[2, B] int64 on the logits' device: the greedy token and the
    finite flag of each row's last position (inside the step, so they
    cross to the host in the tick's one transfer)."""
    last = logits[:, -1, :]
    return torch.stack([torch.argmax(last, -1),
                        torch.isfinite(last).all(-1).to(torch.int64)])


@dataclasses.dataclass
class _SeqState:
    request: Request
    seq_no: int = 0               # submission order (preemption priority)
    status: str = _QUEUED
    term: str = ST_OK             # terminal status once status == _FINISHED
    slot: int = -1
    tokens: list[int] = dataclasses.field(default_factory=list)
    next_token: int = 0
    prefix_len: int = 0           # prompt tokens served from the trie
    prefill_pos: int = 0          # tail tokens already chunk-prefilled
    prefill_done: bool = False
    pinned: list[PrefixNode] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0
    submit_t: float = 0.0
    admit_t: float | None = None
    first_token_t: float | None = None
    # the trie match kept across ticks: (trie generation, prompt
    # length, match); valid while neither changes
    match_cache: tuple | None = None
    # a migrated prefill waiting for its import (decode role); dropped
    # once the pages are in this pool
    handoff: KVHandoff | None = None
    trace: Trace | None = None    # the request's stamp timeline

    def full_prompt(self) -> np.ndarray:
        """Prompt plus tokens generated before a preemption: greedy
        decoding is deterministic, so re-prefilling this continues the
        stream token-identically."""
        if not self.tokens:
            return np.asarray(self.request.prompt, np.int32)
        return np.concatenate([np.asarray(self.request.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])

    def completion(self) -> Completion:
        ttft = (self.first_token_t - self.submit_t
                if self.first_token_t is not None else 0.0)
        wait = (self.admit_t - self.submit_t
                if self.admit_t is not None else 0.0)
        return Completion(self.request.uid, np.asarray(self.tokens, np.int32),
                          self.prefill_s, self.decode_s, self.decode_steps,
                          ttft_s=ttft, queue_wait_s=wait, status=self.term)


class Engine:
    """Continuous-batching serving engine over a paged KV cache, on the
    card unless ``device="cpu"`` is passed.

    ``act_quant`` (bits) fits the activation tables on ``calib_prompts``
    (default: 4 random prompts) and serves activations as codes;
    ``params`` that already carry tables are served with them.
    ``kv_codes`` stores KV pages as uint8 codes under the per-head
    attn_k/attn_v tables, which must exist (``act_quant`` or params that
    carry them).

    ``cuda_graphs`` (on the card): replay each tick's step as a CUDA
    graph, one per shape key, captured after the key's first (eager)
    tick; False runs every tick eagerly.  Meaningless on the CPU.

    ``chaos`` (a :class:`~repro_torch.runtime.chaos.ChaosConfig` or an
    injector) forces faults at the reference's sites; ``telemetry`` is
    the :class:`~repro_torch.runtime.telemetry.Telemetry` bundle (one is
    made when None), ``worker_name`` the engine's key prefix in its
    registry and ``worker_id`` its process row in the trace."""

    @staticmethod
    def supports(cfg: ModelConfig) -> bool:
        """Whether this model family has the paged serving path (the
        reference's test: the hybrid has none)."""
        return (mapi.get_model(cfg).prefill_into_cache is not None
                and not cfg.frontend)

    def __init__(self, cfg: ModelConfig, params: ParamTree | None = None,
                 rng_seed: int = 0, quant_bits: int | None = None,
                 act_quant: int | None = None, calib_prompts=None,
                 engine: EngineConfig | None = None,
                 kv_dtype="float32", kv_codes: bool = False,
                 chaos: ChaosConfig | ChaosInjector | None = None,
                 telemetry: Telemetry | None = None,
                 worker_name: str = "", worker_id: int = 0,
                 device=None, cuda_graphs: bool = True):
        if not self.supports(cfg):
            raise ValueError(
                f"Engine supports decoder-family models without a frontend; "
                f"got family={cfg.family!r} frontend={cfg.frontend!r}")
        self.device = resolve_device(device)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.cfg = cfg
        self.api = mapi.get_model(cfg)
        self.engine_cfg = ec = engine or EngineConfig()
        if ec.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{ec.prefill_chunk}")
        if ec.shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {ec.shed_policy!r}")
        if ec.role not in ENGINE_ROLES:
            raise ValueError(f"role must be one of {ENGINE_ROLES}, "
                             f"got {ec.role!r}")
        if ec.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (0 disables "
                             f"speculation), got {ec.spec_k}")
        if ec.drift_check_every < 0:
            raise ValueError(f"drift_check_every must be >= 0 (0 "
                             f"disables), got {ec.drift_check_every}")
        self.chaos: ChaosInjector | None = (
            ChaosInjector(chaos) if isinstance(chaos, ChaosConfig) else chaos)
        # the audit detects page corruption: armed whenever chaos can
        # corrupt pages, else by the config
        self._checksum = ec.checksum_pages or (
            self.chaos is not None and self.chaos.cfg.corrupt_rate > 0)
        self.kv_codes = bool(kv_codes)
        # codes mode: pages hold uint8 codes (1 B per element)
        self.kv_dtype = torch.uint8 if self.kv_codes else kv_dtype_of(kv_dtype)
        if params is None:
            params = self.api.init(self.device, seed=rng_seed)
        self.quant_report = None
        if quant_bits is not None:
            qtree, self.quant_report = ll.quantize_tree(
                params.tree(), quant_bits, axes=self.api.logical_axes())
            params = self.api.module(cfg, qtree, device=self.device)
        params = params.to(self.device)
        self.act_report = None
        if act_quant is not None:
            # fit on the weight-quantized model, as served, on its device
            params, self.act_report = cal.calibrate_act_quant(
                self.api, params, cfg, bits=act_quant, prompts=calib_prompts,
                seq_len=min(32, ec.max_seq_len))
        self.params = params
        self._kv_fingerprint: int | None = None
        if self.kv_codes:
            aq = params.tree()["blocks"].get("act_q")
            if not (isinstance(aq, dict) and "attn_k" in aq
                    and "attn_v" in aq):
                raise ValueError(
                    "kv_codes=True requires act_quant bits: the per-head "
                    "K/V code tables come from activation calibration "
                    "(pass act_quant=<bits> or params that already carry "
                    "the calibrated attn_k/attn_v tables)")
            self._kv_fingerprint = cal.kv_tables_fingerprint(aq)

        max_blk = math.ceil(ec.max_seq_len / ec.block_size)
        num_blocks = ec.num_blocks
        if num_blocks is None:
            num_blocks = ec.num_slots * max_blk + 1   # full occupancy + trash
        self.cache = PagedKVCache(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, num_slots=ec.num_slots,
            block_size=ec.block_size, num_blocks=num_blocks,
            max_blocks_per_seq=max_blk, dtype=self.kv_dtype,
            device=self.device)
        self.prefix: PrefixCache | None = (
            PrefixCache(self.cache.allocator, ec.block_size)
            if ec.prefix_cache else None)
        # spec_k = 0 keeps the verify path cold: no drafter, no key
        self.drafter: PromptLookupDrafter | None = (
            PromptLookupDrafter(ec.spec_k, max_ngram=ec.spec_max_ngram,
                                min_ngram=ec.spec_min_ngram)
            if ec.spec_k > 0 else None)

        self._queue: deque[_SeqState] = deque()
        self._slots: list[_SeqState | None] = [None] * ec.num_slots
        self._states: dict[int, _SeqState] = {}
        self._seq_counter = 0

        # telemetry: the counters of _ENGINE_COUNTERS live in the
        # registry (int properties over it, below the class); a cluster
        # hands every worker one bundle, each under its own scope
        self.telemetry = telemetry or Telemetry()
        self.worker_name = worker_name
        self.worker_id = worker_id
        self._scope = self.telemetry.registry.scope(worker_name)
        self.tracer = self.telemetry.tracer
        self._c = {attr: self._scope.counter(key, help=hint)
                   for attr, (key, hint) in _ENGINE_COUNTERS.items()}
        self.tracer.process_name(worker_id, worker_name or "engine")
        self.tracer.process_name(REQUESTS_PID, "requests")
        self.tracer.thread_name(worker_id, SCHED_TID, "scheduler")
        for i in range(ec.num_slots):
            self.tracer.thread_name(worker_id, lane_tid(i), f"slot{i}")
        self.flight = FlightRecorder()
        self.outbox: list[KVHandoff] = []   # prefill role: exports ready
        # port-only, outside the registry: tokens decoded, and the wall
        # time inside prefill / decode dispatches (each ends with the
        # host transfer that waits for the device)
        self.decode_tokens = 0
        self.prefill_dispatch_s = 0.0
        self.decode_dispatch_s = 0.0

        # lifecycle and faults: one monotonic clock for deadlines, the
        # TTFT stamps and the trace (replaceable in tests)
        self._clock = self.telemetry.clock
        self._tick_no = 0
        self._tick_tokens = 0
        self.replay_artifacts: list[dict] = []
        self._quarantined: dict[int, int] = {}   # slot -> release tick
        self._chaos_blocked = False   # an admission faulted this tick
        self._page_crc: dict[int, int] = {}      # page -> CRC32 (audit)
        self.watchdog = StragglerWatchdog(threshold=3.0)
        self.tick_latency = LatencyTracker()
        self._register_gauges()
        if self.chaos is not None:
            self.telemetry.bind_chaos(self.chaos)

        # drift guard: the newest prompt at one fixed length, and the
        # per-site results behind its gauges
        self._drift_probe: np.ndarray | None = None
        self._drift_db: dict[str, float] = {}
        self._drift_delta_db: dict[str, float] = {}
        self._drift_registered: set[str] = set()

        # the step runners, by shape key (and policy): decode (cols,),
        # prefill (chunk width, cols), spec (cols,) at width spec_k + 1;
        # every graph shares one pool, as each replay's output is copied
        # off before the next replay
        self.step_runners: dict[str, dict[tuple, StepGraph]] = {
            "decode": {}, "prefill": {}, "spec": {}}
        self._pool = (torch.cuda.graph_pool_handle() if self.cuda_graphs
                      else None)

    def _register_gauges(self) -> None:
        """Callback gauges over the live state, read when the registry
        is read (a replaced ``watchdog`` or ``tick_latency`` is
        followed).  They hold the engine weakly: the engine owns its
        registry, and a gauge that held it would make a cycle that keeps
        a dropped engine's pools and graphs until a cyclic collection."""
        s, g = self._scope, _weak_reader(self)
        s.gauge("engine.ticks", g(lambda e: e._tick_no),
                help="scheduler ticks run")
        s.gauge("engine.queue.depth", g(lambda e: len(e._queue)),
                help="requests waiting for admission")
        s.gauge("engine.slots.live", g(lambda e: e.live_slots),
                help="occupied decode lanes")
        s.gauge("engine.tick.p50_s",
                g(lambda e: e.tick_latency.percentile(50)))
        s.gauge("engine.tick.p99_s",
                g(lambda e: e.tick_latency.percentile(99)))
        s.gauge("engine.tick.mean_s", g(lambda e: e.tick_latency.mean_s))
        s.gauge("engine.spec.accept_rate",
                g(lambda e: (e.spec_accepted / e.spec_proposed
                             if e.spec_proposed else 0.0)),
                help="drafted tokens accepted / drafted tokens verified")
        self.cache.register_metrics(s)
        if self.prefix is not None:
            for name in ("queries", "hits", "hit_rate", "token_hit_rate",
                         "tokens_reused", "evicted_pages", "cow_copies"):
                s.gauge(f"engine.prefix.{name}",
                        g(lambda e, a=name: getattr(e.prefix.stats, a)))
            s.gauge("engine.prefix.pages", g(lambda e: e.prefix.num_pages))

    # ---------------------------------------------------------------- api
    def submit(self, request: Request) -> int:
        """Enqueue a request; returns its handle (the uid).  With
        ``max_queue`` set, a submit past the bound sheds: ``reject-new``
        makes this request terminal ``rejected`` (its handle still
        answers), ``shed-oldest`` rejects the oldest queued request and
        enqueues this one.  A malformed request raises."""
        if request.uid in self._states:
            raise ValueError(f"duplicate uid {request.uid}")
        plen = len(request.prompt)
        ec = self.engine_cfg
        if plen + request.max_new_tokens > ec.max_seq_len:
            raise ValueError(
                f"request {request.uid}: prompt {plen} + max_new "
                f"{request.max_new_tokens} exceeds max_seq_len "
                f"{ec.max_seq_len}")
        st = _SeqState(request, seq_no=self._seq_counter,
                       submit_t=self._clock())
        st.trace = Trace(request.uid, st.submit_t)
        if ec.drift_check_every and plen:
            # the drift guard probes live traffic: the newest prompt,
            # resized to one length
            self._drift_probe = np.resize(
                np.asarray(request.prompt, np.int32), 32)
        self._seq_counter += 1
        self._states[request.uid] = st
        if ec.max_queue is not None and len(self._queue) >= ec.max_queue:
            self.shed += 1
            if ec.shed_policy == "reject-new":
                st.status, st.term = _FINISHED, ST_REJECTED
                self._finish_trace(st, ST_REJECTED)
                return request.uid
            self._terminate(self._queue[0], ST_REJECTED)  # shed-oldest
        self._queue.append(st)
        return request.uid

    def cancel(self, handle: int) -> bool:
        """Cancel a live request wherever it is -- queued, between
        prefill chunks (its pages freed, its trie pins dropped) or
        mid-decode.  True if it was live (now ``cancelled``, its tokens
        kept), False if terminal already or unknown."""
        st = self._states.get(handle)
        if st is None or st.status == _FINISHED:
            return False
        self._terminate(st, ST_CANCELLED)
        self.cancelled += 1
        return True

    def drain_queue(self, status: str = ST_REJECTED) -> int:
        """Make every queued (not yet admitted) request terminal with
        ``status`` while the running slots keep decoding; returns how
        many."""
        n = 0
        while self._queue:
            self._terminate(self._queue[0], status)
            self.shed += status == ST_REJECTED
            n += 1
        return n

    # -------------------------------------------------- disaggregation
    def inject_prefilled(self, handoff: KVHandoff) -> int:
        """Take a migrated prefill (the decode worker's side of the
        handoff): the request queues with its exported pages, and its
        admission imports them into this pool (``import_slot``) instead
        of prefilling; the slot enters the decode loop at once.  The
        prefill worker's stamps carry over.  Returns the handle (uid)."""
        req = handoff.request
        if req.uid in self._states:
            raise ValueError(f"duplicate uid {req.uid}")
        if handoff.block_size != self.engine_cfg.block_size:
            raise ValueError(
                f"handoff block_size {handoff.block_size} != engine "
                f"block_size {self.engine_cfg.block_size}")
        if handoff.kv_fingerprint != self._kv_fingerprint:
            raise ValueError(
                f"request {req.uid}: handoff KV table fingerprint "
                f"{handoff.kv_fingerprint} != this worker's "
                f"{self._kv_fingerprint} -- codes pages decode only "
                f"under the tables they were encoded with")
        if handoff.length + req.max_new_tokens > self.engine_cfg.max_seq_len:
            raise ValueError(
                f"request {req.uid}: prefilled {handoff.length} + max_new "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.engine_cfg.max_seq_len}")
        st = _SeqState(req, seq_no=self._seq_counter,
                       submit_t=handoff.submit_t)
        self._seq_counter += 1
        st.tokens = list(handoff.tokens)
        if st.tokens:
            st.next_token = st.tokens[-1]
        st.admit_t = handoff.admit_t
        st.first_token_t = handoff.first_token_t
        st.prefill_s = handoff.prefill_s
        st.preemptions = handoff.preemptions
        st.handoff = handoff
        # the trace crossed inside the handoff: stamp the import on the
        # same timeline and close the export's flow arrow
        st.trace, handoff.trace = handoff.trace, None
        if st.trace is not None:
            t = self._clock()
            st.trace.stamp("handoff_import", t,
                           worker=self.worker_name or str(self.worker_id),
                           nbytes=handoff.nbytes)
            self.tracer.flow_end(self.worker_id, SCHED_TID, "kv_handoff",
                                 handoff.flow_id, t, uid=req.uid)
            self.tracer.instant(self.worker_id, SCHED_TID, "handoff_import",
                                t, uid=req.uid)
        self._states[req.uid] = st
        self._queue.append(st)
        return req.uid

    def take_handoffs(self) -> list[KVHandoff]:
        """Drain the prefill role's outbox: every request whose last
        prompt chunk landed since the last call, with its pages.  The
        caller delivers them; a dropped one is submitted again (its
        state left this engine at the export, so the uid is free)."""
        out, self.outbox = self.outbox, []
        return out

    # ------------------------------------------------- crash recovery
    def snapshot(self) -> dict:
        """The request bookkeeping as a JSON-serializable record: each
        request's prompt, tokens so far and stamps, terminal ones with
        their status.  No KV: a crash loses it, and greedy decoding
        re-prefills prompt plus tokens to the same stream."""
        reqs = []
        for st in sorted(self._states.values(), key=lambda s: s.seq_no):
            r = st.request
            reqs.append({
                "uid": int(r.uid),
                "prompt": np.asarray(r.prompt, np.int32).tolist(),
                "max_new_tokens": int(r.max_new_tokens),
                "stop_token": (None if r.stop_token is None
                               else int(r.stop_token)),
                "deadline_s": r.deadline_s,
                "tokens": [int(t) for t in st.tokens],
                "terminal": st.status == _FINISHED,
                "term": st.term,
                "preemptions": st.preemptions,
                "decode_steps": st.decode_steps,
                "submit_t": st.submit_t,
            })
        return {"version": 1, "requests": reqs}

    def restore(self, snap: dict) -> int:
        """Rebuild the bookkeeping of :meth:`snapshot` into this engine,
        which must have no live request: terminal requests keep their
        status, the others re-queue (prompt plus tokens so far; a warm
        trie serves what it holds).  Deadlines keep their submit stamp.
        Returns the number re-queued."""
        if self.pending:
            raise RuntimeError(
                "restore() needs an engine with no live requests: drain "
                "or cancel in-flight work first")
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')}")
        for rec in snap["requests"]:
            if rec["uid"] in self._states:
                raise ValueError(
                    f"snapshot uid {rec['uid']} collides with an "
                    f"uncollected completion; collect() first")
        requeued = 0
        for rec in snap["requests"]:
            req = Request(rec["uid"], np.asarray(rec["prompt"], np.int32),
                          max_new_tokens=rec["max_new_tokens"],
                          stop_token=rec["stop_token"],
                          deadline_s=rec["deadline_s"])
            st = _SeqState(req, seq_no=self._seq_counter,
                           submit_t=rec["submit_t"])
            self._seq_counter += 1
            st.tokens = list(rec["tokens"])
            if st.tokens:
                st.next_token = st.tokens[-1]
            st.preemptions = rec["preemptions"]
            st.decode_steps = rec["decode_steps"]
            self._states[req.uid] = st
            if rec["terminal"]:
                st.status, st.term = _FINISHED, rec["term"]
            else:
                self._queue.append(st)
                requeued += 1
        return requeued

    @property
    def pending(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return len(self._queue)

    @property
    def live_slots(self) -> int:
        """Occupied decode lanes."""
        return sum(s is not None for s in self._slots)

    def step(self) -> list[Completion]:
        """One scheduler tick: expire deadlines, audit the checksums,
        admit, advance prefills by one chunk, decode once, retire.
        Returns the completions of this tick."""
        t_tick = self._clock()
        self._tick_no += 1
        self._tick_tokens = 0         # prefill + decode tokens this tick
        self._chaos_blocked = False
        if self.chaos is not None:
            delay = self.chaos.tick_delay()
            if delay > 0.0:
                time.sleep(delay)
        self._expire_deadlines()
        self._audit_pages()
        ec = self.engine_cfg
        if ec.drift_check_every and self._tick_no % ec.drift_check_every == 0:
            self._drift_check()
        for slot in [s for s, until in self._quarantined.items()
                     if until <= self._tick_no]:
            del self._quarantined[slot]
        self._admit()
        if (self._queue and all(s is None for s in self._slots)
                and not self._chaos_blocked and not self._quarantined):
            raise RuntimeError(
                "no admissible request: head of queue needs more KV "
                "blocks than the pool can ever free")
        finished = self._prefill_tick()
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and s.prefill_done]
        if active:
            finished += self._decode_tick(active)
        # chaos: corrupt one checksummed page at the end of the tick;
        # the next tick's audit must catch it before any dispatch
        if self.chaos is not None and self._page_crc:
            page = self.chaos.corrupt_page(sorted(self._page_crc))
            if page is not None:
                self.cache.corrupt_page(page)
        t_end = self._clock()
        dt_tick = t_end - t_tick
        self.tick_latency.observe(dt_tick)
        if self.watchdog.observe(self._tick_no, dt_tick):
            self.slow_ticks += 1
        # the flight recorder: one small record a tick into a bounded
        # ring, dumped with every replay artifact
        self.flight.record(tick=self._tick_no, t=t_tick, dt_s=dt_tick,
                           queue_depth=len(self._queue),
                           live_slots=self.live_slots,
                           free_pages=self.cache.allocator.free_blocks,
                           finished=len(finished))
        if self.tracer.enabled:
            pid = self.worker_id
            self.tracer.complete(pid, SCHED_TID, "tick", t_tick, t_end,
                                 tick=self._tick_no)
            self.tracer.counter(pid, "queue_depth", t_end,
                                depth=len(self._queue))
            self.tracer.counter(pid, "live_slots", t_end,
                                live=self.live_slots)
            self.tracer.counter(pid, "free_pages", t_end,
                                free=self.cache.allocator.free_blocks)
            if dt_tick > 0:
                self.tracer.counter(pid, "tok_s", t_end,
                                    tok_s=self._tick_tokens / dt_tick)
        return finished

    def stream(self, handle: int) -> Iterator[int]:
        """Yield one request's tokens as they come, driving ``step``."""
        st = self._states.get(handle)
        if st is None:
            raise KeyError(f"unknown or already-collected handle {handle}")
        sent = 0
        while True:
            while sent < len(st.tokens):
                yield st.tokens[sent]
                sent += 1
            if st.status == _FINISHED:
                return
            self.step()

    def result(self, handle: int) -> Completion | None:
        """The completion of a terminal request not yet collected, else
        None."""
        st = self._states.get(handle)
        return st.completion() if st and st.status == _FINISHED else None

    def collect(self) -> list[Completion]:
        """Pop every finished request's completion, sorted by uid."""
        done = [st for st in self._states.values() if st.status == _FINISHED]
        for st in done:
            del self._states[st.request.uid]
        return sorted((st.completion() for st in done), key=lambda c: c.uid)

    def run(self) -> list[Completion]:
        while self.pending:
            self.step()
        return self.collect()

    def generate(self, requests: Sequence[Request]) -> list[Completion]:
        for r in requests:
            self.submit(r)
        return self.run()

    @property
    def prefix_stats(self):
        return self.prefix.stats if self.prefix is not None else None

    def check_partition(self) -> None:
        """Assert the page-partition invariant: free, slot-owned, trie
        and trash pages cover the pool exactly once, with consistent
        refcounts (cheap; tests call it every tick)."""
        if self.prefix is not None:
            self.cache.audit_partition(self.prefix.pages(),
                                       self.prefix.pins())
        else:
            self.cache.audit_partition(set(), {})

    @property
    def metrics(self):
        """This engine's scope of the metrics registry: the one store of
        its counters and gauges."""
        return self._scope

    def fault_stats(self) -> dict:
        """Lifecycle, fault and tick-latency figures (the reference's
        dict, read from the registry), plus the injector's counts."""
        d = {"ticks": self._tick_no,
             "cancelled": self.cancelled,
             "deadline_expired": self.deadline_expired,
             "shed": self.shed,
             "failed": self.failed,
             "starvation_pins": self.starvation_pins,
             "alloc_faults_absorbed": self.alloc_faults_absorbed,
             "nan_rows_detected": self.nan_rows_detected,
             "corruptions_detected": self.corruptions_detected,
             "quarantines": self.quarantines,
             "slow_ticks": self.slow_ticks,
             "tick_p50_s": self.tick_latency.percentile(50),
             "tick_p99_s": self.tick_latency.percentile(99),
             "tick_mean_s": self.tick_latency.mean_s}
        if self.chaos is not None:
            d.update(self.chaos.stats())
        return d

    def graph_captures(self) -> tuple[int, float]:
        """(CUDA graphs captured, seconds spent capturing them)."""
        done = [r for d in self.step_runners.values() for r in d.values()
                if r.graph is not None]
        return len(done), sum(r.capture_s for r in done)

    # ----------------------------------------------------------- tracing
    def _finish_trace(self, st: _SeqState, status: str) -> None:
        """Close a request's trace with its one terminal stamp, archive
        it, and (tracing on) emit its spans on its own row of the
        ``requests`` process: the whole request, and queued / prefill /
        decode inside it."""
        tr = st.trace
        if tr is None:
            return
        st.trace = None
        t = self._clock()
        tr.stamp("terminal", t, status=status)
        tr.status = status
        self.telemetry.finish_trace(tr)
        if not self.tracer.enabled:
            return
        uid = tr.uid
        t_sub = tr.submit_t
        self.tracer.thread_name(REQUESTS_PID, uid, f"req{uid}")
        self.tracer.complete(REQUESTS_PID, uid, "request", t_sub, t,
                             uid=uid, status=status)
        admit, first = st.admit_t, st.first_token_t
        self.tracer.complete(REQUESTS_PID, uid, "queued", t_sub,
                             admit if admit is not None else t, uid=uid)
        if admit is not None:
            self.tracer.complete(REQUESTS_PID, uid, "prefill", admit,
                                 first if first is not None else t, uid=uid)
        if first is not None:
            self.tracer.complete(REQUESTS_PID, uid, "decode", first, t,
                                 uid=uid, tokens=len(st.tokens))

    # ------------------------------------------------------ failure model
    def _terminate(self, st: _SeqState, status: str) -> None:
        """The one transition to a terminal status other than ``ok``,
        from any live state: a running request's owned pages go back to
        the free list and its trie pins drop; a queued one leaves the
        queue.  Its tokens so far stay in its completion."""
        assert status in TERMINAL_STATUSES, status
        if st.status == _RUNNING:
            slot = st.slot
            self._slots[slot] = None
            self.cache.release_slot(slot)
            if self.prefix is not None:
                self.prefix.unpin(st.pinned)
            st.pinned = []
            st.slot = -1
        elif st.status == _QUEUED:
            try:
                self._queue.remove(st)
            except ValueError:
                pass    # mid-submit: not enqueued yet
        st.status, st.term = _FINISHED, status
        self._finish_trace(st, status)

    def _fault(self, st: _SeqState, kind: str) -> None:
        """Fail one request on a detected fault: its replay artifact
        first (a fault stamp naming it lands on the trace), then the
        terminal status."""
        art_name = (f"replay_uid{int(st.request.uid)}_"
                    f"tick{self._tick_no}.json")
        if st.trace is not None:
            st.trace.stamp("fault", self._clock(), kind=kind,
                           artifact=art_name)
        self.tracer.instant(self.worker_id, SCHED_TID, f"fault:{kind}",
                            uid=int(st.request.uid), artifact=art_name)
        self._replay_artifact(st, kind)
        self.failed += 1
        self._terminate(st, ST_FAILED)

    def _quarantine(self, slot: int) -> None:
        """Rest a lane after a non-finite dispatch: admission skips it
        until the release tick."""
        self._quarantined[slot] = (self._tick_no
                                   + self.engine_cfg.quarantine_ticks)
        self.quarantines += 1

    def _replay_artifact(self, st: _SeqState, kind: str) -> None:
        art = {"kind": kind,
               "tick": self._tick_no,
               "uid": int(st.request.uid),
               "prompt": np.asarray(st.request.prompt, np.int32).tolist(),
               "tokens": [int(t) for t in st.tokens],
               "seq_no": st.seq_no,
               "preemptions": st.preemptions,
               "chaos": None if self.chaos is None else self.chaos.stats(),
               # the last ticks of this engine, and the request's stamps
               "flight_recorder": self.flight.dump(),
               "trace": None if st.trace is None else st.trace.to_dict()}
        self.replay_artifacts.append(art)
        rd = self.engine_cfg.replay_dir
        if rd:
            os.makedirs(rd, exist_ok=True)
            path = os.path.join(rd, f"replay_uid{art['uid']}_"
                                    f"tick{art['tick']}.json")
            with open(path, "w") as f:
                json.dump(art, f)

    def _expire_deadlines(self) -> None:
        """Requests past their deadline go terminal wherever they are."""
        now = self._clock()
        for st in list(self._states.values()):
            d = st.request.deadline_s
            if (d is not None and st.status != _FINISHED
                    and now - st.submit_t > d):
                self._terminate(st, ST_DEADLINE)
                self.deadline_expired += 1

    def _record_crcs(self, pages) -> None:
        """Record the checksums of pages a dispatch wrote (in order)."""
        for page, crc in zip(pages, self.cache.page_checksums(pages)):
            self._page_crc[page] = crc

    def _audit_pages(self) -> None:
        """Verify the recorded page checksums before this tick's
        dispatches (all pages in one transfer).  A mismatch fails every
        sequence whose table holds the page; a cached page drops its
        trie subtree (whose prefixes run through it)."""
        if not self._checksum or not self._page_crc:
            return
        live: set[int] = set()
        for i, st in enumerate(self._slots):
            if st is not None:
                live.update(self.cache.slot_blocks[i])
        trie_pages = (self.prefix.pages() if self.prefix is not None
                      else set())
        live |= trie_pages
        for page in [p for p in self._page_crc if p not in live]:
            del self._page_crc[page]    # freed since recorded
        recorded = list(self._page_crc.items())
        now = self.cache.page_checksums([p for p, _ in recorded])
        for (page, crc), cur in zip(recorded, now):
            if cur == crc:
                continue
            self.corruptions_detected += 1
            for i, st in enumerate(list(self._slots)):
                if st is not None and page in self.cache.slot_blocks[i]:
                    self._fault(st, "kv_corruption")
            if self.prefix is not None and page in trie_pages:
                for freed in self.prefix.drop_subtree(page):
                    self._page_crc.pop(freed, None)
            self._page_crc.pop(page, None)

    def _drift_check(self) -> None:
        """The calibration drift guard: re-measure each act-quant site's
        round-trip SQNR on a live prompt under the attached tables and
        compare with the calibration report's mean.  A site more than
        ``drift_threshold_db`` below it warns and counts in
        ``drift_warnings``; refitting stays manual.  The results back
        the ``calib.drift.<site>_db`` / ``_delta_db`` gauges, registered
        on first sight."""
        aq = self.params.tree()["blocks"].get("act_q")
        if (not isinstance(aq, dict) or self._drift_probe is None
                or self.api.collect_act_calibration is None):
            return
        probe = torch.as_tensor(self._drift_probe[None, :], device=self.device)
        with torch.no_grad():
            samples = self.api.collect_act_calibration(self.params, probe,
                                                       self.cfg)
        cur = cal.measure_sqnr(samples, aq)
        ref = cal.report_means(self.act_report)
        self.drift_checks += 1
        thr = self.engine_cfg.drift_threshold_db
        for site, db in cur.items():
            self._drift_db[site] = db
            delta = db - ref[site] if site in ref else 0.0
            self._drift_delta_db[site] = delta
            if site not in self._drift_registered:
                self._drift_registered.add(site)
                g = _weak_reader(self)
                self._scope.gauge(
                    f"calib.drift.{site}_db",
                    g(lambda e, s=site: e._drift_db.get(s, 0.0)),
                    help="serving-time round-trip SQNR at this site")
                self._scope.gauge(
                    f"calib.drift.{site}_delta_db",
                    g(lambda e, s=site: e._drift_delta_db.get(s, 0.0)),
                    help="serving SQNR minus the calibration-report mean")
            if site in ref and delta < -thr:
                self.drift_warnings += 1
                warnings.warn(
                    f"calibration drift at {site}: serving SQNR "
                    f"{db:.1f} dB is {-delta:.1f} dB below the "
                    f"calibration report ({ref[site]:.1f} dB) -- "
                    f"consider refitting the act-quant tables")

    # ---------------------------------------------------------- scheduler
    def _free_slot(self) -> int | None:
        """The lowest free lane that is not quarantined."""
        for i, s in enumerate(self._slots):
            if s is None and i not in self._quarantined:
                return i
        return None

    def _should_stop(self, st: _SeqState) -> bool:
        r = st.request
        return (len(st.tokens) >= r.max_new_tokens
                or (r.stop_token is not None
                    and st.tokens[-1] == r.stop_token))

    def _retire(self, slot: int) -> Completion:
        """Finish a sequence.  With the prefix cache on, its pages go
        into the trie (keyed by the tokens they hold) instead of back to
        the free list."""
        st = self._slots[slot]
        self._slots[slot] = None
        if self.prefix is None:
            self.cache.release_slot(slot)
        else:
            content = st.full_prompt()[:int(self.cache.lengths[slot])]
            shared = set(self.cache.slot_shared[slot])
            blocks = self.cache.clear_slot(slot)
            self.prefix.insert(content, blocks, shared)
            self.prefix.unpin(st.pinned)
            st.pinned = []
        st.status = _FINISHED
        self._finish_trace(st, st.term)
        return st.completion()

    def _export_handoff(self, slot: int, st: _SeqState) -> None:
        """Prefill role: the request's last chunk landed -- copy its KV
        pages out for migration, retire the slot (its pages go into the
        trie, warm for the next shared prefix and for a cheap re-prefill
        if the handoff drops) and drop the request's state: the handoff
        owns it now, and the uid is free for a re-queue."""
        length = int(self.cache.lengths[slot])
        k, v = self.cache.export_slot(slot)
        h = KVHandoff(request=st.request, tokens=list(st.tokens),
                      length=length, k_pages=k, v_pages=v,
                      block_size=self.engine_cfg.block_size,
                      submit_t=st.submit_t, admit_t=st.admit_t,
                      first_token_t=st.first_token_t,
                      prefill_s=st.prefill_s, preemptions=st.preemptions,
                      kv_fingerprint=self._kv_fingerprint)
        # the trace moves into the handoff before the retire: the request
        # goes on elsewhere, so no terminal span here; a flow arrow ties
        # the two workers' timelines (closed at the import, or where a
        # migration fault drops it)
        h.trace, st.trace = st.trace, None
        if h.trace is not None:
            t = self._clock()
            h.flow_id = self.tracer.next_flow_id()
            h.trace.stamp("handoff_export", t,
                          worker=self.worker_name or str(self.worker_id),
                          nbytes=h.nbytes)
            self.tracer.flow_start(self.worker_id, SCHED_TID, "kv_handoff",
                                   h.flow_id, t, uid=int(st.request.uid))
            self.tracer.instant(self.worker_id, SCHED_TID, "handoff_export",
                                t, uid=int(st.request.uid))
        self._retire(slot)
        del self._states[st.request.uid]
        self.outbox.append(h)
        self.handoffs += 1
        self.handoff_bytes += h.nbytes

    def _preempt(self, slot: int) -> None:
        """Release a running sequence's pages and re-queue it at the
        front; prompt plus tokens so far re-prefill on re-admission."""
        st = self._slots[slot]
        self._slots[slot] = None
        self.cache.release_slot(slot)
        if self.prefix is not None:
            self.prefix.unpin(st.pinned)
        st.pinned = []
        st.prefix_len = 0
        st.prefill_pos = 0
        st.prefill_done = False
        st.slot = -1
        st.status = _QUEUED
        st.preemptions += 1
        if st.trace is not None:
            st.trace.stamp("preempt", self._clock(), n=st.preemptions)
        self.preemptions += 1
        if st.preemptions == self.engine_cfg.max_preemptions:
            # the starvation guard: no longer a victim of _make_room
            self.starvation_pins += 1
        self._queue.appendleft(st)

    def _make_room(self, need: int, seq_no: int, *,
                   allow_preempt: bool = True) -> bool:
        """The eviction ladder until ``need`` pages are free: evict
        unpinned trie pages (LRU leaves first), then preempt the youngest
        running sequence submitted after ``seq_no`` (never one preempted
        ``max_preemptions`` times).  False if that cannot be done."""
        alloc = self.cache.allocator
        while alloc.free_blocks < need:
            if (self.prefix is not None
                    and self.prefix.evict(need - alloc.free_blocks)):
                continue
            if not allow_preempt:
                return False
            victim = None
            for st in self._slots:
                if (st is not None and st.seq_no > seq_no
                        and st.preemptions < self.engine_cfg.max_preemptions
                        and (victim is None or st.seq_no > victim.seq_no)):
                    victim = st
            if victim is None:
                return False
            self._preempt(victim.slot)
        return True

    def _grow(self, slot: int) -> None:
        """Allocate the next page iff this tick's write crosses a block
        boundary; under pressure preempt (as a last resort *this*
        sequence) rather than fail."""
        st = self._slots[slot]
        pos = int(self.cache.lengths[slot])
        if pos == len(self.cache.slot_blocks[slot]) * self.engine_cfg.block_size:
            # chaos: the growth allocation fails -- preempt this
            # sequence (its recompute gives the same tokens)
            if self.chaos is not None and self.chaos.alloc_fault():
                self.alloc_faults_absorbed += 1
                self._chaos_blocked = True
                self._preempt(slot)
                return
            if not self._make_room(1, st.seq_no):
                if any(s is not None and s is not st for s in self._slots):
                    self._preempt(slot)
                    return
                raise RuntimeError(
                    f"KV pool too small: sequence {st.request.uid} cannot "
                    f"grow past {pos} tokens and nothing is evictable")
            self.cache.ensure_capacity(slot, reserved=False)
        # decode never writes a shared page: the boundary page was
        # copied at admission, later pages are fresh allocations
        page = self.cache.block_tables[slot, pos // self.engine_cfg.block_size]
        assert page not in self.cache.slot_shared[slot], (slot, pos, page)

    @staticmethod
    def _pow2(n: int) -> int:
        return 1 << max(0, math.ceil(math.log2(max(n, 1))))

    def _live_cols(self, active) -> int:
        """Block-table columns the decode step needs (every live cache
        plus this tick's write), rounded up a pow2 ladder."""
        need = max(int(self.cache.lengths[i]) // self.engine_cfg.block_size
                   + 1 for i, _ in active)
        return min(self._pow2(need), self.cache.max_blocks_per_seq)

    def _chunk_width(self, remaining: int) -> int:
        """This tick's prefill chunk width: the largest remaining tail
        rounded up a pow2 ladder (block-size multiples), capped at
        ``prefill_chunk``."""
        bs = self.engine_cfg.block_size
        padded = math.ceil(max(self._pow2(remaining), 8) / bs) * bs
        cap = min(self.engine_cfg.prefill_chunk,
                  self.cache.max_blocks_per_seq * bs)
        return max(min(padded, cap), 1)

    def _trie_match(self, st: _SeqState):
        """The request's trie match, kept across ticks while the trie's
        structure (``PrefixCache.generation``) and the request's prompt
        length stay the same; a kept match counts in
        ``trie_match_reuses``."""
        prompt = st.full_prompt()
        mc = st.match_cache
        gen = self.prefix.generation
        if mc is not None and mc[0] == gen and mc[1] == len(prompt):
            self.trie_match_reuses += 1
            return mc[2]
        match = self.prefix.match(prompt)
        st.match_cache = (gen, len(prompt), match)
        return match

    def _try_place(self, st: _SeqState, *, allow_preempt: bool = True,
                   match: tuple | None = None) -> bool:
        """Match the trie, size the tail, and commit: pin the prefix,
        make room (evict, then preempt), splice the block table, copy the
        boundary page.  The sequence enters with ``prefill_done=False``;
        the chunk scheduler advances it.  ``match`` is a trie match made
        already (``(nodes, tokens)``).  False when the pages cannot be
        freed."""
        prompt = st.full_prompt()
        plen = len(prompt)
        bs = self.engine_cfg.block_size
        need_total = self.cache.blocks_for(plen)
        if need_total > self.cache.max_blocks_per_seq:
            raise RuntimeError(
                f"request {st.request.uid} needs {need_total} blocks > "
                f"max_blocks_per_seq {self.cache.max_blocks_per_seq}")
        nodes: list[PrefixNode] = []
        prefix_len = 0
        if self.prefix is not None:
            matched, mtokens = (match if match is not None
                                else self.prefix.match(prompt))
            # tokens each node covers: whole pages, except maybe the last
            contribs = [len(nd.key) for nd in matched]
            if matched:
                contribs[-1] = mtokens - sum(contribs[:-1])
            # reuse stops at plen - 1: the last prompt token is always
            # computed, so its logits exist to sample from
            allowed, cum = plen - 1, 0
            for nd, contrib in zip(matched, contribs):
                if cum >= allowed:
                    break
                nodes.append(nd)
                cum += contrib
            prefix_len = min(cum, allowed)
        first_write_col = prefix_len // bs
        cow = first_write_col < len(nodes)
        need = need_total - len(nodes) + (1 if cow else 0)
        if self.prefix is not None:
            self.prefix.pin(nodes)      # safe from eviction in _make_room
        # chaos: the allocation fails -- the request stays queued
        if (need > 0 and self.chaos is not None
                and self.chaos.alloc_fault()):
            if self.prefix is not None:
                self.prefix.unpin(nodes)
            self.alloc_faults_absorbed += 1
            self._chaos_blocked = True
            return False
        if not self._make_room(need, st.seq_no, allow_preempt=allow_preempt):
            if self.prefix is not None:
                self.prefix.unpin(nodes)
            return False
        if self.prefix is not None:     # committed admissions only
            stats = self.prefix.stats
            stats.queries += 1
            stats.hits += bool(nodes)
            stats.tokens_reused += prefix_len
            stats.tokens_missed += plen - prefix_len
        slot = self._free_slot()
        self.cache.bind_slot(slot, plen, [nd.page for nd in nodes],
                             reserved=False)
        if cow:
            # the tail writes into the last matched page: copy it, and
            # drop the pin on the original (the copy holds the KV now)
            self.cache.cow_slot_page(slot, first_write_col)
            self.prefix.stats.cow_copies += 1
            self.prefix.unpin([nodes.pop(first_write_col)])
        st.slot, st.status = slot, _RUNNING
        st.pinned = nodes
        st.prefix_len = prefix_len
        st.prefill_pos = 0
        st.prefill_done = False
        if st.admit_t is None:
            st.admit_t = self._clock()
            if st.trace is not None:
                st.trace.stamp("admit", st.admit_t, slot=slot,
                               prefix_len=prefix_len)
        self._slots[slot] = st
        return True

    def _admit(self) -> None:
        """FIFO admission of up to ``max_batched_prefill`` queue heads;
        when the head cannot get its pages, prefix hits among the next
        waiting requests go first (``_admit_reordered``)."""
        admitted = 0
        while (self._queue and self._free_slot() is not None
               and admitted < self.engine_cfg.max_batched_prefill):
            # pop before placing: _try_place may preempt a victim onto
            # the queue front
            st = self._queue.popleft()
            if st.handoff is not None:
                if self._place_import(st):
                    admitted += 1
                    continue
                self._queue.appendleft(st)  # wait for pages
                break
            match = self._trie_match(st) if self.prefix is not None else None
            if self._try_place(st, match=match):
                admitted += 1
                continue
            self._queue.appendleft(st)    # head-of-line: wait for pages
            self._admit_reordered(
                self.engine_cfg.max_batched_prefill - admitted)
            break

    def _place_import(self, st: _SeqState) -> bool:
        """Admit a migrated prefill: make room for its pages, scatter the
        handoff's KV into this pool and enter the decode loop directly
        (``prefill_done`` from the first tick).  False when the pages
        cannot be freed (the import waits)."""
        h = st.handoff
        need = self.cache.blocks_for(h.length)
        if need > self.cache.max_blocks_per_seq:
            raise RuntimeError(
                f"request {st.request.uid} needs {need} blocks > "
                f"max_blocks_per_seq {self.cache.max_blocks_per_seq}")
        # chaos: the import's allocation fails -- the handoff waits a
        # tick (latency, never tokens)
        if self.chaos is not None and self.chaos.alloc_fault():
            self.alloc_faults_absorbed += 1
            self._chaos_blocked = True
            return False
        if not self._make_room(need, st.seq_no):
            return False
        slot = self._free_slot()
        blocks = self.cache.import_slot(slot, h.length, h.k_pages, h.v_pages)
        st.slot, st.status = slot, _RUNNING
        st.prefix_len = 0
        st.prefill_pos = h.length
        st.prefill_done = True
        if st.admit_t is None:
            st.admit_t = self._clock()
        if st.trace is not None:
            st.trace.stamp("import_admit", self._clock(), slot=slot)
        self._slots[slot] = st
        self.imported_handoffs += 1
        self.imported_bytes += h.nbytes
        st.handoff = None       # adopted: the host copy can go
        if self._checksum:
            self._record_crcs(blocks)
        return True

    def _admit_reordered(self, budget: int) -> None:
        """The queue head is blocked on pages: scan the next four waiting
        requests and admit prefix-cache hits, whose spliced pages shrink
        their need.  These admissions never preempt, so a failed one
        leaves the queue as it was; ``budget`` is what is left of the
        tick's ``max_batched_prefill``."""
        if self.prefix is None:
            return
        idx, scanned = 1, 0
        while (idx < len(self._queue) and scanned < 4 and budget > 0
               and self._free_slot() is not None):
            st = self._queue[idx]
            scanned += 1
            match = self._trie_match(st)
            if match[1] == 0:
                idx += 1
                continue
            del self._queue[idx]
            if self._try_place(st, allow_preempt=False, match=match):
                self.admission_reorders += 1
                budget -= 1             # the next candidate is now at idx
            else:
                self._queue.insert(idx, st)
                idx += 1

    def _attn_accounting(self, q_tokens: int, kv_tokens: int) -> None:
        """Analytic attention traffic of one dispatched row: the bytes
        the attention kernel reads (q and the touched KV pages), the
        activation bytes crossing the boundary (q in, context out: 1 B
        per element as codes, 4 as float32) and the elements decoded in
        the kernel (codes mode)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        bs = self.engine_cfg.block_size
        act_item = 1 if self.kv_codes else 4
        q_bytes = q_tokens * cfg.num_heads * hd * act_item
        blocks = -(-kv_tokens // bs)
        kv_elems = blocks * bs * cfg.num_kv_heads * hd * 2
        self.attn_bytes_read += q_bytes + kv_elems * self.kv_dtype.itemsize
        self.attn_act_bytes += 2 * q_bytes
        if self.kv_codes:
            self.attn_dequants += q_tokens * cfg.num_heads * hd + kv_elems

    def _runner(self, kind: str, key: tuple, inputs) -> StepGraph:
        """The step runner of ``kind`` at ``key`` under the current
        policy (a capture bakes the policy in), made on first use."""
        key = (*key, ll.get_policy())
        runners = self.step_runners[kind]
        if key not in runners:
            runners[key] = StepGraph(inputs, self.device,
                                     graphs=self.cuda_graphs, pool=self._pool)
        return runners[key]

    def _prefill_step(self, v: dict) -> torch.Tensor:
        logits, _ = self.api.prefill_into_cache(
            self.params, v["tokens"], self.cache.bind(v["table"], v["lengths"]),
            self.cfg, v["start"])
        return _greedy(logits)

    def _spec_step(self, v: dict) -> torch.Tensor:
        greedy, accept, ok, _ = self.api.spec_verify_into_cache(
            self.params, v["tokens"], self.cache.bind(v["table"], v["lengths"]),
            self.cfg, v["start"], v["n_tok"])
        return torch.cat([greedy.to(torch.int32),
                          accept[:, None].to(torch.int32),
                          ok[:, None].to(torch.int32)], 1)

    def _decode_step(self, v: dict) -> torch.Tensor:
        logits, _ = self.api.decode_step_paged(
            self.params, self.cache.bind(v["table"], v["lengths"]),
            v["tokens"], v["mask"] != 0, self.cfg)
        return _greedy(logits)

    # ------------------------------------------------------ chunk prefill
    def _prefill_tick(self) -> list[Completion]:
        """Advance every prefilling slot by one chunk in ONE full-width
        dispatch; decoding or empty rows ride along with a zero-length
        slice (start = length: nothing written, nothing attended)."""
        pref = [(i, st) for i, st in enumerate(self._slots)
                if st is not None and not st.prefill_done]
        if not pref:
            return []
        ec = self.engine_cfg
        bs = ec.block_size
        remaining = max(len(st.full_prompt()) - st.prefix_len - st.prefill_pos
                        for _, st in pref)
        w = self._chunk_width(remaining)
        takes: dict[int, int] = {}
        cols_need = 1
        for i, st in pref:
            s0 = st.prefix_len + st.prefill_pos
            takes[i] = min(w, len(st.full_prompt()) - s0)
            cols_need = max(cols_need, -(-(s0 + takes[i]) // bs))
        self.prefill_batches += 1
        cols = min(self._pow2(cols_need), self.cache.max_blocks_per_seq)
        b = ec.num_slots
        run = self._runner("prefill", (w, cols),
                           {"table": (b, cols), "lengths": (b,),
                            "start": (b,), "tokens": (b, w)})

        t0 = self._clock()
        h = run.host
        self.cache.fill(h["table"], h["lengths"])
        h["start"][:] = h["lengths"]
        h["tokens"][:] = 0
        for i, st in pref:
            s0, take = st.prefix_len + st.prefill_pos, takes[i]
            h["tokens"][i, :take] = st.full_prompt()[s0:s0 + take]
            h["start"][i] = s0
            self.prefill_tokens_computed += take
            self._tick_tokens += take
            self._attn_accounting(take, s0 + take)
        nxt, ok = run.run(self._prefill_step)
        t1 = self._clock()
        dt = t1 - t0
        self.prefill_dispatch_s += dt
        run.capture(self._prefill_step)

        # the pages each row wrote, taken before a retire or a fault
        # changes the tables
        row_pages: dict[int, list[int]] = {}
        if self._checksum:
            for i, st in pref:
                s0 = st.prefix_len + st.prefill_pos
                if takes[i]:
                    row_pages[i] = [
                        int(self.cache.block_tables[i, c])
                        for c in range(s0 // bs, (s0 + takes[i] - 1) // bs + 1)]
        # only rows completing their prompt consume the logits
        completing = [i for i, st in pref
                      if st.prefix_len + st.prefill_pos + takes[i]
                      >= len(st.full_prompt())
                      and st.request.max_new_tokens > 0]
        if self.chaos is not None:
            bad = self.chaos.nan_slot(completing)
            if bad is not None:
                ok[bad] = 0         # the path a device NaN takes
        finished: list[Completion] = []
        faulted: set[int] = set()
        for i, st in pref:
            st.prefill_s += dt      # coalesced rows share the stamp
            st.prefill_pos += takes[i]
            if self.tracer.enabled and takes[i]:
                self.tracer.complete(self.worker_id, lane_tid(i),
                                     "prefill_chunk", t0, t1,
                                     uid=st.request.uid, tokens=takes[i])
                if st.trace is not None:
                    st.trace.stamp("prefill_chunk", t1, slot=i,
                                   tokens=takes[i])
            if st.prefix_len + st.prefill_pos < len(st.full_prompt()):
                continue            # more chunks to go
            if i in completing and not ok[i]:
                # non-finite logits: fail this request, rest the lane
                self.nan_rows_detected += 1
                self._quarantine(i)
                self._fault(st, "nan_logits")
                faulted.add(i)
                continue
            st.prefill_done = True
            r = st.request
            if r.max_new_tokens > 0 and len(st.tokens) < r.max_new_tokens:
                st.tokens.append(int(nxt[i]))
                st.next_token = st.tokens[-1]
            if st.first_token_t is None and st.tokens:
                st.first_token_t = self._clock()
                if st.trace is not None:
                    st.trace.stamp("first_token", st.first_token_t)
            if self._should_stop(st):
                finished.append(self._retire(i))
            elif ec.role == "prefill":
                # this worker's part ends at the first token: export
                self._export_handoff(i, st)
        if row_pages:   # a faulted row's pages were freed
            self._record_crcs([p for i, pages in row_pages.items()
                               if i not in faulted for p in pages])
        return finished

    # ------------------------------------------------------------- decode
    def _decode_tick(self, active) -> list[Completion]:
        # grow oldest first, so page pressure falls on the youngest
        for i, st in sorted(active, key=lambda t: t[1].seq_no):
            if self._slots[i] is st:     # not preempted earlier this tick
                self._grow(i)
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and s.prefill_done]
        if not active:
            return []
        if self.drafter is not None:
            # one verify dispatch when any slot has a proposal; else the
            # vanilla step, so a stream with nothing to draft pays nothing
            drafts = self._draft(active)
            if drafts:
                return self._spec_tick(active, drafts)
        b = self.engine_cfg.num_slots
        cols = self._live_cols(active)
        run = self._runner("decode", (cols,),
                           {"table": (b, cols), "lengths": (b,),
                            "tokens": (b, 1), "mask": (b,)})

        t0 = self._clock()
        h = run.host
        self.cache.fill(h["table"], h["lengths"])
        h["tokens"][:] = 0
        h["mask"][:] = 0
        for i, st in active:
            h["tokens"][i, 0] = st.next_token
            h["mask"][i] = 1
            self._attn_accounting(1, int(self.cache.lengths[i]) + 1)
        nxt, ok = run.run(self._decode_step)
        t1 = self._clock()
        dt = t1 - t0
        self.decode_dispatch_s += dt
        run.capture(self._decode_step)
        self.total_decode_steps += 1
        if self.chaos is not None:
            bad = self.chaos.nan_slot([i for i, _ in active])
            if bad is not None:
                ok[bad] = 0         # the path a device NaN takes
        bs = self.engine_cfg.block_size
        written: list[int] = []     # the page each row wrote, for the audit
        finished: list[Completion] = []
        for i, st in active:
            if not ok[i]:
                # non-finite logits: fail this request, rest the lane,
                # keep the batch running
                self.nan_rows_detected += 1
                self._quarantine(i)
                self._fault(st, "nan_logits")
                continue
            pos = int(self.cache.lengths[i])
            self.cache.lengths[i] = pos + 1
            st.decode_steps += 1
            st.decode_s += dt
            tok = int(nxt[i])
            st.tokens.append(tok)
            st.next_token = tok
            self.decode_tokens += 1
            self._tick_tokens += 1
            if self.tracer.enabled:
                self.tracer.complete(self.worker_id, lane_tid(i), "decode",
                                     t0, t1, uid=st.request.uid, token=tok)
                if st.trace is not None:
                    st.trace.stamp("decode_tick", t1, slot=i)
            if self._checksum:
                written.append(int(self.cache.block_tables[i, pos // bs]))
            if self._should_stop(st):
                finished.append(self._retire(i))
        if written:
            self._record_crcs(written)
        return finished

    # ------------------------------------------------- speculative decode
    def _draft(self, active) -> dict[int, np.ndarray]:
        """Each slot's prompt-lookup proposal for this tick, clamped so
        that a fully accepted window fits the request's budget (accept +
        1 committed tokens) and the pages the slot owns: speculation
        allocates no page vanilla decode would not (``_grow`` ran, so
        one free position is there)."""
        ec = self.engine_cfg
        drafts: dict[int, np.ndarray] = {}
        for i, st in active:
            budget = st.request.max_new_tokens - len(st.tokens) - 1
            pos = int(self.cache.lengths[i])
            cap = len(self.cache.slot_blocks[i]) * ec.block_size - pos - 1
            k = min(ec.spec_k, budget, cap)
            if k < 1:
                continue
            d = self.drafter.propose(st.full_prompt(), k=k)
            if len(d):
                drafts[i] = d
        return drafts

    def _spec_tick(self, active, drafts) -> list[Completion]:
        """One verify dispatch over every decoding slot: a drafted row
        scores its next token and its proposals, a draftless row rides
        along with a one-token window, any other row is parked (no valid
        token).  A row commits ``drafts[:accept]`` and the model's token
        at the first divergence -- what vanilla steps would have
        produced -- cut after a stop token; ``lengths`` advances over
        the committed tokens only, and the rejected tail's K/V is masked
        out of every later attend until overwritten."""
        ec = self.engine_cfg
        bs = ec.block_size
        b, width = ec.num_slots, ec.spec_k + 1
        cols_need = 1
        for i, st in active:
            n = 1 + len(drafts.get(i, ()))
            cols_need = max(cols_need,
                            -(-(int(self.cache.lengths[i]) + n) // bs))
        cols = min(self._pow2(cols_need), self.cache.max_blocks_per_seq)
        run = self._runner("spec", (cols,),
                           {"table": (b, cols), "lengths": (b,),
                            "start": (b,), "n_tok": (b,),
                            "tokens": (b, width)})

        t0 = self._clock()
        h = run.host
        self.cache.fill(h["table"], h["lengths"])
        h["start"][:] = h["lengths"]      # parked rows: nothing valid
        h["n_tok"][:] = 0
        h["tokens"][:] = 0
        pre_pos: dict[int, int] = {}
        for i, st in active:
            d = drafts.get(i)
            n = 1 + (len(d) if d is not None else 0)
            h["tokens"][i, 0] = st.next_token
            if d is not None:
                h["tokens"][i, 1:n] = d
                self.spec_proposed += len(d)
            h["n_tok"][i] = n
            pre_pos[i] = int(self.cache.lengths[i])
            self._attn_accounting(n, pre_pos[i] + n)
        out = run.run(self._spec_step)
        t1 = self._clock()
        dt = t1 - t0
        self.decode_dispatch_s += dt
        run.capture(self._spec_step)
        self.total_decode_steps += 1
        self.spec_dispatches += 1
        greedy, acc, ok = out[:, :width], out[:, width], out[:, width + 1]
        if self.chaos is not None:
            bad = self.chaos.nan_slot([i for i, _ in active])
            if bad is not None:
                ok[bad] = 0         # the path a device NaN takes
        written: list[int] = []     # the pages each window wrote
        finished: list[Completion] = []
        for i, st in active:
            if not ok[i]:
                self.nan_rows_detected += 1
                self._quarantine(i)
                self._fault(st, "nan_logits")
                continue
            d = drafts.get(i)
            a = int(acc[i]) if d is not None else 0
            self.spec_accepted += a
            committed = [int(t) for t in (d[:a] if d is not None else ())]
            committed.append(int(greedy[i, a]))
            stop = st.request.stop_token
            if stop is not None and stop in committed:
                # vanilla stops AT the stop token: drop what follows it
                committed = committed[:committed.index(stop) + 1]
            st.decode_steps += 1
            st.decode_s += dt
            st.tokens.extend(committed)
            st.next_token = committed[-1]
            # the commit is the rewind: only committed positions count
            self.cache.lengths[i] = pre_pos[i] + len(committed)
            self.decode_tokens += len(committed)
            self._tick_tokens += len(committed)
            if self.tracer.enabled:
                self.tracer.complete(self.worker_id, lane_tid(i),
                                     "spec_decode", t0, t1,
                                     uid=st.request.uid,
                                     tokens=len(committed), accepted=a)
                if st.trace is not None:
                    st.trace.stamp(
                        "spec_verify", t1, slot=i, accepted=a,
                        proposed=(len(d) if d is not None else 0))
            if self._checksum:
                # every page the window wrote, accepted or not: the
                # rejected tail's bytes stay until overwritten
                n = int(h["n_tok"][i])
                written.extend(int(self.cache.block_tables[i, c]) for c in
                               range(pre_pos[i] // bs,
                                     (pre_pos[i] + n - 1) // bs + 1))
            if self._should_stop(st):
                finished.append(self._retire(i))
        if written:
            self._record_crcs(written)
        return finished


def _weak_reader(obj):
    """Wrap ``fn(obj)`` as a gauge callback that holds ``obj`` weakly
    (it reads 0 once ``obj`` is gone, as a shared registry may outlive
    it)."""
    ref = weakref.ref(obj)

    def reader(fn):
        def read():
            o = ref()
            return 0 if o is None else fn(o)
        return read
    return reader


# The engine's counters live in the metrics registry, under the
# reference's keys; the attribute names stay, as int properties over the
# registered Counter.
_ENGINE_COUNTERS = {
    "total_decode_steps":
        ("engine.decode.steps", "batched decode dispatches run"),
    "prefill_tokens_computed":
        ("engine.prefill.tokens", "prompt tokens actually computed"),
    "prefill_batches":
        ("engine.prefill.chunks", "chunked prefill dispatches issued"),
    "preemptions":
        ("engine.sched.preemptions", "sequences preempted for pages"),
    "admission_reorders":
        ("engine.sched.reorders", "prefix hits admitted past a blocked head"),
    "trie_match_reuses":
        ("engine.sched.trie_reuses", "memoized trie matches served"),
    "starvation_pins":
        ("engine.sched.starvation_pins", "sequences pinned by the guard"),
    "handoffs":
        ("engine.handoff.exported", "prefill role: requests exported"),
    "handoff_bytes":
        ("engine.handoff.exported_bytes", "KV bytes copied out for migration"),
    "imported_handoffs":
        ("engine.handoff.imported", "decode role: migrations admitted"),
    "imported_bytes":
        ("engine.handoff.imported_bytes", "KV bytes scattered into this pool"),
    "cancelled":
        ("engine.lifecycle.cancelled", "Engine.cancel() terminations"),
    "deadline_expired":
        ("engine.lifecycle.deadline_expired", "deadline_s budgets blown"),
    "shed":
        ("engine.lifecycle.shed", "backpressure rejections"),
    "failed":
        ("engine.lifecycle.failed", "NaN/corruption terminations"),
    "alloc_faults_absorbed":
        ("engine.faults.alloc_absorbed", "injected alloc failures survived"),
    "nan_rows_detected":
        ("engine.faults.nan_rows", "non-finite logits rows quarantined"),
    "corruptions_detected":
        ("engine.faults.corruptions", "CRC mismatches caught"),
    "attn_bytes_read":
        ("engine.attn.bytes_read", "attention kernel input bytes "
                                   "(q + KV pages), analytic"),
    "attn_act_bytes":
        ("engine.attn.bytes_act", "activation bytes crossing the "
                                  "attention boundary (q in, ctx out)"),
    "attn_dequants":
        ("engine.attn.dequants", "elements LUT-decoded inside the "
                                 "attention kernels (codes mode)"),
    "slow_ticks":
        ("engine.faults.slow_ticks", "watchdog-flagged scheduler ticks"),
    "quarantines":
        ("engine.faults.quarantines", "slot lanes rested after a fault"),
    "spec_dispatches":
        ("engine.spec.dispatches", "speculative verify dispatches run"),
    "spec_proposed":
        ("engine.spec.proposed", "drafted tokens sent for verification"),
    "spec_accepted":
        ("engine.spec.accepted", "drafted tokens accepted by greedy "
                                 "verification"),
    "drift_checks":
        ("calib.drift.checks", "drift-guard SQNR probes run"),
    "drift_warnings":
        ("calib.drift.warnings", "site probes past drift_threshold_db"),
}


def _install_counter_views(cls, mapping) -> None:
    for attr in mapping:
        def _get(self, _a=attr):
            return self._c[_a].value

        def _set(self, v, _a=attr):
            self._c[_a]._value = int(v)

        setattr(cls, attr, property(_get, _set))


_install_counter_views(Engine, _ENGINE_COUNTERS)


__all__ = ["Engine", "EngineConfig", "KVHandoff", "Request", "Completion",
           "ENGINE_ROLES", "ST_OK",
           "ST_CANCELLED", "ST_DEADLINE", "ST_REJECTED", "ST_FAILED",
           "TERMINAL_STATUSES", "SHED_POLICIES", "kv_dtype_of"]
