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
``max_batched_prefill`` heads per tick, pages for the prompt only (no
worst-case reservation), and when the free list runs dry the youngest
running sequence is preempted (pages released, sequence re-queued to be
recomputed; greedy decoding makes the recompute token-identical).  The
chunk width and the block-table column count follow the reference's
pow2 ladders (``_chunk_width``/``_live_cols``), so the kernels see the
same M and page-column counts as the reference's.

Greedy argmax and the per-row ``isfinite`` flag are computed in the same
step as the logits and cross to the host in one transfer per tick.  On
the card each tick is one dispatch, as the reference's jitted
``_jit_prefill`` / ``_jit_decode`` are: a
:class:`~repro_torch.runtime.step_graph.StepGraph` per decode width
(the pow2 block-table column ladder) and per prefill (chunk width,
columns) takes the tick's host inputs in one copy, replays the step as a
CUDA graph captured after the first eager tick at that key, and returns
the argmax and flags in one copy back.  ``cuda_graphs=False`` runs every
tick eagerly (the A/B); on the CPU ticks always run eagerly.

Activations as codes (``act_quant``: per-(layer, site) tables fit on
sample prompts at construction, on the engine's device, disk-cached),
KV pages as codes (``kv_codes``: uint8 pages under per-head tables) and
narrow KV pages (``kv_dtype="float8_e4m3fn"``: cast at the write as the
reference casts, upcast in the attention kernels after the load) are
served; the engine counts the attention boundary's traffic from shapes
(``attn_bytes_read``, ``attn_act_bytes``, ``attn_dequants``).

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item that brings it: the prefix cache (item 7; the port's
``EngineConfig.prefix_cache`` therefore defaults to False), speculative
decoding (10), bounded queues and load shedding, deadlines, chaos,
checksums and the handling of non-finite rows (11: until then a
non-finite row raises, an f8 page's NaN included), disaggregation roles
and the calibration drift guard, which reports through the metrics
registry (12).
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.models import api as mapi
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime import calibration as cal
from repro_torch.runtime.paged_cache import PagedKVCache
from repro_torch.runtime.step_graph import StepGraph

ST_OK = "ok"
KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn}


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    stop_token: int | None = None
    deadline_s: float | None = None  # lifecycle: ROADMAP item 11


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray
    prefill_s: float              # this request's own prefill wall time
    decode_s: float               # wall time of the steps it was active in
    decode_steps: int = 0
    ttft_s: float = 0.0           # submit -> first token available
    queue_wait_s: float = 0.0     # submit -> first admission into a slot
    status: str = ST_OK


@dataclasses.dataclass
class EngineConfig:
    """The reference's fields and defaults, except ``prefix_cache``,
    which defaults to False until the prefix cache is ported."""

    num_slots: int = 4            # concurrent decode lanes
    block_size: int = 16          # tokens per KV page
    max_seq_len: int = 512        # per-sequence cap (prompt + generated)
    num_blocks: int | None = None  # page-pool size; None -> full occupancy
    prefix_cache: bool = False    # ROADMAP item 7
    max_batched_prefill: int = 4  # admissions per scheduler tick
    prefill_chunk: int = 256      # max prompt tokens advanced per row/tick
    max_queue: int | None = None  # ROADMAP item 11
    shed_policy: str = "reject-new"  # ROADMAP item 11
    max_preemptions: int = 3      # starvation guard: never a victim after N
    checksum_pages: bool = False  # ROADMAP item 11
    quarantine_ticks: int = 8     # ROADMAP item 11
    replay_dir: str | None = None  # ROADMAP item 11
    role: str = "unified"         # ROADMAP item 12
    spec_k: int = 0               # ROADMAP item 10
    spec_max_ngram: int = 3
    spec_min_ngram: int = 1
    drift_check_every: int = 0    # ROADMAP item 12
    drift_threshold_db: float = 6.0


# field -> (default, ROADMAP item that brings the feature)
_UNPORTED = {"prefix_cache": (False, 7), "max_queue": (None, 11),
             "shed_policy": ("reject-new", 11), "checksum_pages": (False, 11),
             "replay_dir": (None, 11), "role": ("unified", 12),
             "spec_k": (0, 10), "drift_check_every": (0, 12)}


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


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
    slot: int = -1
    tokens: list[int] = dataclasses.field(default_factory=list)
    next_token: int = 0
    prefill_pos: int = 0          # tail tokens already chunk-prefilled
    prefill_done: bool = False
    preemptions: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0
    submit_t: float = 0.0
    admit_t: float | None = None
    first_token_t: float | None = None

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
                          ttft_s=ttft, queue_wait_s=wait)


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
    tick; False runs every tick eagerly.  Meaningless on the CPU."""

    def __init__(self, cfg: ModelConfig, params: DecoderLM | None = None,
                 rng_seed: int = 0, quant_bits: int | None = None,
                 act_quant: int | None = None, calib_prompts=None,
                 engine: EngineConfig | None = None,
                 kv_dtype="float32", kv_codes: bool = False, chaos=None,
                 device=None, cuda_graphs: bool = True):
        self.device = resolve_device(device)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        if chaos is not None:
            raise _not_ported("chaos injection", 11)
        self.cfg = cfg
        self.api = mapi.get_model(cfg)
        self.engine_cfg = ec = engine or EngineConfig()
        for field, (default, item) in _UNPORTED.items():
            if getattr(ec, field) != default:
                raise _not_ported(f"EngineConfig.{field}="
                                  f"{getattr(ec, field)!r}", item)
        if ec.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{ec.prefill_chunk}")
        self.kv_codes = bool(kv_codes)
        # codes mode: pages hold uint8 codes (1 B per element)
        self.kv_dtype = torch.uint8 if self.kv_codes else kv_dtype_of(kv_dtype)
        if params is None:
            params = self.api.init(self.device, seed=rng_seed)
        self.quant_report = None
        if quant_bits is not None:
            qtree, self.quant_report = ll.quantize_tree(
                params.tree(), quant_bits, axes=self.api.logical_axes())
            params = DecoderLM(cfg, qtree, device=self.device)
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

        self._queue: deque[_SeqState] = deque()
        self._slots: list[_SeqState | None] = [None] * ec.num_slots
        self._states: dict[int, _SeqState] = {}
        self._seq_counter = 0
        self._clock = time.monotonic
        self.total_decode_steps = 0
        self.decode_tokens = 0
        self.prefill_tokens_computed = 0
        self.prefill_batches = 0
        self.preemptions = 0
        # wall time inside prefill / decode dispatches (each ends with
        # the host transfer that waits for the device)
        self.prefill_dispatch_s = 0.0
        self.decode_dispatch_s = 0.0
        # the attention boundary's traffic, from shapes (_attn_accounting)
        self.attn_bytes_read = 0
        self.attn_act_bytes = 0
        self.attn_dequants = 0
        # the step runners, by shape key (and policy): decode (cols,),
        # prefill (chunk width, cols); every graph shares one pool, as
        # each replay's output is copied off before the next replay
        self.step_runners: dict[str, dict[tuple, StepGraph]] = {
            "decode": {}, "prefill": {}}
        self._pool = (torch.cuda.graph_pool_handle() if self.cuda_graphs
                      else None)

    # ---------------------------------------------------------------- api
    def submit(self, request: Request) -> int:
        """Enqueue a request; returns its handle (the uid)."""
        if request.uid in self._states:
            raise ValueError(f"duplicate uid {request.uid}")
        if request.deadline_s is not None:
            raise _not_ported("Request.deadline_s", 11)
        plen = len(request.prompt)
        if plen + request.max_new_tokens > self.engine_cfg.max_seq_len:
            raise ValueError(
                f"request {request.uid}: prompt {plen} + max_new "
                f"{request.max_new_tokens} exceeds max_seq_len "
                f"{self.engine_cfg.max_seq_len}")
        st = _SeqState(request, seq_no=self._seq_counter,
                       submit_t=self._clock())
        self._seq_counter += 1
        self._states[request.uid] = st
        self._queue.append(st)
        return request.uid

    @property
    def pending(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def step(self) -> list[Completion]:
        """One scheduler tick: admit, advance prefills by one chunk,
        decode once, retire.  Returns the completions of this tick."""
        self._admit()
        if self._queue and all(s is None for s in self._slots):
            raise RuntimeError(
                "no admissible request: head of queue needs more KV "
                "blocks than the pool can ever free")
        finished = self._prefill_tick()
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and s.prefill_done]
        if active:
            finished += self._decode_tick(active)
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

    def check_partition(self) -> None:
        """Assert the page-partition invariant (cheap; tests call it
        every tick)."""
        self.cache.audit_partition()

    def graph_captures(self) -> tuple[int, float]:
        """(CUDA graphs captured, seconds spent capturing them)."""
        done = [r for d in self.step_runners.values() for r in d.values()
                if r.graph is not None]
        return len(done), sum(r.capture_s for r in done)

    # ---------------------------------------------------------- scheduler
    def _free_slot(self) -> int | None:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _should_stop(self, st: _SeqState) -> bool:
        r = st.request
        return (len(st.tokens) >= r.max_new_tokens
                or (r.stop_token is not None
                    and st.tokens[-1] == r.stop_token))

    def _retire(self, slot: int) -> Completion:
        st = self._slots[slot]
        self._slots[slot] = None
        self.cache.release_slot(slot)
        st.status = _FINISHED
        return st.completion()

    def _preempt(self, slot: int) -> None:
        """Release a running sequence's pages and re-queue it at the
        front; prompt plus tokens so far re-prefill on re-admission."""
        st = self._slots[slot]
        self._slots[slot] = None
        self.cache.release_slot(slot)
        st.prefill_pos = 0
        st.prefill_done = False
        st.slot = -1
        st.status = _QUEUED
        st.preemptions += 1
        self.preemptions += 1
        self._queue.appendleft(st)

    def _make_room(self, need: int, seq_no: int) -> bool:
        """Preempt the youngest running sequence submitted after
        ``seq_no`` (never one preempted ``max_preemptions`` times) until
        ``need`` pages are free.  False if that cannot be done."""
        alloc = self.cache.allocator
        while alloc.free_blocks < need:
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
            if not self._make_room(1, st.seq_no):
                if any(s is not None and s is not st for s in self._slots):
                    self._preempt(slot)
                    return
                raise RuntimeError(
                    f"KV pool too small: sequence {st.request.uid} cannot "
                    f"grow past {pos} tokens and nothing is evictable")
            self.cache.ensure_capacity(slot, reserved=False)

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

    def _try_place(self, st: _SeqState) -> bool:
        """Size the prompt's pages, make room, bind a slot.  The sequence
        enters with ``prefill_done=False``; the chunk scheduler advances
        it.  False when the pages cannot be freed."""
        plen = len(st.full_prompt())
        need = self.cache.blocks_for(plen)
        if need > self.cache.max_blocks_per_seq:
            raise RuntimeError(
                f"request {st.request.uid} needs {need} blocks > "
                f"max_blocks_per_seq {self.cache.max_blocks_per_seq}")
        if not self._make_room(need, st.seq_no):
            return False
        slot = self._free_slot()
        self.cache.bind_slot(slot, plen, reserved=False)
        st.slot, st.status = slot, _RUNNING
        st.prefill_pos = 0
        st.prefill_done = False
        if st.admit_t is None:
            st.admit_t = self._clock()
        self._slots[slot] = st
        return True

    def _admit(self) -> None:
        """FIFO admission of up to ``max_batched_prefill`` queue heads."""
        admitted = 0
        while (self._queue and self._free_slot() is not None
               and admitted < self.engine_cfg.max_batched_prefill):
            # pop before placing: _try_place may preempt a victim onto
            # the queue front
            st = self._queue.popleft()
            if self._try_place(st):
                admitted += 1
                continue
            self._queue.appendleft(st)    # head-of-line: wait for pages
            break

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

    def _decode_step(self, v: dict) -> torch.Tensor:
        logits, _ = self.api.decode_step_paged(
            self.params, self.cache.bind(v["table"], v["lengths"]),
            v["tokens"], v["mask"] != 0, self.cfg)
        return _greedy(logits)

    def _check_finite(self, ok, rows) -> None:
        bad = [self._slots[i].request.uid for i in rows if not ok[i]]
        if bad:
            raise _not_ported(f"non-finite logits for requests {bad}; "
                              f"failing them alone", 11)

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
        remaining = max(len(st.full_prompt()) - st.prefill_pos
                        for _, st in pref)
        w = self._chunk_width(remaining)
        takes: dict[int, int] = {}
        cols_need = 1
        for i, st in pref:
            s0 = st.prefill_pos
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
            s0, take = st.prefill_pos, takes[i]
            h["tokens"][i, :take] = st.full_prompt()[s0:s0 + take]
            h["start"][i] = s0
            self.prefill_tokens_computed += take
            self._attn_accounting(take, s0 + take)
        nxt, ok = run.run(self._prefill_step)
        dt = self._clock() - t0
        self.prefill_dispatch_s += dt
        run.capture(self._prefill_step)

        completing = [i for i, st in pref
                      if st.prefill_pos + takes[i]
                      >= len(st.full_prompt())
                      and st.request.max_new_tokens > 0]
        self._check_finite(ok, completing)
        finished: list[Completion] = []
        for i, st in pref:
            st.prefill_s += dt      # coalesced rows share the stamp
            st.prefill_pos += takes[i]
            if st.prefill_pos < len(st.full_prompt()):
                continue            # more chunks to go
            st.prefill_done = True
            r = st.request
            if r.max_new_tokens > 0 and len(st.tokens) < r.max_new_tokens:
                st.tokens.append(int(nxt[i]))
                st.next_token = st.tokens[-1]
            if st.first_token_t is None and st.tokens:
                st.first_token_t = self._clock()
            if self._should_stop(st):
                finished.append(self._retire(i))
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
        dt = self._clock() - t0
        self.decode_dispatch_s += dt
        run.capture(self._decode_step)
        self.total_decode_steps += 1
        self.decode_tokens += len(active)
        self._check_finite(ok, [i for i, _ in active])
        finished: list[Completion] = []
        for i, st in active:
            self.cache.lengths[i] += 1
            st.decode_steps += 1
            st.decode_s += dt
            st.tokens.append(int(nxt[i]))
            st.next_token = st.tokens[-1]
            if self._should_stop(st):
                finished.append(self._retire(i))
        return finished


__all__ = ["Engine", "EngineConfig", "Request", "Completion", "ST_OK",
           "kv_dtype_of"]
