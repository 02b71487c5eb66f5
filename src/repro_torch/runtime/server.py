"""Batched inference server (port of the JAX package's
``runtime/server.py``).

``InferenceServer.generate`` keeps the reference's synchronous
signature: requests go to an :class:`~repro_torch.runtime.engine.Engine`
sized by the server and are drained.  Weights may be served as DNA-TEQ
codes (``quant_bits``): the port fits and encodes them itself, on the
device, and every matmul then runs the fused LUT-dequant kernel.  With
``act_quant`` the activations are codes too (the Engine calibrates its
tables), and with ``kv_codes`` the KV pages.

:meth:`InferenceServer.generate_bucketed` is the legacy path kept by the
reference as the engine's measured baseline and numerical reference:
requests bucketed by prompt length, each bucket prefilled in one batch
into a contiguous cache of ``max_len`` positions and decoded in
lockstep through the contiguous flash-decode kernel.  On the card the
decode steps of a bucket replay one CUDA graph, captured after the
first (eager) step, as the reference jits its decode step: the argmax
feeds the next step's token buffer, the position advances and the token
lands in a device buffer, all inside the graph, and the bucket's tokens
come to the host in one copy at the end.  It serves float
activations (``act_quant`` and ``kv_codes`` apply to the Engine only,
as in the reference).  The decoder family is the only one ported, so
``generate`` never falls back to it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.models import api as mapi
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime.engine import (Completion, Engine, EngineConfig,
                                        Request, kv_dtype_of)
from repro_torch.runtime.step_graph import StepGraph

__all__ = ["InferenceServer", "Request", "Completion"]


class InferenceServer:
    def __init__(self, cfg: ModelConfig, params: DecoderLM | None = None,
                 rng_seed: int = 0, quant_bits: int | None = None,
                 act_quant: int | None = None, max_len: int = 512,
                 kv_dtype="float32", kv_codes: bool = False,
                 num_slots: int = 8, block_size: int = 16,
                 prefix_cache: bool = False, prefill_chunk: int = 256,
                 max_queue: int | None = None,
                 shed_policy: str = "reject-new", spec_k: int = 0,
                 device=None, cuda_graphs: bool = True):
        """As the reference's server, on the card unless
        ``device="cpu"`` is passed.  ``kv_dtype`` is ``"float32"``,
        ``"bfloat16"`` or ``"float8_e4m3fn"`` (1 B an element, upcast
        in the attention kernels), for the Engine's pages and for the
        contiguous cache of :meth:`generate_bucketed` (``max_len``
        positions).  ``prefix_cache`` defaults to False (the
        reference's default is True) until the prefix cache is ported
        (ROADMAP Queue 1 item 7); ``max_queue`` and ``spec_k`` are
        refused by the Engine until their ROADMAP items land.  With
        ``quant_bits`` the weights are quantized by the port's
        ``quantize_tree`` on the device.  ``act_quant`` (bits) serves
        activations as codes, calibrated by each Engine the server
        builds (disk-cached); ``kv_codes`` stores KV pages as uint8
        codes and requires ``act_quant``.  ``cuda_graphs=False`` runs
        every step eagerly, in the Engines and in
        :meth:`generate_bucketed` (the A/B of one dispatch a step)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.api = mapi.get_model(cfg)
        self.max_len = max_len
        self.kv_dtype = kv_dtype_of(kv_dtype)
        self.act_quant = act_quant
        self.kv_codes = bool(kv_codes)
        if self.kv_codes and act_quant is None:
            raise ValueError("kv_codes=True requires act_quant bits")
        self.num_slots = num_slots
        self.block_size = block_size
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.spec_k = int(spec_k)
        self.cuda_graphs = bool(cuda_graphs)
        if params is None:
            params = self.api.init(self.device, seed=rng_seed)
        self.quant_report = None
        if quant_bits is not None:
            qtree, self.quant_report = ll.quantize_tree(
                params.to(self.device).tree(), quant_bits,
                axes=self.api.logical_axes())
            params = DecoderLM(cfg, qtree, device=self.device)
        self.params = params.to(self.device)
        self.last_engine: Engine | None = None
        self._engine_max_seq = max_len          # grows monotonically
        # generate_bucketed's decode graphs: (captured, capture seconds)
        self.bucket_graphs = 0
        self.bucket_capture_s = 0.0

    def make_engine(self, requests: Sequence[Request]) -> Engine:
        """An Engine for this request set, reused while its config
        holds; a request longer than ``max_len`` widens the pool, and
        the widened size sticks."""
        max_seq = max((len(r.prompt) + r.max_new_tokens for r in requests),
                      default=self.max_len)
        self._engine_max_seq = max(self._engine_max_seq, max_seq,
                                   self.block_size)
        ec = EngineConfig(
            num_slots=self.num_slots, block_size=self.block_size,
            max_seq_len=self._engine_max_seq, prefix_cache=self.prefix_cache,
            prefill_chunk=self.prefill_chunk, max_queue=self.max_queue,
            shed_policy=self.shed_policy, spec_k=self.spec_k)
        if self.last_engine is None or self.last_engine.engine_cfg != ec:
            self.last_engine = None         # free the old page pool first
            self.last_engine = Engine(
                self.cfg, params=self.params, act_quant=self.act_quant,
                engine=ec, kv_dtype=self.kv_dtype, kv_codes=self.kv_codes,
                device=self.device, cuda_graphs=self.cuda_graphs)
        return self.last_engine

    def generate(self, requests: Sequence[Request]) -> list[Completion]:
        """Serve via the paged continuous-batching Engine (greedy)."""
        if not requests:
            return []
        return self.make_engine(requests).generate(requests)

    # ------------------------------------------- legacy bucketed path --
    def generate_bucketed(self, requests: Sequence[Request]) -> list[Completion]:
        """Length-bucketed batched prefill and lockstep batched greedy
        decode over a contiguous cache.  Every request of a bucket
        decodes ``max(max_new_tokens)`` steps and shares one prefill
        and decode stamp; a stop token trims the stream after it.
        Completions come back sorted by uid."""
        buckets: dict[int, list[Request]] = defaultdict(list)
        for r in requests:
            buckets[len(r.prompt)].append(r)
        out: list[Completion] = []
        for plen, group in sorted(buckets.items()):
            out.extend(self._run_bucket(group))
        return sorted(out, key=lambda c: c.uid)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_bucket(self, group: list[Request]) -> list[Completion]:
        toks = torch.as_tensor(np.stack([r.prompt for r in group]),
                               dtype=torch.int32, device=self.device)
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.params, toks, self.cfg,
                                         self.max_len,
                                         cache_dtype=self.kv_dtype)
        cur = logits[:, -1, :].argmax(-1)[:, None].to(torch.int32)
        self._sync()
        t_prefill = time.perf_counter() - t0

        plen = toks.shape[1]
        max_new = max(r.max_new_tokens for r in group)
        if plen + max_new - 1 > self.max_len:   # the steps cannot check
            raise ValueError(f"cache full: position {plen} + "
                             f"{max_new - 1} decode steps > {self.max_len}")

        # the decode loop's state lives on the device: the step reads
        # and advances it, so its graph replays with no host input
        gen = torch.zeros((len(group), max(max_new, 1)), dtype=torch.int32,
                          device=self.device)
        gen[:, :1] = cur
        pos = torch.full((), plen, dtype=torch.int64, device=self.device)
        cache["pos"] = pos

        def step(_inputs):
            logits, _ = self.api.decode_step(self.params, cache, cur,
                                             self.cfg)
            nxt = logits[:, -1, :].argmax(-1)[:, None].to(torch.int32)
            gen.index_copy_(1, (pos - (plen - 1)).reshape(1), nxt)
            cur.copy_(nxt)
            pos.add_(1)

        run = StepGraph({}, self.device, graphs=self.cuda_graphs)
        t0 = time.perf_counter()
        for i in range(max_new - 1):
            run.step(step)
            if i == 0 and max_new > 2:
                run.capture(step)
        gen = gen.cpu().numpy()                 # waits for the card
        t_decode = time.perf_counter() - t0
        if run.graph is not None:
            self.bucket_graphs += 1
            self.bucket_capture_s += run.capture_s

        outs = []
        for i, r in enumerate(group):
            seq = gen[i, :r.max_new_tokens]
            if r.stop_token is not None:
                hits = np.where(seq == r.stop_token)[0]
                if hits.size:
                    seq = seq[:hits[0] + 1]
            outs.append(Completion(r.uid, seq, t_prefill, t_decode,
                                   decode_steps=max(max_new - 1, 0)))
        return outs
