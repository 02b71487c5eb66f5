"""Batched inference server over the Engine (port of the JAX package's
``runtime/server.py``, engine path only).

``InferenceServer.generate`` keeps the reference's synchronous
signature: requests go to an :class:`~repro_torch.runtime.engine.Engine`
sized by the server and are drained.  Weights may be served as DNA-TEQ
codes (``quant_bits``): the port fits and encodes them itself, on the
device, and every matmul then runs the fused LUT-dequant kernel.  With
``act_quant`` the activations are codes too (the Engine calibrates its
tables), and with ``kv_codes`` the KV pages.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lama_layers as ll
from repro_torch.models import api as mapi
from repro_torch.models.transformer import DecoderLM
from repro_torch.runtime.engine import (Completion, Engine, EngineConfig,
                                        Request, kv_dtype_of)

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
                 device=None):
        """As the reference's server, on the card unless
        ``device="cpu"`` is passed.  ``kv_dtype`` is ``"float32"`` or
        ``"bfloat16"``.  ``prefix_cache`` defaults to False (the
        reference's default is True) until the prefix cache is ported
        (ROADMAP Queue 1 item 7); ``max_queue`` and ``spec_k`` are
        refused by the Engine until their ROADMAP items land.  With
        ``quant_bits`` the weights are quantized by the port's
        ``quantize_tree`` on the device.  ``act_quant`` (bits) serves
        activations as codes, calibrated by each Engine the server
        builds (disk-cached); ``kv_codes`` stores KV pages as uint8
        codes and requires ``act_quant``."""
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
                device=self.device)
        return self.last_engine

    def generate(self, requests: Sequence[Request]) -> list[Completion]:
        """Serve via the paged continuous-batching Engine (greedy)."""
        if not requests:
            return []
        return self.make_engine(requests).generate(requests)
