"""Model API (port of the JAX package's ``models/api.py``): one entry per
architecture family.  Four are ported: ``decoder``, with dense or MoE
blocks (``models/transformer.py``, ``models/moe.py``); ``vlm``, the
decoder's entry points behind a stub patch frontend (``prefix_embeds``);
``hybrid``, RecurrentGemma's RG-LRU and local attention
(``models/rglru.py``); and ``rwkv``, RWKV-6's WKV recurrence
(``models/rwkv6.py``).  The contiguous-cache entry points (``forward``,
``prefill``, ``decode_step``, ``init_cache``) serve
``generate_bucketed``; the paged ones (``prefill_into_cache``,
``decode_step_paged`` and ``spec_verify_into_cache``) serve the Engine,
and are None for the hybrid and rwkv, as in the reference.  The Engine
takes no frontend (``Engine.supports``), so ``InferenceServer.generate``
falls back to the bucketed path for the vlm, the hybrid and rwkv."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, rwkv6, transformer
from repro_torch.models.params import ParamTree, logical_axes


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    specs: Any
    module: type           # the params module: (cfg, tree, device=, seed=)
    forward: Callable      # (params, tokens, cfg, prefix_embeds=None)
    prefill: Callable      # (params, tokens, cfg, max_len, ..., cache_dtype)
    decode_step: Callable  # (params, cache, tokens, cfg)
    init_cache: Callable   # (cfg, batch, max_len, dtype, device)
    prefill_into_cache: Callable | None = None
    decode_step_paged: Callable | None = None
    spec_verify_into_cache: Callable | None = None
    collect_act_calibration: Callable | None = None

    def init(self, device=None, seed: int = 0) -> ParamTree:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (the card unless ``device="cpu"``)."""
        return self.module(self.cfg, device=device, seed=seed)

    def logical_axes(self):
        return logical_axes(self.specs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "hybrid":
        return ModelAPI(cfg=cfg, specs=rglru.model_specs(cfg),
                        module=rglru.HybridLM, forward=rglru.forward,
                        prefill=rglru.prefill,
                        decode_step=rglru.decode_step,
                        init_cache=rglru.init_cache)
    if cfg.family == "rwkv":
        return ModelAPI(cfg=cfg, specs=rwkv6.model_specs(cfg),
                        module=rwkv6.RwkvLM, forward=rwkv6.forward,
                        prefill=rwkv6.prefill,
                        decode_step=rwkv6.decode_step,
                        init_cache=rwkv6.init_cache)
    if not (cfg.family == "decoder" and not cfg.frontend
            or cfg.family == "vlm" and cfg.frontend == "patch"):
        raise NotImplementedError(
            f"family {cfg.family!r} (frontend={cfg.frontend!r}) is not "
            f"ported yet (ROADMAP Queue 1 item 13)")
    return ModelAPI(cfg=cfg, specs=transformer.model_specs(cfg),
                    module=transformer.DecoderLM,
                    forward=transformer.forward,
                    prefill=transformer.prefill,
                    decode_step=transformer.decode_step,
                    init_cache=transformer.init_cache,
                    prefill_into_cache=transformer.prefill_into_cache,
                    decode_step_paged=transformer.decode_step_paged,
                    spec_verify_into_cache=transformer.spec_verify_into_cache,
                    collect_act_calibration=transformer.collect_act_calibration)
