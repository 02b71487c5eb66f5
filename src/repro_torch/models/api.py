"""Model API (port of the JAX package's ``models/api.py``): one entry per
architecture family; only the ``decoder`` family is ported.  Its
contiguous-cache entry points (``forward``, ``prefill``,
``decode_step``, ``init_cache``) serve ``generate_bucketed``; the paged
ones serve the Engine."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.params import logical_axes


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    specs: Any
    forward: Callable      # (params, tokens, cfg, prefix_embeds=None)
    prefill: Callable      # (params, tokens, cfg, max_len, ..., cache_dtype)
    decode_step: Callable  # (params, cache, tokens, cfg)
    init_cache: Callable   # (cfg, batch, max_len, dtype, device)
    prefill_into_cache: Callable
    decode_step_paged: Callable
    collect_act_calibration: Callable | None = None

    def init(self, device=None, seed: int = 0) -> transformer.DecoderLM:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (the card unless ``device="cpu"``)."""
        return transformer.DecoderLM(self.cfg, device=device, seed=seed)

    def logical_axes(self):
        return logical_axes(self.specs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family != "decoder" or cfg.frontend:
        raise NotImplementedError(
            f"family {cfg.family!r} (frontend={cfg.frontend!r}) is not "
            f"ported yet (ROADMAP Queue 1 item 13)")
    return ModelAPI(cfg=cfg, specs=transformer.model_specs(cfg),
                    forward=transformer.forward,
                    prefill=transformer.prefill,
                    decode_step=transformer.decode_step,
                    init_cache=transformer.init_cache,
                    prefill_into_cache=transformer.prefill_into_cache,
                    decode_step_paged=transformer.decode_step_paged,
                    collect_act_calibration=transformer.collect_act_calibration)
