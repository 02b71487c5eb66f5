"""Model API (port of the JAX package's ``models/api.py``): one entry per
architecture family, all five of the reference's: ``decoder``, with
dense or MoE blocks (``models/transformer.py``, ``models/moe.py``);
``vlm``, the decoder's entry points behind a stub patch frontend
(``prefix_embeds``); ``hybrid``, RecurrentGemma's RG-LRU and local
attention (``models/rglru.py``); ``rwkv``, RWKV-6's WKV recurrence
(``models/rwkv6.py``); and ``encdec``, seamless-m4t's encoder and
cross-attending decoder behind stub audio frames
(``models/encdec.py``).  The contiguous-cache entry points
(``forward``, ``prefill``, ``decode_step``, ``init_cache``) serve
``generate_bucketed``; the paged ones (``prefill_into_cache``,
``decode_step_paged`` and ``spec_verify_into_cache``) serve the Engine,
and are None for the hybrid, rwkv and the encdec, as in the reference.
The Engine takes no frontend (``Engine.supports``), so
``InferenceServer.generate`` falls back to the bucketed path for every
family but the decoder's.

Training: :func:`loss_fn` (the next-token cross-entropy with the
z-loss, over any family's ``forward``) and :func:`synth_batch` (a
random batch, the reference's numpy draws)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, RunShape
from repro_torch.models import encdec, rglru, rwkv6, transformer
from repro_torch.models import params as P
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
    abstract_cache: Callable  # (cfg, batch, max_len[, enc_len], dtype)
    prefill_into_cache: Callable | None = None
    decode_step_paged: Callable | None = None
    spec_verify_into_cache: Callable | None = None
    collect_act_calibration: Callable | None = None

    def init(self, device=None, seed: int = 0) -> ParamTree:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (the card unless ``device="cpu"``)."""
        return self.module(self.cfg, device=device, seed=seed)

    def abstract_params(self, dtype=None) -> dict:
        """The parameters as ``meta`` tensors (``cfg.param_dtype``
        unless ``dtype``)."""
        return P.abstract_params(
            self.specs, dtype or getattr(torch, self.cfg.param_dtype))

    def logical_axes(self):
        return logical_axes(self.specs)

    def param_count(self) -> int:
        return P.param_count(self.specs)


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "hybrid":
        return ModelAPI(cfg=cfg, specs=rglru.model_specs(cfg),
                        module=rglru.HybridLM, forward=rglru.forward,
                        prefill=rglru.prefill,
                        decode_step=rglru.decode_step,
                        init_cache=rglru.init_cache,
                        abstract_cache=rglru.abstract_cache)
    if cfg.family == "rwkv":
        return ModelAPI(cfg=cfg, specs=rwkv6.model_specs(cfg),
                        module=rwkv6.RwkvLM, forward=rwkv6.forward,
                        prefill=rwkv6.prefill,
                        decode_step=rwkv6.decode_step,
                        init_cache=rwkv6.init_cache,
                        abstract_cache=rwkv6.abstract_cache)
    if cfg.family == "encdec":
        return ModelAPI(cfg=cfg, specs=encdec.model_specs(cfg),
                        module=encdec.EncDecLM, forward=encdec.forward,
                        prefill=encdec.prefill,
                        decode_step=encdec.decode_step,
                        init_cache=encdec.init_cache,
                        abstract_cache=encdec.abstract_cache)
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
                    abstract_cache=transformer.abstract_cache,
                    prefill_into_cache=transformer.prefill_into_cache,
                    decode_step_paged=transformer.decode_step_paged,
                    spec_verify_into_cache=transformer.spec_verify_into_cache,
                    collect_act_calibration=transformer.collect_act_calibration)


# ------------------------------------------------------------- losses --

def loss_fn(api: ModelAPI, params, batch: dict):
    """The training loss of any family: the next-token cross-entropy
    over ``forward``'s logits, the z-loss and ``0.01 * aux``.  A vlm's
    patch positions are dropped; the encdec's logits are the decoder's
    only.  Returns (total, ``{"loss", "z_loss", "aux_loss"}``)."""
    cfg = api.cfg
    pe = batch.get("prefix_embeds")
    logits, aux = api.forward(params, batch["tokens"], cfg, prefix_embeds=pe)
    if cfg.family == "vlm" and pe is not None:
        logits = logits[:, pe.shape[1]:, :]
    logz = torch.logsumexp(logits, -1)
    if type(logits).__name__ == "DTensor":
        # a vocab-sharded gather has no working DTensor rule (its mask
        # partial assumes an embedding's 2-D index); a one-hot sum picks
        # the same element
        tgt = (logits * torch.nn.functional.one_hot(
            batch["targets"].long(), logits.shape[-1])).sum(-1)
    else:
        tgt = torch.gather(logits, -1,
                           batch["targets"].long()[..., None])[..., 0]
    loss = torch.mean(logz - tgt)
    zl = cfg.z_loss * torch.mean(logz ** 2)
    total = loss + zl + 0.01 * aux
    return total, {"loss": loss, "z_loss": zl, "aux_loss": aux}


# -------------------------------------------------------- input specs --

def input_specs(cfg: ModelConfig, shape: RunShape) -> dict:
    """Every model input of one run-shape cell as ``meta`` tensors (the
    reference's shapes and dtypes): train ``tokens`` / ``targets`` [B,
    S]; prefill ``tokens`` [B, S - P] (P the frontend's patches); decode
    ``tokens`` [B, 1]; int32.  The encdec's stub frames [B, S, d] and a
    frontend's ``num_prefix_tokens`` patches as ``prefix_embeds`` in the
    compute dtype."""
    b = shape.global_batch
    cdt = getattr(torch, cfg.compute_dtype)

    def meta(shp, dt=torch.int32):
        return torch.empty(shp, dtype=dt, device="meta")

    def prefix(s):
        if cfg.family == "encdec":
            return meta((b, s, cfg.d_model), cdt)
        if cfg.frontend:
            return meta((b, cfg.num_prefix_tokens, cfg.d_model), cdt)
        return None

    if shape.kind == "decode":
        return {"tokens": meta((b, 1))}
    if shape.kind == "train":
        s = shape.seq_len
        out = {"tokens": meta((b, s)), "targets": meta((b, s))}
    else:
        s = shape.seq_len - (cfg.num_prefix_tokens if cfg.frontend else 0)
        out = {"tokens": meta((b, s))}
    if (p := prefix(s)) is not None:
        out["prefix_embeds"] = p
    return out


def synth_batch(cfg: ModelConfig, shape: RunShape, rng=None, seq_len=None,
                device=None) -> dict:
    """A random batch of ``shape``'s global batch, the reference's numpy
    draws in its order (``default_rng(0)`` unless ``rng``): ``tokens``
    and ``targets`` int32 [B, S]; the encdec's S frames or a frontend's
    ``num_prefix_tokens`` patches, ``normal * 0.02``, in the compute
    dtype (through float32, as the reference's cast goes).  On
    ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    b = shape.global_batch
    s = seq_len or shape.seq_len

    def ints():
        return torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                               dtype=torch.int32, device=dev)

    batch = {"tokens": ints(), "targets": ints()}
    n = s if cfg.family == "encdec" else (cfg.num_prefix_tokens
                                          if cfg.frontend else 0)
    if n:
        frames = rng.normal(size=(b, n, cfg.d_model)) * 0.02
        batch["prefix_embeds"] = torch.as_tensor(
            frames.astype(np.float32), device=dev).to(
                getattr(torch, cfg.compute_dtype))
    return batch
