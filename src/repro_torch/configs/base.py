"""Config system: model architecture + run-shape descriptors.

One :class:`ModelConfig` per assigned architecture lives in
``repro/configs/<arch>.py`` (exact figures from the public pool) together
with a ``tiny()`` reduced variant for CPU smoke tests.  Input shapes are
the four assigned LM shapes; applicability/skips follow DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal


Family = Literal["decoder", "encdec", "hybrid", "rwkv", "vlm"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads

    # block variants
    norm: str = "rmsnorm"                  # rmsnorm | layernorm | nonparam_ln
    qk_norm: bool = False
    activation: str = "silu"               # silu | gelu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "routed"               # routed | dense_mixture
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma) / local attention
    attention_pattern: tuple[str, ...] = ()  # e.g. ("rglru","rglru","local")
    window: int = 0                        # local-attention window
    rnn_width: int = 0                     # RG-LRU recurrence width
    conv_width: int = 4                    # temporal conv size (hybrid)

    # rwkv
    rwkv_head_dim: int = 64

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0

    # multimodal stub frontends (DESIGN.md: precomputed embeddings)
    frontend: str | None = None            # None | "patch" | "audio"
    num_prefix_tokens: int = 0             # image patches / audio frames

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # Lama quantization (the paper's technique): exponent bits or None
    lama_bits: int | None = None

    # training
    remat: str = "block"                   # none | block
    z_loss: float = 1e-4

    # lowering: scan over layers (prod; HLO O(1) in depth) or unroll
    # (used by the dry-run cost extraction, where XLA's cost analysis
    # counts while-loop bodies only once)
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class RunShape:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


TRAIN_4K = RunShape("train_4k", 4096, 256, "train")
PREFILL_32K = RunShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = RunShape("decode_32k", 32768, 128, "decode")
LONG_500K = RunShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def supports_shape(cfg: ModelConfig, shape: RunShape) -> bool:
    """Shape applicability (skips recorded in DESIGN.md §4)."""
    if shape.name == "long_500k":
        # needs sub-quadratic attention: SSM / hybrid only
        return cfg.family in ("rwkv", "hybrid")
    return True


def assigned_cells(cfg: ModelConfig) -> list[RunShape]:
    return [s for s in ALL_SHAPES if supports_shape(cfg, s)]
