"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536,
Finch, data-dependent decay [arXiv:2404.05892; hf].

The WKV state is O(1) in the context length (``models/rwkv6.py``); every
projection is a LUT GEMM when quantized, the LoRA and decay matrices
stay float."""

from repro_torch.configs.base import ModelConfig

ARCH = "rwkv6-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="rwkv",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=8960, vocab_size=65536, rwkv_head_dim=64,
        norm="layernorm", activation="relu", gated_mlp=False,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=128, vocab_size=512, rwkv_head_dim=32, remat="none",
    )
