"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""

from repro_torch.configs.base import ModelConfig

ARCH = "qwen3-1.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="decoder",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=6144, vocab_size=151936,
        norm="rmsnorm", qk_norm=True, activation="silu", gated_mlp=True,
        tie_embeddings=True, rope_theta=1_000_000.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512, remat="none",
    )
