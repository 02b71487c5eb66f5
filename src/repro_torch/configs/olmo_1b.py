"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192
vocab=50304, non-parametric LN [arXiv:2402.00838; hf]."""

from repro_torch.configs.base import ModelConfig

ARCH = "olmo-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="decoder",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304,
        norm="nonparam_ln", activation="silu", gated_mlp=True,
        tie_embeddings=True, rope_theta=10000.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, remat="none",
    )
