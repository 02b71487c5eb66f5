"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 (arch=llama-like) [arXiv:2404.06395; hf]."""

from repro_torch.configs.base import ModelConfig

ARCH = "minicpm-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="decoder",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753,
        norm="rmsnorm", activation="silu", gated_mlp=True,
        tie_embeddings=True, rope_theta=10000.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=72, num_heads=4, num_kv_heads=4,
        d_ff=192, vocab_size=512, remat="none",
    )
