"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""

from repro_torch.configs.base import ModelConfig

ARCH = "qwen3-14b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="decoder",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=17408, vocab_size=151936,
        norm="rmsnorm", qk_norm=True, activation="silu", gated_mlp=True,
        rope_theta=1_000_000.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512, remat="none",
    )
