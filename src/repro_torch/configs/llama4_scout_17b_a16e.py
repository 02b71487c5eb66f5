"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""

from repro_torch.configs.base import ModelConfig

ARCH = "llama4-scout-17b-a16e"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="decoder",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202048,
        num_experts=16, experts_per_token=1,
        norm="rmsnorm", activation="silu", gated_mlp=True,
        rope_theta=500_000.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=4, remat="none",
    )
