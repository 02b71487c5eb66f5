"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2 [hf:xai-org/grok-1; unverified]."""

from repro_torch.configs.base import ModelConfig

ARCH = "grok-1-314b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="decoder",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=32768, vocab_size=131072,
        num_experts=8, experts_per_token=2,
        norm="rmsnorm", activation="gelu", gated_mlp=True,
        logit_softcap=30.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=4, remat="none",
    )
