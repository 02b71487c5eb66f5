"""paligemma-3b [vlm] — 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216, SigLIP + gemma [arXiv:2407.07726; hf].

The backbone only: the SigLIP vision tower is a stub, and 256
precomputed patch embeddings join the text sequence under a prefix-LM
mask (full attention within the prefix, causal after), as in the paper
(``models/transformer.py``'s ``prefix_embeds``)."""

from repro_torch.configs.base import ModelConfig

ARCH = "paligemma-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        head_dim=256, d_ff=16384, vocab_size=257216,
        norm="rmsnorm", activation="gelu", gated_mlp=True,
        tie_embeddings=True, frontend="patch", num_prefix_tokens=256,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=192, vocab_size=512, num_prefix_tokens=8, remat="none",
    )
