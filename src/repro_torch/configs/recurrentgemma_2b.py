"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1)
d_ff=7680 vocab=256000, RG-LRU + local attn 1:2 [arXiv:2402.19427; hf].

The RG-LRU state is O(1) and the local-attention KV ring is bounded by
the 2048 window, so a long context decodes with a fixed-size cache
(``models/rglru.py``)."""

from repro_torch.configs.base import ModelConfig

ARCH = "recurrentgemma-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        attention_pattern=("rec", "rec", "local"), window=2048,
        rnn_width=2560, conv_width=4,
        norm="rmsnorm", activation="gelu", gated_mlp=True,
        tie_embeddings=True, logit_softcap=30.0,
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=3, d_model=64, num_heads=2, num_kv_heads=1, head_dim=32,
        d_ff=192, vocab_size=512, window=16, rnn_width=64, remat="none",
    )
