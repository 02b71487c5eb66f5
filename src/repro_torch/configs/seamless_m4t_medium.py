"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (GQA kv=16)
d_ff=4096 vocab=256206, enc-dec multimodal [arXiv:2308.11596; hf].

The backbone only: the speech frontend is a stub, and precomputed frame
embeddings [B, S, D] go straight into the encoder
(``models/encdec.py``).  12 encoder and 12 decoder layers (the "12L"
names the depth of each stack of the medium model)."""

from repro_torch.configs.base import ModelConfig

ARCH = "seamless-m4t-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="encdec",
        num_layers=24, enc_layers=12, dec_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=256206,
        norm="layernorm", activation="gelu", gated_mlp=False,
        frontend="audio",
    )


def tiny() -> ModelConfig:
    return full().replace(
        num_layers=4, enc_layers=2, dec_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, remat="none",
    )
