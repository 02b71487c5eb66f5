"""Architecture registry of the PyTorch port: the reference's ten
architectures, in its order.

The port keeps its own copy of the config dataclasses (``base.py``) and
of each architecture; it never imports the JAX package.  The dense
decoders: qwen3-1.7b, olmo-1b (non-parametric LayerNorm), minicpm-2b
(head_dim 64, an odd vocabulary) and qwen3-14b (untied unembedding);
the MoE decoders llama4-scout (16 experts, top-1) and grok-1 (8
experts, top-2, gelu, logit softcap); the hybrid recurrentgemma-2b
(RG-LRU and local attention); the vlm paligemma-3b (256 stub patch
embeddings under a prefix-LM mask); rwkv6-3b (the WKV recurrence,
parametric LayerNorm); and the encoder-decoder seamless-m4t-medium
(stub audio frames into the encoder, cross-attention in the decoder).
The last four serve through ``generate_bucketed``.
"""

from repro_torch.configs import (grok_1_314b, llama4_scout_17b_a16e,
                                 minicpm_2b, olmo_1b, paligemma_3b,
                                 qwen3_14b, qwen3_1_7b, recurrentgemma_2b,
                                 rwkv6_3b, seamless_m4t_medium)
from repro_torch.configs.base import ModelConfig, RunShape  # noqa: F401

_MODULES = (olmo_1b, qwen3_14b, qwen3_1_7b, minicpm_2b, recurrentgemma_2b,
            seamless_m4t_medium, paligemma_3b, rwkv6_3b,
            llama4_scout_17b_a16e, grok_1_314b)

ARCHS = {m.ARCH: m for m in _MODULES}
ARCH_NAMES = tuple(ARCHS)


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = ARCHS[name]
    return mod.tiny() if tiny else mod.full()
