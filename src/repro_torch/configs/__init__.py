"""Architecture registry of the PyTorch port.

The port keeps its own copy of the config dataclasses (``base.py``) and
of each architecture it serves; it never imports the JAX package.  The
four dense decoders are registered: qwen3-1.7b, olmo-1b (non-parametric
LayerNorm), minicpm-2b (head_dim 64, an odd vocabulary) and qwen3-14b
(untied unembedding).
"""

from repro_torch.configs import minicpm_2b, olmo_1b, qwen3_14b, qwen3_1_7b
from repro_torch.configs.base import ModelConfig, RunShape  # noqa: F401

_MODULES = (olmo_1b, qwen3_14b, qwen3_1_7b, minicpm_2b)

ARCHS = {m.ARCH: m for m in _MODULES}
ARCH_NAMES = tuple(ARCHS)


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = ARCHS[name]
    return mod.tiny() if tiny else mod.full()
