"""Convert the JAX package's params tree to the port's module.

The caller turns the JAX arrays into numpy arrays (this module imports
nothing of JAX); :func:`params_from_jax` copies them byte for byte into
a :class:`~repro_torch.models.transformer.DecoderLM`, so both sides
compute with the same values.  It handles float leaves (bfloat16
included), qtensor leaves ``{codes, lut, qmeta}`` (per-tensor or
layer-stacked), the stacked blocks, the qk-norm scales, the tied
``embed.tokens`` table and the calibrated act-quant tables
``blocks.act_q[site] = {lut, qmeta}`` (per KV head for attn_k/attn_v),
so a reference-calibrated tree serves identically in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models.transformer import DecoderLM


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _convert(node):
    if isinstance(node, dict):
        if "codes" in node and "lut" in node:
            return QWeight(_tensor(node["codes"]), _tensor(node["lut"]),
                           _tensor(node["qmeta"]))
        return {k: _convert(v) for k, v in node.items()}
    return _tensor(node)


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device=None) -> DecoderLM:
    """The port's module holding ``tree``'s values (numpy leaves) on
    ``device`` (the card unless ``device="cpu"``)."""
    return DecoderLM(cfg, _convert(tree), device=device)
