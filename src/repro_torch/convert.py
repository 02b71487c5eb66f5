"""Convert the JAX package's params tree to the port's module.

The caller turns the JAX arrays into numpy arrays (this module imports
nothing of JAX); :func:`params_from_jax` copies them byte for byte into
the family's params module (a
:class:`~repro_torch.models.transformer.DecoderLM`, the vlm's too: its
tree is the decoder's; for the hybrid a
:class:`~repro_torch.models.rglru.HybridLM`; for rwkv a
:class:`~repro_torch.models.rwkv6.RwkvLM`; for the encdec an
:class:`~repro_torch.models.encdec.EncDecLM`), so both sides compute with
the same values.  It handles float leaves
(bfloat16 included), qtensor leaves ``{codes, lut, qmeta}`` (per-tensor
or layer-stacked), the stacked blocks (the encdec's ``enc_blocks`` and
``dec_blocks`` with ``lnx`` / ``xattn``, its ``enc_in`` and
``enc_ln_f``), the hybrid's ``layer_XX`` blocks (``lam``, ``conv_w``,
``conv_b``, ``ba``, ``bx`` among them), rwkv's ``blocks.{ln1, tmix,
ln2, cmix}`` with the LayerNorm biases and the float LoRA and decay
matrices, the qk-norm scales, the tied
``embed.tokens`` table, the untied ``unembed.out``, the empty norm
trees of ``nonparam_ln``, and the calibrated act-quant tables
``blocks.act_q[site] = {lut, qmeta}`` (per KV head for attn_k/attn_v),
so a reference-calibrated tree serves identically in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exponential_quant import QWeight
from repro_torch.models import api as mapi
from repro_torch.models.params import ParamTree


# ml_dtypes' types numpy cannot hand to torch: carried through an
# unsigned view of the same width, byte for byte
_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a) -> torch.Tensor:
    """A numpy array (bfloat16 and float8_e4m3fn included) as a torch
    tensor holding the same bytes."""
    a = np.asarray(a)
    if a.dtype.name in _VIEWS:
        raw, dt = _VIEWS[a.dtype.name]
        return torch.from_numpy(
            np.ascontiguousarray(a).view(raw).copy()).view(dt)
    return torch.from_numpy(np.array(a, copy=True))


def _convert(node):
    if isinstance(node, dict):
        if "codes" in node and "lut" in node:
            return QWeight(tensor_from_numpy(node["codes"]),
                           tensor_from_numpy(node["lut"]),
                           tensor_from_numpy(node["qmeta"]))
        return {k: _convert(v) for k, v in node.items()}
    return tensor_from_numpy(node)


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device=None) -> ParamTree:
    """The port's module holding ``tree``'s values (numpy leaves) on
    ``device`` (the card unless ``device="cpu"``)."""
    return mapi.get_model(cfg).module(cfg, _convert(tree), device=device)
