"""Plain PyTorch versions of the fused LUT-dequant matmuls: decode the
whole weight, one float32 matmul, then the epilogue.  The CPU path and
the tests run these; on the card they are the yardstick the kernels are
held against."""

from __future__ import annotations

import torch

from repro_torch.core.exponential_quant import decode_meta

F32 = torch.float32


def apply_activation(x: torch.Tensor, kind: str | None) -> torch.Tensor:
    """The epilogue activations.  ``gelu`` is the tanh approximation,
    which is what ``jax.nn.gelu`` computes by default."""
    if kind is None:
        return x
    if kind == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if kind == "silu":
        return x * torch.sigmoid(x)
    if kind == "relu":
        return torch.clamp_min(x, 0.0)
    raise ValueError(kind)


def decode_weight(codes: torch.Tensor, lut: torch.Tensor, qmeta,
                  decode_mode: str = "gather") -> torch.Tensor:
    """Codes to float32: the table gather, or the closed-form ALU decode."""
    if decode_mode == "gather":
        return lut.to(F32)[codes.long()]
    if decode_mode == "alu":
        return decode_meta(codes, qmeta.to(F32))
    raise ValueError(decode_mode)


def lut_dequant_matmul_ref(x, codes, lut, qmeta=None, *, out_dtype=F32,
                           epilogue: str | None = None, bias=None,
                           transpose_codes: bool = False,
                           decode_mode: str = "gather") -> torch.Tensor:
    w = decode_weight(codes, lut, qmeta, decode_mode)
    if transpose_codes:
        w = w.t()
    out = torch.matmul(x.to(F32), w)
    if bias is not None:
        out = out + bias.to(F32)[None, :]
    return apply_activation(out, epilogue).to(out_dtype)


def lut_dequant_matmul_gated_ref(x, codes_g, codes_u, lut_g, lut_u,
                                 qmeta_g=None, qmeta_u=None, *,
                                 activation: str = "silu", out_dtype=F32,
                                 decode_mode: str = "gather") -> torch.Tensor:
    g = lut_dequant_matmul_ref(x, codes_g, lut_g, qmeta_g,
                               decode_mode=decode_mode)
    u = lut_dequant_matmul_ref(x, codes_u, lut_u, qmeta_u,
                               decode_mode=decode_mode)
    return (apply_activation(g, activation) * u).to(out_dtype)
