"""Plain PyTorch versions of the fused LUT-dequant matmuls: decode the
whole weight, one float32 matmul, then the epilogue.  The CPU path and
the tests run these; on the card they are the yardstick the kernels are
held against."""

from __future__ import annotations

import torch

from repro_torch.core.exponential_quant import decode_meta, encode_meta

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


def _decode_act(x_codes, lut_x, qmeta_x, decode_mode, k_valid):
    """Activation codes to float32; with ``k_valid`` the K positions at
    or past it are 0.0 *after* decode (a pad byte 0 is a live code)."""
    a = decode_weight(x_codes, lut_x, qmeta_x, decode_mode)
    if k_valid is not None:
        keep = torch.arange(a.shape[-1], device=a.device) < k_valid
        a = torch.where(keep, a, torch.zeros((), dtype=F32, device=a.device))
    return a


def _finish(out, out_qmeta, out_dtype):
    """The quantize epilogue (uint8 codes under ``out_qmeta``) or a cast."""
    if out_qmeta is not None:
        return encode_meta(out, out_qmeta.to(F32))
    return out.to(out_dtype)


def lut_dequant_matmul_dual_ref(x_codes, codes, lut_x, lut_w, qmeta_x=None,
                                qmeta_w=None, *, out_qmeta=None,
                                out_dtype=F32, epilogue: str | None = None,
                                bias=None, decode_mode: str = "gather",
                                k_valid: int | None = None) -> torch.Tensor:
    """Decode both operands, one float32 matmul, then bias, activation
    and (with ``out_qmeta``) the encode to uint8 codes."""
    a = _decode_act(x_codes, lut_x, qmeta_x, decode_mode, k_valid)
    out = torch.matmul(a, decode_weight(codes, lut_w, qmeta_w, decode_mode))
    if bias is not None:
        out = out + bias.to(F32)[None, :]
    return _finish(apply_activation(out, epilogue), out_qmeta, out_dtype)


def lut_dequant_matmul_dual_gated_ref(x_codes, codes_g, codes_u, lut_x, lut_g,
                                      lut_u, qmeta_x=None, qmeta_g=None,
                                      qmeta_u=None, *, activation: str = "silu",
                                      out_qmeta=None, out_dtype=F32,
                                      decode_mode: str = "gather",
                                      k_valid: int | None = None
                                      ) -> torch.Tensor:
    """``act(a @ dec(codes_g)) * (a @ dec(codes_u))`` with one decoded
    activation ``a``, then the optional encode."""
    a = _decode_act(x_codes, lut_x, qmeta_x, decode_mode, k_valid)
    g = torch.matmul(a, decode_weight(codes_g, lut_g, qmeta_g, decode_mode))
    u = torch.matmul(a, decode_weight(codes_u, lut_u, qmeta_u, decode_mode))
    return _finish(apply_activation(g, activation) * u, out_qmeta, out_dtype)
