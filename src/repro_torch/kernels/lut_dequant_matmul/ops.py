"""Public wrappers of the fused LUT-dequant matmuls.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the hand-written kernel (``lut_dequant_matmul.py``), or
the call raises.  Outputs are float32 inside, cast to ``out_dtype``
(default: x's dtype; float32 for the dual variants, whose x is codes) as
the reference's wrapper does.  The dual variants return uint8 codes when
given ``out_qmeta`` (the quantize epilogue).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.lut_dequant_matmul import lut_dequant_matmul as _k
from repro_torch.kernels.lut_dequant_matmul.ref import (
    lut_dequant_matmul_dual_gated_ref,
    lut_dequant_matmul_dual_ref,
    lut_dequant_matmul_gated_ref,
    lut_dequant_matmul_ref,
)


def lut_dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                       lut: torch.Tensor, qmeta: torch.Tensor | None = None,
                       *, decode_mode: str = "gather",
                       epilogue: str | None = None, bias=None,
                       transpose_codes: bool = False,
                       out_dtype=None) -> torch.Tensor:
    """``act(x[M, K] @ dec(codes) + bias)``; codes ``[K, N]`` uint8, or
    ``[N, K]`` with ``transpose_codes=True`` (a tied embedding table)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return lut_dequant_matmul_ref(
            x, codes, lut, qmeta, out_dtype=out_dtype, epilogue=epilogue,
            bias=bias, transpose_codes=transpose_codes,
            decode_mode=decode_mode)
    out = _k.launch(x, codes, lut, qmeta, bias,
                    transpose_codes=transpose_codes,
                    decode_mode=decode_mode, epilogue=epilogue)
    return out.to(out_dtype)


def lut_dequant_matmul_gated(x: torch.Tensor, codes_g: torch.Tensor,
                             codes_u: torch.Tensor, lut_g: torch.Tensor,
                             lut_u: torch.Tensor, qmeta_g=None, qmeta_u=None,
                             *, activation: str = "silu",
                             decode_mode: str = "gather",
                             out_dtype=None) -> torch.Tensor:
    """``act(x @ dec(codes_g)) * (x @ dec(codes_u))`` with one shared x:
    the gated-MLP front half in one kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return lut_dequant_matmul_gated_ref(
            x, codes_g, codes_u, lut_g, lut_u, qmeta_g, qmeta_u,
            activation=activation, out_dtype=out_dtype,
            decode_mode=decode_mode)
    out = _k.launch_gated(x, codes_g, codes_u, lut_g, lut_u, qmeta_g,
                          qmeta_u, decode_mode=decode_mode,
                          activation=activation)
    return out.to(out_dtype)


def lut_dequant_matmul_dual(x_codes: torch.Tensor, codes: torch.Tensor,
                            lut_x: torch.Tensor, lut_w: torch.Tensor,
                            qmeta_x=None, qmeta_w=None, *,
                            decode_mode: str = "gather",
                            epilogue: str | None = None, bias=None,
                            out_qmeta=None,
                            out_dtype=torch.float32) -> torch.Tensor:
    """``act(dec_x(x_codes[M, K]) @ dec_w(codes[K, N]) + bias)`` with both
    operands uint8 codes, each decoded through its own table in the
    kernel.  ``out_qmeta`` re-encodes the result: uint8 codes out."""
    if x_codes.device.type == "cpu":
        return lut_dequant_matmul_dual_ref(
            x_codes, codes, lut_x, lut_w, qmeta_x, qmeta_w,
            out_qmeta=out_qmeta, out_dtype=out_dtype, epilogue=epilogue,
            bias=bias, decode_mode=decode_mode)
    out = _k.launch_dual(x_codes, codes, lut_x, lut_w, qmeta_x, qmeta_w,
                         out_qmeta=out_qmeta, bias=bias,
                         decode_mode=decode_mode, epilogue=epilogue)
    return out if out_qmeta is not None else out.to(out_dtype)


def lut_dequant_matmul_dual_gated(x_codes: torch.Tensor, codes_g: torch.Tensor,
                                  codes_u: torch.Tensor, lut_x: torch.Tensor,
                                  lut_g: torch.Tensor, lut_u: torch.Tensor,
                                  qmeta_x=None, qmeta_g=None, qmeta_u=None, *,
                                  activation: str = "silu", out_qmeta=None,
                                  decode_mode: str = "gather",
                                  out_dtype=torch.float32) -> torch.Tensor:
    """The gated-MLP front half on an activation-code operand: one shared
    decode of ``x_codes`` feeds both matmuls; ``out_qmeta`` re-encodes
    ``act(g) * u`` so the down projection reads codes."""
    if x_codes.device.type == "cpu":
        return lut_dequant_matmul_dual_gated_ref(
            x_codes, codes_g, codes_u, lut_x, lut_g, lut_u, qmeta_x, qmeta_g,
            qmeta_u, activation=activation, out_qmeta=out_qmeta,
            out_dtype=out_dtype, decode_mode=decode_mode)
    out = _k.launch_dual_gated(x_codes, codes_g, codes_u, lut_x, lut_g, lut_u,
                               qmeta_x, qmeta_g, qmeta_u, out_qmeta=out_qmeta,
                               decode_mode=decode_mode, activation=activation)
    return out if out_qmeta is not None else out.to(out_dtype)
