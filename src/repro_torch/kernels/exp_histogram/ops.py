"""Public wrappers of the signed exponent histogram, and the Eq. 1 term-1
counters built on it.

A CPU tensor goes to the plain version, a CUDA tensor to the kernel (or
the call raises).  Any G and M: the reference's ``bg``/``bm`` blocks,
which must divide them, are TPU tiling."""

from __future__ import annotations

import torch

from repro_torch.core.exponential_quant import ExpQuantParams, split_code
from repro_torch.kernels.exp_histogram import exp_histogram as _k
from repro_torch.kernels.exp_histogram.ref import exp_histogram_ref


def exp_histogram(vals, signs, num_bins: int) -> torch.Tensor:
    """``hist[g, e] = sum_i signs[g, i] * [vals[g, i] == e]``: vals
    [G, M] integers, signs [G, M] (+-1).  Returns float32 [G, num_bins];
    on the card ``num_bins`` <= 512."""
    if vals.device.type == "cpu":
        return exp_histogram_ref(vals, signs, num_bins)
    return _k.launch(vals.to(torch.int32).contiguous(),
                     signs.to(torch.float32).contiguous(), num_bins)


def term1_counts(codes_a: torch.Tensor, pa: ExpQuantParams,
                 codes_w: torch.Tensor, pw: ExpQuantParams) -> torch.Tensor:
    """Paper Eq. 1 term-1 counters for a batch of dot products: signed
    occurrence counts of e_A + e_W.  codes [G, M], aligned pairs.
    Returns float32 [G, (e_max - e_min) of both + 1]."""
    sa, ea = split_code(codes_a, pa)
    sw, ew = split_code(codes_w, pw)
    vals = (ea - pa.e_min) + (ew - pw.e_min)
    bins = (pa.e_max - pa.e_min) + (pw.e_max - pw.e_min) + 1
    signs = (sa * sw).to(torch.float32)
    return exp_histogram(vals, signs, bins)


__all__ = ["exp_histogram", "exp_histogram_ref", "term1_counts"]
