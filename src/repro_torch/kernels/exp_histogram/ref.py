"""Plain PyTorch version of the signed exponent histogram (the JAX
oracle's one-hot contraction, the semantics of
``core.exponent_dotprod.signed_histogram`` with lo = 0)."""

from __future__ import annotations

import torch

F32 = torch.float32
_CHUNK_ELEMS = 1 << 26          # one-hot elements per slice of rows


def exp_histogram_ref(vals: torch.Tensor, signs: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """``hist[g, e] = sum_i signs[g, i] * [vals[g, i] == e]`` as a one-hot
    contraction (a value outside [0, num_bins) has a zero one-hot row).
    Rows are taken a slice at a time so the one-hot stays within 2**26
    elements (256 MiB); each row's sum is the same."""
    g, m = vals.shape
    bins = torch.arange(num_bins, device=vals.device)
    step = max(1, _CHUNK_ELEMS // max(1, m * num_bins))
    out = []
    for i in range(0, g, step):
        onehot = (vals[i:i + step, :, None] == bins).to(F32)
        out.append(torch.einsum("gm,gme->ge", signs[i:i + step].to(F32), onehot))
    return torch.cat(out) if out else torch.zeros(0, num_bins, device=vals.device)
