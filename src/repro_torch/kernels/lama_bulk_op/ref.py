"""Plain PyTorch version of the Lama bulk LUT operation (the semantics of
the JAX package's ``core/lut.py``): ``out[g, i] = table[a[g], b[g, i]]``."""

from __future__ import annotations

import torch


def lama_bulk_op_ref(a_codes: torch.Tensor, b_codes: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    return table[a_codes.long()[:, None], b_codes.long()]
