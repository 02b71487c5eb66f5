"""Public wrappers of the Lama bulk LUT operation, and the vector-matrix
product of Fig. 2 built on it.

A CPU tensor goes to the plain version, a CUDA tensor to the kernel (or
the call raises).  Both raise on a code outside the table, where the
reference's gather clips silently."""

from __future__ import annotations

import torch

from repro_torch.core.lut import mul_lut
from repro_torch.kernels.lama_bulk_op import lama_bulk_op as _k
from repro_torch.kernels.lama_bulk_op.ref import lama_bulk_op_ref


def _out_of_range(what: str, table: torch.Tensor) -> ValueError:
    return ValueError(f"lama_bulk_op: a {what} code is outside the table "
                      f"{tuple(table.shape)}")


def lama_bulk_op(a_codes, b_codes, table) -> torch.Tensor:
    """``out[g, i] = table[a_codes[g], b_codes[g, i]]``: a_codes [G]
    (integers), b_codes [G, m] (uint8 or int32 on the card), table
    [rows, cols] (int32 or float32 on the card).  Returns [G, m] of the
    table's dtype."""
    a_codes = torch.as_tensor(a_codes, device=table.device)
    if table.device.type == "cpu":
        for what, codes, n in (("row", a_codes, table.shape[0]),
                               ("column", b_codes, table.shape[1])):
            if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) >= n):
                raise _out_of_range(what, table)
        return lama_bulk_op_ref(a_codes, b_codes, table)
    out, bad = _k.launch(a_codes.to(torch.int32).contiguous(), b_codes, table)
    flag = int(bad.item())
    if flag:
        raise _out_of_range("row" if flag & 1 else "column", table)
    return out


def lama_vector_matrix(v, m, bits: int) -> torch.Tensor:
    """``v[K] @ M[K, N]`` as K operand-coalesced LUT batches (one row of
    the ``bits``-bit multiplication table per scalar operand) and a sum
    over K in int32 (paper Fig. 2).  Exact for integer operands."""
    table = mul_lut(bits, torch.int32, device=m.device)
    return torch.sum(lama_bulk_op(v, m, table), dim=0, dtype=torch.int32)


__all__ = ["lama_bulk_op", "lama_bulk_op_ref", "lama_vector_matrix"]
