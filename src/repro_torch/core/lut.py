"""Generic LUT machinery for Lama bulk operations (port of the JAX
package's ``core/lut.py``; paper §III-IV).

Lama computes an arbitrary two-operand function ``f(a, b)`` by
pre-storing ``f`` as a table: the scalar operand ``a`` selects the DRAM
**row** (one ACT) and each vector element ``b_i`` independently selects a
**column** within the open row.  These helpers are the plain version of
the ``lama_bulk_op`` kernel's semantics and the sizing rules of the
paper's Table II.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


def build_lut(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
              a_bits: int, b_bits: int, dtype=torch.int32,
              device=None) -> torch.Tensor:
    """Materialize ``f`` over all (a, b) code pairs ->
    ``[2**a_bits, 2**b_bits]``: row index = a, column index = b (the
    compute-subarray layout of Fig. 6).  ``f`` receives int32 operand
    values."""
    a = torch.arange(2 ** a_bits, dtype=torch.int32, device=device)[:, None]
    b = torch.arange(2 ** b_bits, dtype=torch.int32, device=device)[None, :]
    return f(a, b).to(dtype)


def mul_lut(bits: int, out_dtype=torch.int32, device=None) -> torch.Tensor:
    """Unsigned bulk-multiplication LUT (case study 1)."""
    return build_lut(lambda a, b: a * b, bits, bits, out_dtype, device)


def lut_apply(table: torch.Tensor, a_codes: torch.Tensor,
              b_codes: torch.Tensor) -> torch.Tensor:
    """Elementwise ``f(a_i, b_i)`` via table gather (broadcasts a vs b)."""
    return table[a_codes.long(), b_codes.long()]


def coalesced_apply(table: torch.Tensor, a_scalar: torch.Tensor,
                    b_vec: torch.Tensor) -> torch.Tensor:
    """One operand-coalesced batch: ``f(a, b_i)`` for all i -- one row
    gather (the ACT analog), then the column gathers."""
    row = table[a_scalar.long()]
    return row[b_vec.long()]


class CoalescedPlan(NamedTuple):
    """Static execution plan for a vector-matrix product done as
    operand-coalesced scalar-vector batches (paper Fig. 2)."""

    num_batches: int          # == len(v): one batch per scalar operand
    batch_size: int           # == number of columns of M
    rows_per_batch: int       # DRAM rows the vector operand spans
    retrievals_per_batch: int  # LUT retrieval (column-access) count


def plan_vector_matrix(vec_len: int, out_len: int, bits: int,
                       row_elems: int = 1024,
                       parallel_degree: int | None = None) -> CoalescedPlan:
    """The coalesced-batch structure of ``v[K] @ M[K, N]``;
    ``parallel_degree`` defaults to the paper's p(bits) (Table II)."""
    p = parallel_degree if parallel_degree is not None else lama_parallelism(bits)
    rows = max(1, -(-out_len // row_elems))
    retrievals = -(-out_len // p)
    return CoalescedPlan(vec_len, out_len, rows, retrievals)


def lama_parallelism(bits: int) -> int:
    """Degree of mat-level parallelism p per bank (paper Table II)."""
    table = {4: 16, 5: 16, 6: 8, 7: 4, 8: 2}
    if bits not in table:
        raise ValueError(f"Lama MUL supports 4..8-bit operands, got {bits}")
    return table[bits]


def icas_per_retrieval(bits: int) -> int:
    """Internal column accesses per LUT retrieval (paper Table II)."""
    return 1 if bits == 4 else 2


def masking_msbs(bits: int) -> int:
    """MSBs of b consumed by the mask logic (0 = mask bypassed)."""
    return {4: 0, 5: 0, 6: 1, 7: 2, 8: 3}[bits]


def vector_matrix_via_lut(v: torch.Tensor, m: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """Reference semantics of case study 1: ``v[K] @ M[K, N]`` as K
    coalesced scalar-vector LUT multiplications summed in int32 (exact
    for integer operands: the table stores full products)."""
    table = mul_lut(bits, torch.int32, v.device)
    return table[v.long()[:, None], m.long()].sum(0, dtype=torch.int32)


def numpy_mul_lut(bits: int) -> np.ndarray:
    """Host-side LUT (data-layout sizing)."""
    a = np.arange(2 ** bits, dtype=np.int64)[:, None]
    b = np.arange(2 ** bits, dtype=np.int64)[None, :]
    return a * b
