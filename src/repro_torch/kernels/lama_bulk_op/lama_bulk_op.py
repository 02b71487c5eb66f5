"""CUDA launch of the Lama bulk LUT operation (``csrc/lama_bulk_op.cu``);
counterpart of the JAX package's ``lama_bulk_op_kernel``."""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

NAME = "lama_bulk_op"
MAX_COLS = 8192                 # one staged table row: 32 KB of shared memory
B_DTYPES = (torch.uint8, torch.int32)
TABLE_DTYPES = (torch.int32, torch.float32)     # any 4-byte element
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load(NAME)
    lib.lama_bulk_op_launch.argtypes = [_P] * 5 + [_I] * 6 + [_P]
    lib.lama_bulk_op_launch.restype = _I
    return lib


def launch(a_codes, b_codes, table):
    """a_codes int32 [G]; b_codes uint8 or int32 [G, m]; table int32 or
    float32 [rows, cols <= 8192].  Returns (out [G, m] of the table's
    dtype, bad): ``bad`` is an int32 [1] flag on the device, non-zero
    when a code fell outside the table (bit 0: a row, bit 1: a column);
    such elements are written as 0.  Nothing here waits for the card:
    the caller reads ``bad``."""
    g, m = b_codes.shape
    for t, name in ((a_codes, "a_codes"), (b_codes, "b_codes"),
                    (table, "table")):
        if t.device.type != "cuda" or t.device != table.device:
            raise ValueError(f"{name} must be on {table.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_codes.dtype != torch.int32 or a_codes.shape != (g,):
        raise ValueError(f"a_codes must be int32 [{g}]")
    if b_codes.dtype not in B_DTYPES:
        raise TypeError(f"b_codes dtype must be one of {B_DTYPES}")
    if table.dtype not in TABLE_DTYPES or table.ndim != 2:
        raise TypeError(f"table must be 2-D of a dtype in {TABLE_DTYPES}")
    rows, cols = table.shape
    if cols > MAX_COLS:
        raise ValueError(f"table has {cols} columns > {MAX_COLS}")
    out = torch.empty((g, m), dtype=table.dtype, device=table.device)
    bad = torch.zeros(1, dtype=torch.int32, device=table.device)
    if g == 0 or m == 0:
        return out, bad
    # four codes per load and 16-byte stores when every row starts on a
    # four-code boundary of b and a 16-byte boundary of out
    vec = (m % 4 == 0 and b_codes.data_ptr() % (4 * b_codes.element_size()) == 0
           and out.data_ptr() % 16 == 0)
    err = _lib().lama_bulk_op_launch(
        a_codes.data_ptr(), b_codes.data_ptr(), table.data_ptr(),
        out.data_ptr(), bad.data_ptr(), g, m, rows, cols,
        int(b_codes.dtype == torch.int32), int(vec), _build.stream_ptr(table))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out, bad
