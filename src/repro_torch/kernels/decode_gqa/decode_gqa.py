"""CUDA launch of flash decode over a paged KV cache
(``csrc/decode_gqa.cu``); counterpart of the JAX package's
``decode_gqa_paged_kernel`` and ``decode_gqa_paged_codes_kernel``."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.flash_prefill import (check_paged,
                                                            check_tables)

NAME = "decode_gqa_paged"
CODES_NAME = NAME + "_codes"
GROUPS = (1, 2, 4, 8)
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_gqa")
    lib.decode_gqa_paged_launch.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 6 + [ctypes.c_float, _P])
    lib.decode_gqa_paged_launch.restype = _I
    lib.decode_gqa_paged_codes_launch.argtypes = (
        [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P])
    lib.decode_gqa_paged_codes_launch.restype = _I
    return lib


def launch(q, k_pages, v_pages, block_tables, lengths) -> torch.Tensor:
    """q [B, n_kv, g, 128]; returns float32 of q's shape."""
    check_paged(q, k_pages, v_pages, block_tables, ((lengths, "lengths"),))
    b, n_kv, g, hd = q.shape
    if g not in GROUPS or k_pages.shape[2] != n_kv:
        raise ValueError(f"unsupported head layout n_kv={n_kv}, g={g}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _lib().decode_gqa_paged_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), int(k_pages.dtype == torch.bfloat16),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, n_kv,
        g, hd, k_pages.shape[1], block_tables.shape[1], 1.0 / math.sqrt(hd),
        _build.stream_ptr(q))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def launch_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut, out_qmeta,
                 block_tables, lengths) -> torch.Tensor:
    """q_codes [B, n_kv, g, 128] and pages uint8; returns uint8 codes of
    q's shape."""
    check_paged(q_codes, k_pages, v_pages, block_tables,
                ((lengths, "lengths"),), dtypes=(torch.uint8,))
    b, n_kv, g, hd = q_codes.shape
    if g not in GROUPS or k_pages.shape[2] != n_kv:
        raise ValueError(f"unsupported head layout n_kv={n_kv}, g={g}")
    q_lut, k_lut, v_lut, out_qmeta = check_tables(
        q_codes, n_kv, q_lut, k_lut, v_lut, out_qmeta)
    out = torch.empty(q_codes.shape, dtype=torch.uint8, device=q_codes.device)
    err = _lib().decode_gqa_paged_codes_launch(
        q_codes.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        q_lut.data_ptr(), k_lut.data_ptr(), v_lut.data_ptr(),
        out_qmeta.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, n_kv, g, hd, k_pages.shape[1],
        block_tables.shape[1], 1.0 / math.sqrt(hd), _build.stream_ptr(q_codes))
    _build.check(err, CODES_NAME)
    _build.count_launch(CODES_NAME)
    return out
