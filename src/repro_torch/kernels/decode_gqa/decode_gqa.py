"""CUDA launch of flash decode over a paged or a contiguous KV cache
(``csrc/decode_gqa.cu``); counterpart of the JAX package's
``decode_gqa_paged_kernel``, ``decode_gqa_paged_codes_kernel`` and
``decode_gqa_kernel``."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.flash_prefill import (
    HEAD_DIM, PAGE_DTYPES, check_paged, check_tables)

NAME = "decode_gqa_paged"
CODES_NAME = NAME + "_codes"
CONTIG_NAME = "decode_gqa"
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
    lib.decode_gqa_launch.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P] + [_I] * 5 + [ctypes.c_float, _P])
    lib.decode_gqa_launch.restype = _I
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


def launch_contiguous(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q [B, n_kv, g, 128]; caches [B, S, n_kv, 128] float32 or
    bfloat16; lengths int32 [B] in [0, S].  Returns float32 of q's
    shape (zeros for a zero-length row)."""
    b, n_kv, g, hd = q.shape
    for t, name in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache"),
                    (lengths, "lengths")):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in PAGE_DTYPES or k_cache.dtype not in PAGE_DTYPES:
        raise TypeError(f"q/cache dtype must be one of {PAGE_DTYPES}, got "
                        f"{q.dtype}/{k_cache.dtype}")
    if (k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[1] < 1
            or k_cache.shape[2:] != (n_kv, hd)
            or v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype):
        raise ValueError(f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 [{b}]")
    if hd != HEAD_DIM or g not in GROUPS:
        raise ValueError(f"unsupported head layout n_kv={n_kv}, g={g}, "
                         f"head_dim={hd}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _lib().decode_gqa_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(),
        v_cache.data_ptr(), int(k_cache.dtype == torch.bfloat16),
        lengths.data_ptr(), out.data_ptr(), b, k_cache.shape[1], n_kv, g, hd,
        1.0 / math.sqrt(hd), _build.stream_ptr(q))
    _build.check(err, CONTIG_NAME)
    _build.count_launch(CONTIG_NAME)
    return out
