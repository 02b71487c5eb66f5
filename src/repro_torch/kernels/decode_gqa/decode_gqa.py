"""CUDA launch of flash decode over a paged or a contiguous KV cache
(``csrc/decode_gqa.cu``); counterpart of the JAX package's
``decode_gqa_paged_kernel``, ``decode_gqa_paged_codes_kernel`` and
``decode_gqa_kernel``.

All three run one split-KV body: each row's positions are cut into
partitions, one block each, and a second pass merges the partials
(flash-decoding).  :func:`split_plan` sizes the partitions from static
shapes only; a contiguous row is planned as virtual pages of
``VIRTUAL_PAGE`` positions (:func:`contiguous_plan`).  Head layouts:
those of ``flash_prefill.check_layout`` (g past 8 runs as two row groups
of one KV head, each a block of its own); pages and caches: float32,
bfloat16 or float8_e4m3fn (upcast to float32 after the load), or uint8
codes; any block size."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill.flash_prefill import (
    KV_KIND, PAGE_DTYPES, Q_DTYPES, check_layout, check_paged, check_tables)

NAME = "decode_gqa_paged"
CODES_NAME = NAME + "_codes"
CONTIG_NAME = "decode_gqa"
PART_POSITIONS = 64     # a partition's positions before the grid is thinned
BLOCKS_PER_SM = 8       # the grid is thinned down to this many blocks an SM
VIRTUAL_PAGE = 64       # a contiguous row's positions a page, for split_plan
_P, _I = ctypes.c_void_p, ctypes.c_int


def split_plan(b: int, n_kv: int, max_blk: int, bs: int,
               sms: int) -> tuple[int, int]:
    """(pages per partition, partitions per row) of the paged kernels'
    grid ``(b, n_kv, partitions)``, from static shapes only: never the
    row lengths, which stay on the device (no sync, and a captured CUDA
    graph replays right for any lengths).  A partition starts at about
    PART_POSITIONS positions; while the grid would hold more than
    BLOCKS_PER_SM blocks an SM, partitions double.  Blocks past a row's
    length return at once, so the working blocks are the live
    partitions: at the serving shape (8 rows, 8 KV heads, 64 pages of
    16, lengths up to 732) 4 pages, 16 partitions, 304 working blocks."""
    pages = max(1, PART_POSITIONS // bs)
    while (pages < max_blk
           and b * n_kv * -(-max_blk // pages) > BLOCKS_PER_SM * sms):
        pages *= 2
    pages = min(pages, max_blk)
    return pages, -(-max_blk // pages)


def contiguous_plan(b: int, n_kv: int, s: int, sms: int) -> tuple[int, int]:
    """(positions per partition, partitions per row) of the contiguous
    kernel's grid: :func:`split_plan` over the row cut into virtual
    pages of VIRTUAL_PAGE positions (the last one may end past S; the
    kernel stops at S).  At phase 6's shape (4 rows, 8 KV heads,
    S = 768) 64 positions, 12 partitions."""
    pages, n_split = split_plan(b, n_kv, -(-s // VIRTUAL_PAGE), VIRTUAL_PAGE,
                                sms)
    return pages * VIRTUAL_PAGE, n_split


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_gqa")
    lib.decode_gqa_paged_launch.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 7
        + [ctypes.c_float, _P])
    lib.decode_gqa_paged_launch.restype = _I
    lib.decode_gqa_paged_codes_launch.argtypes = (
        [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P])
    lib.decode_gqa_paged_codes_launch.restype = _I
    lib.decode_gqa_launch.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P, _P] + [_I] * 6 + [ctypes.c_float, _P])
    lib.decode_gqa_launch.restype = _I
    return lib


def _workspace(q, n_split: int):
    """The partials' workspace [B, n_kv, n_split, g, hd + 2], or None
    when one partition covers a row."""
    if n_split == 1:
        return None
    b, n_kv, g, hd = q.shape
    return torch.empty((b, n_kv, n_split, g, hd + 2), dtype=torch.float32,
                       device=q.device)


def _check_split(q, k_pages, v_pages, block_tables):
    """What the split kernels need beyond :func:`check_paged`: their head
    layout, and 16-byte aligned q and pages (a lane loads HD/32
    consecutive elements of a row as one vector, or two 16-byte ones for
    float32 at head_dim 256).  Returns (pages per
    partition, the workspace of the partials, or None when one partition
    covers a row)."""
    b, n_kv, g, hd = q.shape
    check_layout(n_kv, g, hd, k_pages.shape[2])
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and pages must start on a 16-byte boundary")
    max_blk = block_tables.shape[1]
    if max_blk < 1:
        raise ValueError("block_tables has no columns")
    pages, n_split = split_plan(b, n_kv, max_blk, k_pages.shape[1],
                                sm_count(q.device))
    return pages, _workspace(q, n_split)


def launch(q, k_pages, v_pages, block_tables, lengths) -> torch.Tensor:
    """q [B, n_kv, g, hd]; returns float32 of q's shape."""
    check_paged(q, k_pages, v_pages, block_tables, ((lengths, "lengths"),))
    pages, work = _check_split(q, k_pages, v_pages, block_tables)
    b, n_kv, g, hd = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _lib().decode_gqa_paged_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), KV_KIND[k_pages.dtype],
        block_tables.data_ptr(), lengths.data_ptr(),
        None if work is None else work.data_ptr(), out.data_ptr(), b, n_kv,
        g, hd, k_pages.shape[1], block_tables.shape[1], pages,
        1.0 / math.sqrt(hd), _build.stream_ptr(q))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def launch_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut, out_qmeta,
                 block_tables, lengths) -> torch.Tensor:
    """q_codes [B, n_kv, g, hd] and pages uint8; returns uint8 codes of
    q's shape."""
    check_paged(q_codes, k_pages, v_pages, block_tables,
                ((lengths, "lengths"),), q_dtypes=(torch.uint8,),
                page_dtypes=(torch.uint8,))
    pages, work = _check_split(q_codes, k_pages, v_pages, block_tables)
    b, n_kv, g, hd = q_codes.shape
    q_lut, k_lut, v_lut, out_qmeta = check_tables(
        q_codes, n_kv, q_lut, k_lut, v_lut, out_qmeta)
    out = torch.empty(q_codes.shape, dtype=torch.uint8, device=q_codes.device)
    err = _lib().decode_gqa_paged_codes_launch(
        q_codes.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        q_lut.data_ptr(), k_lut.data_ptr(), v_lut.data_ptr(),
        out_qmeta.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        None if work is None else work.data_ptr(), out.data_ptr(), b, n_kv,
        g, hd, k_pages.shape[1], block_tables.shape[1], pages,
        1.0 / math.sqrt(hd), _build.stream_ptr(q_codes))
    _build.check(err, CODES_NAME)
    _build.count_launch(CODES_NAME)
    return out


def launch_contiguous(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """q [B, n_kv, g, hd] float32 or bfloat16; caches [B, S, n_kv, hd]
    float32, bfloat16 or float8_e4m3fn; lengths int32 [B] (any values:
    the kernels clamp them to [0, S]).  Returns float32 of q's shape
    (zeros for a zero-length row)."""
    b, n_kv, g, hd = q.shape
    for t, name in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache"),
                    (lengths, "lengths")):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in Q_DTYPES or k_cache.dtype not in PAGE_DTYPES:
        raise TypeError(f"q dtype must be one of {Q_DTYPES} and caches one "
                        f"of {PAGE_DTYPES}, got {q.dtype}/{k_cache.dtype}")
    if (k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[1] < 1
            or k_cache.shape[3] != hd
            or v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype):
        raise ValueError(f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 [{b}]")
    check_layout(n_kv, g, hd, k_cache.shape[2])
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("q and caches must start on a 16-byte boundary")
    s = k_cache.shape[1]
    part, n_split = contiguous_plan(b, n_kv, s, sm_count(q.device))
    work = _workspace(q, n_split)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _lib().decode_gqa_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(),
        v_cache.data_ptr(), KV_KIND[k_cache.dtype], lengths.data_ptr(),
        None if work is None else work.data_ptr(), out.data_ptr(), b, s, n_kv, g, hd, part, 1.0 / math.sqrt(hd),
        _build.stream_ptr(q))
    _build.check(err, CONTIG_NAME)
    _build.count_launch(CONTIG_NAME)
    return out
