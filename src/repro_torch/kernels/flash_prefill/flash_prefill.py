"""CUDA launch of chunked flash prefill over a paged KV cache
(``csrc/flash_prefill.cu``: split-TF32 tensor-core tiles fed by
``cp.async`` page staging); counterpart of the JAX package's
``flash_prefill_paged_kernel`` and ``flash_prefill_paged_codes_kernel``.
Head layouts: head_dim in ``HEAD_DIMS``, any g from 1 to ``MAX_GROUP``
(a block holds ``ROWS_PER_BLOCK // g`` positions x g heads; the rows
past them are padding) and any block size.  Pages: ``PAGE_DTYPES``
(float8_e4m3fn upcast to float32 in the kernel after the load), or
uint8 codes."""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NAME = "flash_prefill_paged"
CODES_NAME = NAME + "_codes"
HEAD_DIMS = (64, 128, 256)  # the head_dims the attention kernels are built for
MAX_GROUP = 16          # query heads a KV head, at most
ROWS_PER_BLOCK = 64     # query rows of a block: 64 // g positions x g heads
KV_TILE = 32            # KV positions a block stages and folds at a time
Q_DTYPES = (torch.float32, torch.bfloat16)
PAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)
# the kernels' page-type argument
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_prefill")
    lib.flash_prefill_paged_launch.argtypes = (
        [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 7
        + [ctypes.c_float, _P])
    lib.flash_prefill_paged_launch.restype = _I
    lib.flash_prefill_paged_codes_launch.argtypes = (
        [_P] * 11 + [_I] * 7 + [ctypes.c_float, _P])
    lib.flash_prefill_paged_codes_launch.restype = _I
    lib.flash_prefill_smem_bytes.argtypes = [_I, _I]
    lib.flash_prefill_smem_bytes.restype = _I
    return lib


def passes(q_dtype, page_dtype) -> tuple[int, int]:
    """The TF32 passes the kernel computes per multiply-add of QK^T and of
    PV: hi*hi, plus hi*lo for a second operand not exact in TF32, plus
    lo*hi for such a first one (bfloat16 and float8_e4m3fn values are
    exact in TF32; P, the softmax weights, never is; codes decode to
    arbitrary float32)."""
    exact = (torch.bfloat16, torch.float8_e4m3fn)
    q_exact = q_dtype in exact
    kv_exact = page_dtype in exact
    return 1 + (not q_exact) + (not kv_exact), 2 + (not kv_exact)


def smem_bytes(page_dtype, hd: int = 128) -> int:
    """Dynamic shared memory of one block for ``page_dtype`` (float32,
    bfloat16, float8_e4m3fn or uint8 codes) at head_dim ``hd``, as the
    kernel is built."""
    kind = {**KV_KIND, torch.uint8: 3}[page_dtype]
    return int(_lib().flash_prefill_smem_bytes(kind, hd))


def _check_launch(q, k_pages, v_pages, block_tables) -> None:
    """What the kernel itself needs: 16-byte aligned q and pages (it
    stages pages with 16-byte ``cp.async`` copies and reads q in 16-byte
    vectors), fewer than 2^26 positions a row, and positions times the
    block size at most 2^32 (its division of a position by the block
    size, a multiply-high, is exact up to there)."""
    for t in (q, k_pages, v_pages):
        if t.data_ptr() % 16:
            raise ValueError("q and pages must start on a 16-byte boundary")
    n = block_tables.shape[1] * k_pages.shape[1]
    if n >= 1 << 26 or n * k_pages.shape[1] > 1 << 32:
        raise ValueError(f"block tables address {n} positions of "
                         f"{k_pages.shape[1]}-position pages: past the "
                         f"kernel's 2^26 positions or 2^32 positions x bs")


def check_paged(q, k_pages, v_pages, block_tables, rows, q_dtypes=Q_DTYPES,
                page_dtypes=PAGE_DTYPES) -> None:
    """Device, dtype, shape and contiguity checks shared with the decode
    kernel's launch; ``q_dtypes``/``page_dtypes`` are the dtypes taken."""
    for t, name in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages"),
                    (block_tables, "block_tables")):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in q_dtypes or k_pages.dtype not in page_dtypes:
        raise TypeError(f"q dtype must be one of {q_dtypes} and pages one "
                        f"of {page_dtypes}, got {q.dtype}/{k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype or v_pages.shape != k_pages.shape:
        raise ValueError("k_pages and v_pages must match in dtype and shape")
    if block_tables.dtype != torch.int32:
        raise TypeError("block_tables must be int32")
    for t, name in rows:
        if t.dtype != torch.int32 or t.shape != (q.shape[0],) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be contiguous int32 [{q.shape[0]}] "
                             f"on {q.device}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or k_pages.shape[-1] != hd:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, got "
                         f"q {hd}, pages {k_pages.shape[-1]}")
    if k_pages.shape[1] < 1:
        raise ValueError("pages hold no position")


def check_layout(n_kv: int, g: int, hd: int, kv_heads: int) -> None:
    """The head layouts the attention kernels take: head_dim in
    HEAD_DIMS, g from 1 to MAX_GROUP, and q's n_kv equal to the cache's
    ``kv_heads``."""
    if hd not in HEAD_DIMS or not 1 <= g <= MAX_GROUP or kv_heads != n_kv:
        raise ValueError(
            f"unsupported head layout n_kv={n_kv}, g={g}, head_dim={hd} "
            f"(cache KV heads {kv_heads}): the CUDA kernels take head_dim "
            f"in {HEAD_DIMS} and g from 1 to {MAX_GROUP}")


def launch(q, k_pages, v_pages, block_tables, q_start, kv_lens) -> torch.Tensor:
    """q [B, S, n_kv, g, hd]; returns float32 of q's shape."""
    check_paged(q, k_pages, v_pages, block_tables,
                ((q_start, "q_start"), (kv_lens, "kv_lens")))
    b, s, n_kv, g, hd = q.shape
    check_layout(n_kv, g, hd, k_pages.shape[2])
    _check_launch(q, k_pages, v_pages, block_tables)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _lib().flash_prefill_paged_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
        v_pages.data_ptr(), KV_KIND[k_pages.dtype],
        block_tables.data_ptr(), q_start.data_ptr(), kv_lens.data_ptr(),
        out.data_ptr(), b, s, n_kv, g, hd, k_pages.shape[1],
        block_tables.shape[1], 1.0 / math.sqrt(hd), _build.stream_ptr(q))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def check_tables(q, n_kv, q_lut, k_lut, v_lut, out_qmeta):
    """The codes mode's tables as the kernels take them: float32,
    contiguous, on q's device; q_lut [256], k_lut/v_lut [n_kv, 256],
    out_qmeta [4]."""
    out = []
    for t, name, shape in ((q_lut, "q_lut", (256,)),
                           (k_lut, "k_lut", (n_kv, 256)),
                           (v_lut, "v_lut", (n_kv, 256)),
                           (out_qmeta, "out_qmeta", (4,))):
        if t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        t = t.to(torch.float32).reshape(shape).contiguous()
        out.append(t)
    return out


def launch_codes(q_codes, k_pages, v_pages, q_lut, k_lut, v_lut, out_qmeta,
                 block_tables, q_start, kv_lens) -> torch.Tensor:
    """q_codes [B, S, n_kv, g, hd] and pages uint8; returns uint8 codes
    of q's shape."""
    check_paged(q_codes, k_pages, v_pages, block_tables,
                ((q_start, "q_start"), (kv_lens, "kv_lens")),
                q_dtypes=(torch.uint8,), page_dtypes=(torch.uint8,))
    b, s, n_kv, g, hd = q_codes.shape
    check_layout(n_kv, g, hd, k_pages.shape[2])
    _check_launch(q_codes, k_pages, v_pages, block_tables)
    q_lut, k_lut, v_lut, out_qmeta = check_tables(
        q_codes, n_kv, q_lut, k_lut, v_lut, out_qmeta)
    out = torch.empty(q_codes.shape, dtype=torch.uint8, device=q_codes.device)
    err = _lib().flash_prefill_paged_codes_launch(
        q_codes.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        q_lut.data_ptr(), k_lut.data_ptr(), v_lut.data_ptr(),
        out_qmeta.data_ptr(), block_tables.data_ptr(), q_start.data_ptr(),
        kv_lens.data_ptr(), out.data_ptr(), b, s, n_kv, g, hd,
        k_pages.shape[1], block_tables.shape[1], 1.0 / math.sqrt(hd),
        _build.stream_ptr(q_codes))
    _build.check(err, CODES_NAME)
    _build.count_launch(CODES_NAME)
    return out
