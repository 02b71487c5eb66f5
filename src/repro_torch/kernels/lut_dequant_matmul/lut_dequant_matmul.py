"""CUDA launch of the fused LUT-dequant matmuls (``csrc/lut_dequant_matmul.cu``).

Counterpart of the JAX package's ``lut_dequant_matmul_kernel``,
``lut_dequant_matmul_gated_kernel`` and their dual-operand variants
(``lut_dequant_matmul_dual_kernel``, ``..._dual_gated_kernel``: x as
uint8 activation codes, optionally uint8 codes out).  There is no
M-bucketing ladder and no autotuner here: the kernels mask their own
ragged edges, so any M, K, N runs without padding or a rebuild.  All four
variants on codes [K, N] run one pair of bodies over their number of
weights (1: plain and dual, 2: gated), sized by :func:`gemm_plan` from
shapes alone (so a captured call replays right): at M <= 8 the blocks of
a column slab split K as one thread-block cluster and sum their partials
in shared memory, at M > 8 the tensor-core tiles split K, with a reduce
pass, only when they fill under half the SMs.  The tied
unembedding (codes [N, K]) streams its code rows at M <= 8 and runs the
one-weight prefill tiles at M > 8, its code tile staged transposed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NAME = "lut_dequant_matmul"
ACTS = {None: 0, "gelu": 1, "silu": 2, "relu": 3}
_SKINNY_M = 8
SLAB_COLS = 128      # columns of a decode block, codes [K, N]
TILE = 128           # prefill block: 128 x 128 outputs a weight
K_STEP = 32          # k rows a pipeline stage holds
MAX_CLUSTER = 8      # the portable thread-block cluster size
STREAM_COLS = 128    # columns of a decode block, codes [N, K]
# prefill blocks an SM holds: the registers and shared memory of one
# weight's tile leave room for two
TILED_BLOCKS_PER_SM = {1: 2, 2: 1}
PATHS = {"skinny": 0, "tiled": 1, "stream_t": 2, "tiled_t": 3}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load(NAME)
    lib.lut_dequant_matmul_launch.argtypes = (
        [_P, _I, _P, _P, _P, _P, _P, _P] + [_I] * 8 + [_P])
    lib.lut_dequant_matmul_launch.restype = _I
    lib.lut_dequant_matmul_gated_launch.argtypes = (
        [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 7 + [_P])
    lib.lut_dequant_matmul_gated_launch.restype = _I
    lib.lut_dequant_matmul_dual_launch.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    lib.lut_dequant_matmul_dual_launch.restype = _I
    lib.lut_dequant_matmul_dual_gated_launch.argtypes = (
        [_P] * 12 + [_I] * 7 + [_P])
    lib.lut_dequant_matmul_dual_gated_launch.restype = _I
    lib.lut_dequant_matmul_smem_bytes.argtypes = [_I, _I, _I]
    lib.lut_dequant_matmul_smem_bytes.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_plan(m: int, k: int, n: int, sms: int, nw: int,
              transposed: bool = False):
    """(splits, k_per_split) of ``nw`` weights' GEMM, from shapes alone.

    M <= 8, codes [K, N]: the blocks of a 128-column slab split K as one
    cluster of ``splits`` blocks, doubled while the grid stays within two
    blocks an SM (the decode body's launch bounds, at either ``nw``) and
    each split keeps 256 rows of K, at most 8.  M <= 8, codes [N, K]: no
    split (the code rows stream over N).  M > 8: split K only when the
    128 x 128 tiles fill under half the SMs, to one wave of the blocks
    the SMs hold (``TILED_BLOCKS_PER_SM``: two of one weight's tiles an
    SM, one of two weights') with 256 rows of each weight a split at
    least; a reduce pass sums.  k_per_split is a multiple of the
    pipeline stage (32 rows)."""
    splits = 1
    if m <= _SKINNY_M:
        if transposed:
            return 1, k
        blocks = math.ceil(n / SLAB_COLS)
        while (splits < MAX_CLUSTER and 2 * blocks * splits <= 2 * sms
               and k >= 2 * splits * 256):
            splits *= 2
    else:
        blocks = math.ceil(n / TILE) * math.ceil(m / TILE)
        if 2 * blocks <= sms:
            splits = max(1, min(TILED_BLOCKS_PER_SM[nw] * sms // blocks,
                                k // (256 * nw)))
    kps = math.ceil(math.ceil(k / splits) / K_STEP) * K_STEP
    return math.ceil(k / kps), kps


def passes(x_dtype) -> int:
    """The tensor-core passes the prefill body computes per multiply-add:
    x_hi*W_hi and x_hi*W_lo, plus x_lo*W_hi unless x is bfloat16 (exact
    in TF32).  TF32 m16n8k8 for float x; bf16 m16n8k16 for activation
    codes (uint8 x), both decoded operands split into bf16 hi + lo
    (:func:`pass_kind`)."""
    return 2 if x_dtype == torch.bfloat16 else 3


def pass_kind(x_dtype) -> str:
    """The tensor-core type of the prefill body's passes for this x."""
    return "bf16" if x_dtype == torch.uint8 else "tf32"


def smem_bytes(path: str, x_dtype, nw: int = 1) -> int:
    """Dynamic shared memory of one block of ``path`` ("skinny",
    "tiled"; "stream_t", "tiled_t": codes [N, K]) for x float32,
    bfloat16 or uint8 codes."""
    kind = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}[x_dtype]
    return int(_lib().lut_dequant_matmul_smem_bytes(PATHS[path], kind, nw))


def _check(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tables(lut, qmeta, alu: bool, dev):
    """(lut, qmeta) as the kernel takes them; the unused one of the pair
    is a zero placeholder so the kernel never reads a null pointer."""
    if alu:
        if qmeta is None:
            raise ValueError("decode_mode='alu' needs qmeta")
        qmeta = qmeta.to(torch.float32).contiguous()
        lut = torch.zeros(256, dtype=torch.float32, device=dev)
    else:
        lut = lut.to(torch.float32).contiguous()
        qmeta = (torch.zeros(4, dtype=torch.float32, device=dev)
                 if qmeta is None else qmeta.to(torch.float32).contiguous())
    _check(lut, "lut", (torch.float32,), (256,))
    _check(qmeta, "qmeta", (torch.float32,), (4,))
    return lut, qmeta


def launch(x, codes, lut, qmeta, bias, *, transpose_codes: bool,
           decode_mode: str, epilogue: str | None) -> torch.Tensor:
    """``act(x @ dec(codes) + bias)`` on the card; returns float32 [M, N]."""
    _check(x, "x", (torch.float32, torch.bfloat16))
    if x.ndim != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    n = codes.shape[0] if transpose_codes else codes.shape[1]
    _check(codes, "codes", (torch.uint8,), (n, k) if transpose_codes else (k, n))
    alu = decode_mode == "alu"
    if decode_mode not in ("gather", "alu"):
        raise ValueError(decode_mode)
    lut, qmeta = _tables(lut, qmeta, alu, x.device)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        _check(bias, "bias", (torch.float32,), (n,))
    splits, kps = _plan(m, k, n, 1, x.device, transpose_codes)
    out, ws = _out_and_ws(m, n, 1, splits, None, x.device)
    err = _lib().lut_dequant_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        lut.data_ptr(), qmeta.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, k, n, int(transpose_codes),
        int(alu), ACTS[epilogue], splits, kps, _build.stream_ptr(x))
    _build.check(err, NAME)
    _build.count_launch(NAME)
    return out


def launch_gated(x, codes_g, codes_u, lut_g, lut_u, qmeta_g, qmeta_u, *,
                 decode_mode: str, activation: str) -> torch.Tensor:
    """``act(x @ dec(codes_g)) * (x @ dec(codes_u))`` on the card."""
    name = NAME + "_gated"
    _check(x, "x", (torch.float32, torch.bfloat16))
    if x.ndim != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    m, k = x.shape
    n = codes_g.shape[1]
    _check(codes_g, "codes_g", (torch.uint8,), (k, n))
    _check(codes_u, "codes_u", (torch.uint8,), (k, n))
    alu = decode_mode == "alu"
    if decode_mode not in ("gather", "alu"):
        raise ValueError(decode_mode)
    lut_g, qmeta_g = _tables(lut_g, qmeta_g, alu, x.device)
    lut_u, qmeta_u = _tables(lut_u, qmeta_u, alu, x.device)
    splits, kps = _plan(m, k, n, 2, x.device)
    out, ws = _out_and_ws(m, n, 2, splits, None, x.device)
    err = _lib().lut_dequant_matmul_gated_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes_g.data_ptr(),
        codes_u.data_ptr(), lut_g.data_ptr(), lut_u.data_ptr(),
        qmeta_g.data_ptr(), qmeta_u.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, k, n, int(alu),
        ACTS[activation], splits, kps, _build.stream_ptr(x))
    _build.check(err, name)
    _build.count_launch(name)
    return out


def _plan(m, k, n, nw, dev, transposed=False):
    return gemm_plan(m, k, n, _num_sms(dev.index or 0), nw, transposed)


def _out_and_ws(m, n, nw, splits, qmeta_out, dev):
    """The output (uint8 codes with an out qmeta, else float32) and the
    split-K partial sums of the prefill path; the decode path sums its
    splits inside the cluster and takes none."""
    out = torch.empty((m, n), device=dev, dtype=(
        torch.uint8 if qmeta_out is not None else torch.float32))
    ws = (torch.empty(nw * splits * m * n, dtype=torch.float32, device=dev)
          if splits > 1 and m > _SKINNY_M else None)
    return out, ws


def _out_qmeta(qmeta_out):
    if qmeta_out is None:
        return None
    qmeta_out = qmeta_out.to(torch.float32).contiguous()
    _check(qmeta_out, "out_qmeta", (torch.float32,), (4,))
    return qmeta_out


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_dual(x_codes, codes, lut_x, lut_w, qmeta_x, qmeta_w, *,
                out_qmeta, bias, decode_mode: str,
                epilogue: str | None) -> torch.Tensor:
    """``act(dec_x(x_codes) @ dec_w(codes) + bias)`` on the card; float32
    [M, N], or uint8 codes under ``out_qmeta``."""
    name = NAME + "_dual"
    _check(x_codes, "x_codes", (torch.uint8,))
    if x_codes.ndim != 2:
        raise ValueError(f"x_codes must be [M, K], got {tuple(x_codes.shape)}")
    m, k = x_codes.shape
    n = codes.shape[1]
    _check(codes, "codes", (torch.uint8,), (k, n))
    if decode_mode not in ("gather", "alu"):
        raise ValueError(decode_mode)
    alu = decode_mode == "alu"
    lut_x, qmeta_x = _tables(lut_x, qmeta_x, alu, x_codes.device)
    lut_w, qmeta_w = _tables(lut_w, qmeta_w, alu, x_codes.device)
    out_qmeta = _out_qmeta(out_qmeta)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        _check(bias, "bias", (torch.float32,), (n,))
    splits, kps = _plan(m, k, n, 1, x_codes.device)
    out, ws = _out_and_ws(m, n, 1, splits, out_qmeta, x_codes.device)
    err = _lib().lut_dequant_matmul_dual_launch(
        x_codes.data_ptr(), codes.data_ptr(), lut_x.data_ptr(),
        lut_w.data_ptr(), qmeta_x.data_ptr(), qmeta_w.data_ptr(),
        _ptr(out_qmeta), _ptr(bias), out.data_ptr(), _ptr(ws), m, k, n,
        int(alu), ACTS[epilogue], splits, kps, _build.stream_ptr(x_codes))
    _build.check(err, name)
    _build.count_launch(name)
    return out


def launch_dual_gated(x_codes, codes_g, codes_u, lut_x, lut_g, lut_u,
                      qmeta_x, qmeta_g, qmeta_u, *, out_qmeta,
                      decode_mode: str, activation: str) -> torch.Tensor:
    """``act(a @ dec(codes_g)) * (a @ dec(codes_u))`` with ``a`` the
    decoded activation codes, on the card; float32 or uint8 codes."""
    name = NAME + "_dual_gated"
    _check(x_codes, "x_codes", (torch.uint8,))
    if x_codes.ndim != 2:
        raise ValueError(f"x_codes must be [M, K], got {tuple(x_codes.shape)}")
    m, k = x_codes.shape
    n = codes_g.shape[1]
    _check(codes_g, "codes_g", (torch.uint8,), (k, n))
    _check(codes_u, "codes_u", (torch.uint8,), (k, n))
    if decode_mode not in ("gather", "alu"):
        raise ValueError(decode_mode)
    alu = decode_mode == "alu"
    dev = x_codes.device
    lut_x, qmeta_x = _tables(lut_x, qmeta_x, alu, dev)
    lut_g, qmeta_g = _tables(lut_g, qmeta_g, alu, dev)
    lut_u, qmeta_u = _tables(lut_u, qmeta_u, alu, dev)
    out_qmeta = _out_qmeta(out_qmeta)
    splits, kps = _plan(m, k, n, 2, dev)
    out, ws = _out_and_ws(m, n, 2, splits, out_qmeta, dev)
    err = _lib().lut_dequant_matmul_dual_gated_launch(
        x_codes.data_ptr(), codes_g.data_ptr(), codes_u.data_ptr(),
        lut_x.data_ptr(), lut_g.data_ptr(), lut_u.data_ptr(),
        qmeta_x.data_ptr(), qmeta_g.data_ptr(), qmeta_u.data_ptr(),
        _ptr(out_qmeta), out.data_ptr(), _ptr(ws), m, k, n, int(alu),
        ACTS[activation], splits, kps, _build.stream_ptr(x_codes))
    _build.check(err, name)
    _build.count_launch(name)
    return out
