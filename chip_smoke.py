#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; nothing is caught and passed):
  1. the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/csrc`` (one nvcc per source, in parallel), with
     each source's nvcc seconds;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the serving paths give it, with times: kernel, plain version,
     one PyTorch library call computing the same function (a yardstick
     the port never calls), and the bound (the larger of bytes over the
     memory rate and operations over the float32 rate; for the prefill
     kernels and the LUT GEMMs at M > 8 the TF32 tensor-core products
     they compute over the TF32 rate, with the float32 bound printed
     beside it; bf16 for #3/#4's codes-x passes); the four LUT GEMMs
     (#1-#4) at M = 8, 256 and 2048 with their split plan and the sum of
     x lib over PR 15's shapes (M = 8 and 2048); the paged decode
     kernels at three shapes (the serving rows, short rows, 8 rows at
     4096 positions) with their split-KV grid and, at the serving grid,
     the fixed cost of a call whose lengths are all 0; the contiguous
     decode (#9, on the same split-KV body) at the serving rows over a
     768-position cache with its split grid and x lib; #5, #7 and #9 on
     float8_e4m3fn pages and caches at the serving shapes, each beside
     its float32-page time; then #5-#9 at more head layouts (qwen3-14b:
     n_kv 8, g 5, head_dim 128; minicpm-2b: n_kv 36, g 1, head_dim 64;
     paligemma-3b: n_kv 1, g 8, head_dim 256; recurrentgemma-2b: n_kv 1,
     g 10, head_dim 256; qwen3-1.7b on pages of 128 positions) at the
     serving chunk and the serving rows; the f8 and layout runs are gated
     and timed like the rest but kept out of the ``kernels`` line, which
     stays at qwen3-1.7b's shapes on float32 pages;
  3. path checks: a 2-layer, full-width qwen3-1.7b with the same random
     quantized weights runs one prefill chunk and a few decode steps on
     the card (kernels) and on the CPU (plain versions), first with
     float activations and float32 pages, then with activations and KV
     pages as codes (act-quant tables calibrated on the card and copied
     to the CPU), and float activations over float8_e4m3fn pages; then
     2 layers of olmo-1b, minicpm-2b and qwen3-14b at full width with
     float32 pages; logits must agree within 1e-4 of their scale (the
     three other decoders: or four times the CPU's own spread under a
     last-bit change of the weight tables, if larger; codes: that, at
     least 1e-3; f8 pages: layer 0's page bytes at most 1e-3 one e4m3
     step apart, and the spread taken at the smallest table change that
     flips as many of them as the card did) and greedy tokens must be
     equal where the top-2 gap exceeds twice the tolerance;
  4. serving: full-width qwen3-1.7b (28 layers), weights random from a
     seed and quantized to 7-bit DNA-TEQ codes on the card, serves 12
     requests through ``InferenceServer.generate`` with every launch
     counter read around that run;
  5. codes serving: the same weights with activations and KV pages as
     codes (``act_quant=7, kv_codes=True``), calibrated afresh on the
     card, serve the same 12 requests, launch counters read around that
     run;
  6. contiguous serving: the same weights serve 12 requests in three
     prompt-length buckets through ``InferenceServer.generate_bucketed``
     (contiguous cache, flash decode over it), launch counters read
     around that run; token agreement with ``generate`` is printed, and
     a profile gives #9's device time a decode step;
     phases 4-6 serve with each step replayed as a CUDA graph (the
     default), then serve the same requests again with
     ``cuda_graphs=False`` (the A/B: the token streams must be equal),
     each mode with its rates, graphs captured and capture seconds,
     peak memory and a profile whose #7 / #8 / #9 kernels must number
     what the launch counters say, and whose device busy share is
     printed beside the steps' device span (CUDA events around each
     step);
  7. the paper's Lama primitives at card size: ``lama_vector_matrix``
     (Fig. 2, 8-bit v [4096] and M [4096, 8192]) and ``term1_counts``
     (Eq. 1's T1 counters of a 2048 x 2048 projection at 8 rows), exact
     against integer arithmetic and their plain versions, counters read
     around them;
  8. f8 KV serving: phase 4's weights and requests with
     ``kv_dtype="float8_e4m3fn"``, graphs then eager (equal streams),
     pools a quarter of phase 4's, the float path's launches exact, the
     token agreement with phase 4 printed; then one 4-row bucket of
     ``generate_bucketed`` on an f8 contiguous cache (#9 = 28 x steps);
  9. the other dense decoders: olmo-1b (16 layers), minicpm-2b (40) and
     qwen3-14b (8 of its 40 layers) at full width, 7-bit random weights,
     8 requests each through ``generate`` with float32 pages, every
     request ``ok`` and the float path's launches exact (qwen3-14b's
     untied unembedding through #1's plain layout).
Phase 3 also checks the contiguous path (``prefill`` and
``decode_step``) card against CPU, and its dense decode branch against
the kernel branch on the card.  The line before the last is a JSON
object of per-kernel figures; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12             # H100 SXM TF32 on the tensor cores, dense
BF16_FLOPS = 989e12             # H100 SXM bf16 on the tensor cores, dense
RATES = {"tf32": TF32_FLOPS, "bf16": BF16_FLOPS}
ARCH = "qwen3-1.7b"

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "lut_dequant_matmul": (
        "src/repro_torch/csrc/lut_dequant_matmul.cu",
        "src/repro/kernels/lut_dequant_matmul/lut_dequant_matmul.py:121"),
    "lut_dequant_matmul_gated": (
        "src/repro_torch/csrc/lut_dequant_matmul.cu",
        "src/repro/kernels/lut_dequant_matmul/lut_dequant_matmul.py:207"),
    "flash_prefill_paged": (
        "src/repro_torch/csrc/flash_prefill.cu",
        "src/repro/kernels/flash_prefill/flash_prefill.py:211"),
    "decode_gqa_paged": (
        "src/repro_torch/csrc/decode_gqa.cu",
        "src/repro/kernels/decode_gqa/decode_gqa.py:199"),
    "lut_dequant_matmul_dual": (
        "src/repro_torch/csrc/lut_dequant_matmul.cu",
        "src/repro/kernels/lut_dequant_matmul/lut_dequant_matmul.py:309"),
    "lut_dequant_matmul_dual_gated": (
        "src/repro_torch/csrc/lut_dequant_matmul.cu",
        "src/repro/kernels/lut_dequant_matmul/lut_dequant_matmul.py:397"),
    "flash_prefill_paged_codes": (
        "src/repro_torch/csrc/flash_prefill.cu",
        "src/repro/kernels/flash_prefill/flash_prefill.py:145"),
    "decode_gqa_paged_codes": (
        "src/repro_torch/csrc/decode_gqa.cu",
        "src/repro/kernels/decode_gqa/decode_gqa.py:135"),
    "decode_gqa": (
        "src/repro_torch/csrc/decode_gqa.cu",
        "src/repro/kernels/decode_gqa/decode_gqa.py:256"),
    "lama_bulk_op": (
        "src/repro_torch/csrc/lama_bulk_op.cu",
        "src/repro/kernels/lama_bulk_op/lama_bulk_op.py:39"),
    "exp_histogram": (
        "src/repro_torch/csrc/exp_histogram.cu",
        "src/repro/kernels/exp_histogram/exp_histogram.py:44"),
}
# the kernels each path must launch
FLOAT_PATH = ("lut_dequant_matmul", "lut_dequant_matmul_gated",
              "flash_prefill_paged", "decode_gqa_paged")
CODES_PATH = ("lut_dequant_matmul_dual", "lut_dequant_matmul_dual_gated",
              "flash_prefill_paged_codes", "decode_gqa_paged_codes")
CONTIG_PATH = ("lut_dequant_matmul", "lut_dequant_matmul_gated", "decode_gqa")
LAMA_PATH = ("lama_bulk_op", "exp_histogram")
PAGED_ATTENTION = ("flash_prefill_paged", "decode_gqa_paged",
                   "flash_prefill_paged_codes", "decode_gqa_paged_codes")


class CheckFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def require_close(name: str, label: str, out, ref) -> float:
    """The float kernels' gate: within 1e-4 of the plain version's
    largest magnitude.  Returns the max abs error."""
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    err = (out - ref).abs().max().item()
    require(err <= tol, f"{name} {label}: max err {err} > {tol}")
    return err


def codes_err(out, ref, label: str) -> float:
    """The uint8 tolerance: at most 1e-3 of the codes differ, each by one
    rounding step (a last-bit float difference moves a value across a
    rounding boundary now and then).  Returns the differing fraction."""
    from repro_torch.core import exponential_quant as eq

    require(out.dtype == ref.dtype and out.shape == ref.shape,
            f"{label}: {out.dtype}{tuple(out.shape)} vs "
            f"{ref.dtype}{tuple(ref.shape)}")
    require(bool(eq.codes_agree(out, ref).all()),
            f"{label}: codes more than one rounding step apart")
    frac = (out != ref).float().mean().item()
    require(frac <= 1e-3, f"{label}: {frac:.2e} of the codes differ > 1e-3")
    return frac


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing --

def time_ms(fn, iters: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after a
    warm-up.  Before each launch the stream sleeps (``torch.cuda._sleep``,
    about a millisecond) while the host enqueues ``fn``, so the CUDA
    events around it time the device's work, not the wrapper's host
    time.  ``flush`` (a 64 MiB buffer) is overwritten first, so weights
    come from device memory as on the serving path, not from the 50 MB
    L2."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound_ms(nbytes: float, flops: float,
             rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Tally:
    """Per-kernel sums over the shapes tested, and for the LUT GEMMs the
    sums over PR 15's phase-2 shapes (``core``), which compare with the
    x lib recorded before M = 256 was added."""

    def __init__(self):
        self.rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                             bound_ms=0.0, library_ms=0.0, bytes_ms=0.0,
                             ops_ms=0.0) for k in KERNELS}
        self.core = {k: [0.0, 0.0] for k in KERNELS}

    def add(self, name, err, ms, plain_ms, lib_ms, nbytes, flops, label,
            tc_flops=None, tc_rate=TF32_FLOPS, core=False):
        """``flops``: the function's float32 operations; ``tc_flops``,
        for a kernel on the tensor cores, the operations it computes
        there at ``tc_rate`` (its bound), with the float32 bound printed
        beside it."""
        r = self.rows[name]
        b, by = bound_ms(nbytes, flops)
        f32 = ""
        ops = flops / F32_FLOPS * 1e3
        if tc_flops is not None:
            f32 = f", float32 bound {b:.4f} ms ({by})"
            ops = tc_flops / tc_rate * 1e3
            b, by = bound_ms(nbytes, tc_flops, tc_rate)
            kind = "TF32" if tc_rate == TF32_FLOPS else "bf16"
            by = f"{kind} {by}" if by == "operations" else by
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += lib_ms
        r["bound_ms"] += b
        r["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        r["ops_ms"] += ops
        if core:
            self.core[name][0] += ms
            self.core[name][1] += lib_ms
        print(f"  {name:26s} {label:34s} err {err:.3e}  kernel {ms:9.4f} ms"
              f"  plain {plain_ms:9.4f} ms  library {lib_ms:9.4f} ms"
              f"  bound {b:8.4f} ms ({by}{f32})", flush=True)

    def print_core(self, names) -> None:
        for name in names:
            ms, lib = self.core[name]
            print(f"  {name}: {ms:.4f} ms over PR 15's shapes, library "
                  f"{lib:.4f} ms, x lib {ms / lib:.2f}", flush=True)


# ----------------------------------------------- prefill attention --

def prefill_shapes(dev, gen, n_pages: int, bs: int):
    """The phase-2 shapes of the prefill kernels over a pool of
    ``n_pages`` pages: (label, S, q_start, kv_lens, block table).  The
    serving chunk (8 rows x 256 queries at mixed offsets; row 6 a cold
    start, row 7 nothing to do), the short end of the engine's chunk
    ladder (S = 16, the same rows), and a long context (one row, its
    256-query chunk at 3840 over 4096 positions)."""
    import torch

    i32 = dict(dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm[: 8 * 64].reshape(8, 64).to(torch.int32).contiguous()
    bt_long = perm[: 4096 // bs].reshape(1, -1).to(torch.int32).contiguous()
    starts = torch.tensor([0, 256, 512, 768, 128, 384, 0, 300], **i32)
    out = []
    for label, s, valid, q_start, table in (
            ("8 rows x 256 queries, 64 pages", 256,
             [256, 256, 256, 200, 256, 17, 256, 0], starts, bt),
            ("8 rows x 16 queries, 64 pages", 16,
             [16, 16, 16, 16, 16, 9, 16, 0], starts, bt),
            ("1 row x 256 queries at 3840", 256, [256],
             torch.tensor([3840], **i32), bt_long)):
        valid = torch.tensor(valid, **i32)
        kv_lens = torch.where(valid > 0, q_start + valid, 0).to(torch.int32)
        out.append((label, s, q_start, kv_lens, table))
    return out


def prefill_work(q_start, kv_lens, s: int, n_kv: int, g: int, bs: int,
                 passes, hd: int = 128):
    """(pages read, float32 operations, TF32 operations computed, block-
    tiles) of one prefill call: each query attends min(q_pos + 1,
    kv_len) positions, 4 * hd operations each (QK and PV); the kernel
    computes ``passes`` = (QK, PV) TF32 products per multiply-add, and a
    block of ROWS_PER_BLOCK query rows folds KV_TILE positions at a time
    up to the last position one of its rows may see."""
    from repro_torch.kernels.flash_prefill import flash_prefill as fp

    rows = list(zip(q_start.tolist(), kv_lens.tolist()))
    seen = sum(min(qs + i + 1, kl) for qs, kl in rows for i in range(s))
    pages = sum(-(-kl // bs) for _, kl in rows)
    qpb = fp.ROWS_PER_BLOCK // g
    tiles = n_kv * sum(-(-min(kl, qs + min(s, z + qpb)) // fp.KV_TILE)
                       for qs, kl in rows if kl > 0 for z in range(0, s, qpb))
    unit = n_kv * g * hd * seen
    return pages, 4.0 * unit, 2.0 * unit * sum(passes), tiles


def sdpa_prefill(qf, kd, vd, table, q_start, kv_lens, bs: int):
    """The yardstick: one SDPA call over the gathered float32 pages of
    ``table`` with the prefill mask; returns it as a closure."""
    import torch

    b, s, n_kv, g, hd = qf.shape
    t = table.shape[1] * bs
    kk = kd[table.long()].reshape(b, t, n_kv, hd).permute(0, 2, 1, 3)
    vv = vd[table.long()].reshape(b, t, n_kv, hd).permute(0, 2, 1, 3)
    kk = kk.repeat_interleave(g, 1).contiguous()
    vv = vv.repeat_interleave(g, 1).contiguous()
    qpos = q_start[:, None].long() + torch.arange(s, device=qf.device)[None]
    kvpos = torch.arange(t, device=qf.device)
    mask = ((kvpos[None, None] <= qpos[:, :, None])
            & (kvpos[None, None] < kv_lens[:, None, None].long()))[:, None]
    qs = qf.reshape(b, s, n_kv * g, hd).permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qs, kk, vv, attn_mask=mask)


def lut_launch_module():
    """The LUT GEMMs' launch module (the package's ``lut_dequant_matmul``
    is the wrapper function)."""
    return importlib.import_module(
        "repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul")


def plan_label(m: int, k: int, n: int, nw: int, transposed=False) -> str:
    """The split plan the LUT GEMM wrappers launch for these shapes."""
    import torch

    lk = lut_launch_module()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits, kps = lk.gemm_plan(m, k, n, sms, nw, transposed)
    if m <= 8 and transposed:
        return f"{-(-n // lk.STREAM_COLS)} blocks of 8 x 16 columns"
    if m <= 8:
        return (f"{-(-n // lk.SLAB_COLS)} slabs x cluster of {splits} "
                f"({kps} rows of K each)")
    tiles = -(-n // lk.TILE) * -(-m // lk.TILE)
    return f"{tiles} tiles x {splits} split{'s' if splits > 1 else ''}"


def gemm_build_report(log: str) -> None:
    """Registers, spills and dynamic shared memory of each LUT GEMM
    instantiation (``mm_skinny`` / ``mm_tiled`` over x type and weights,
    ``mm_tiled`` on codes [N, K] and ``mm_stream_t`` over x type), from
    nvcc's ``-Xptxas -v`` output."""
    import re

    import torch

    lk = lut_launch_module()

    kinds = {"f": ("float32", torch.float32),
             "13__nv_bfloat16": ("bfloat16", torch.bfloat16),
             "h": ("uint8 codes", torch.uint8)}
    paths = {"mm_skinny": "skinny", "mm_tiled": "tiled",
             "mm_stream_t": "stream_t"}
    fn, spill = None, "no spills"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d(mm_skinny|mm_tiled|"
                      r"mm_stream_t)I(\w+?)(?:Li(\d)E)?(?:Lb(\d)E)?EEv", line)
        if m:
            fn, spill = m.groups(), "no spills"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and m.groups() != ("0", "0"):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            name, xt, nw, trans = fn
            x_name, x_dt = kinds.get(xt, (xt, None))
            nw = int(nw or 1)
            path = "tiled_t" if trans == "1" else paths[name]
            layout = ", codes [N, K]" if trans == "1" else ""
            smem = lk.smem_bytes(path, x_dt, nw) if x_dt is not None else "?"
            print(f"    {name} x {x_name}, NW={nw}{layout}: {m.group(1)} "
                  f"registers, {spill}, dynamic shared memory {smem} B per "
                  f"block", flush=True)
            fn = None


def prefill_build_report(log: str) -> None:
    """Registers and spills of each prefill instantiation (head_dim, q
    and page types) from nvcc's ``-Xptxas -v`` output, and its dynamic
    shared memory per block."""
    import re

    import torch

    from repro_torch.kernels.flash_prefill import flash_prefill as fp

    f8 = torch.float8_e4m3fn
    kinds = {"hh": ("uint8", torch.uint8), "ff": ("float32", torch.float32),
             "f13__nv_bfloat16": ("float32", torch.bfloat16),
             "13__nv_bfloat16f": ("bfloat16", torch.float32),
             "13__nv_bfloat16S1_": ("bfloat16", torch.bfloat16),
             "f13__nv_fp8_e4m3": ("float32", f8),
             "13__nv_bfloat1613__nv_fp8_e4m3": ("bfloat16", f8)}
    fn, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*prefill_kernelILi(\d+)E"
                      r"(\w+?)EEv", line)
        if m:
            hd, fn, spill = int(m.group(1)), m.group(2), "no spills"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and m.groups() != ("0", "0"):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in kinds:
            q_name, page = kinds[fn]
            print(f"    prefill_kernel hd {hd}, q {q_name}, pages "
                  f"{str(page)[6:]}: {m.group(1)} registers, {spill}, dynamic "
                  f"shared memory {fp.smem_bytes(page, hd)} B per block",
                  flush=True)
            fn = None


# --------------------------------------------------- paged decode --

def decode_shapes(dev, gen, n_pages: int):
    """The phase-2 shapes of the paged decode kernels over a pool of
    ``n_pages`` pages of 16: (label, block table, lengths).  The serving
    rows (8 rows, lengths up to 732 over 64-page tables), short rows
    (lengths up to 64 over 8-page tables, the width the engine's pow2
    ladder gives them) and a long context (8 rows at 4096 positions,
    256 pages each)."""
    import torch

    i32 = dict(dtype=torch.int32, device=dev)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).to(torch.int32)
    out = []
    for label, width, lengths in (
            ("8 rows, lengths <= 732, 64 pages", 64,
             [17, 732, 400, 0, 256, 33, 600, 129]),
            ("8 rows, lengths <= 64, 8 pages", 8,
             [1, 17, 64, 0, 33, 48, 5, 64]),
            ("8 rows at 4096, 256 pages", 256, [4096] * 8)):
        table = perm[: 8 * width].reshape(8, width).contiguous()
        out.append((label, table, torch.tensor(lengths, **i32)))
    return out


def decode_split(table, lengths, n_kv: int, bs: int) -> str:
    """The split-KV grid the wrapper launches for these shapes, and how
    many of its blocks have work (their partition starts before the
    row's length)."""
    # the launch module (the package's ``decode_gqa`` is the wrapper)
    dk = importlib.import_module("repro_torch.kernels.decode_gqa.decode_gqa")
    b, max_blk = table.shape
    pages, n_split = dk.split_plan(b, n_kv, max_blk, bs,
                                   dk.sm_count(table.device))
    working = n_kv * sum(-(-int(n) // (pages * bs)) for n in lengths.tolist())
    merge = "merge pass" if n_split > 1 else "no merge pass"
    return (f"{pages} pages x {n_split} partitions, grid ({b}, {n_kv}, "
            f"{n_split}), {working} working blocks, {merge}")


def contiguous_split(lengths, n_kv: int, s: int) -> str:
    """The split-KV grid the contiguous wrapper launches over a cache of
    ``s`` positions (virtual pages of 64), and its working blocks."""
    dk = importlib.import_module("repro_torch.kernels.decode_gqa.decode_gqa")
    b = lengths.shape[0]
    part, n_split = dk.contiguous_plan(b, n_kv, s, dk.sm_count(lengths.device))
    working = n_kv * sum(-(-min(max(int(n), 0), s) // part)
                         for n in lengths.tolist())
    merge = "merge pass" if n_split > 1 else "no merge pass"
    return (f"{part} positions x {n_split} partitions, grid ({b}, {n_kv}, "
            f"{n_split}), {working} working blocks, {merge}")


def decode_work(lengths, bs: int, n_kv: int, g: int, hd: int = 128):
    """(positions read, page ids read, float32 operations) of one decode
    call: the positions below each row's length (a page past it, or its
    tail, is never needed), the ids of the pages that hold them, and
    4 * hd operations per position and query head (QK and PV)."""
    n = int(lengths.sum())
    pages = sum(-(-int(t) // bs) for t in lengths.tolist())
    return n, pages, 4.0 * n_kv * g * hd * n


def decode_floor(name: str, fn, args, flush) -> None:
    """The fixed cost of a paged decode call at the serving grid: every
    length 0, so every split block returns at once and the merge pass
    writes zeros."""
    import torch

    b = args[0].shape[0]
    zeros = torch.zeros(b, dtype=torch.int32, device=args[0].device)
    t = time_ms(lambda: fn(*args, zeros), flush=flush)
    print(f"  {name} fixed cost (serving grid, every length 0): {t:.4f} ms",
          flush=True)


def sdpa_decode(qf, kd, vd, table, lengths):
    """The yardstick: one SDPA call over the gathered float32 pages of
    ``table`` with the length mask; returns it as a closure."""
    import torch

    b, n_kv, g, hd = qf.shape
    t = table.shape[1] * kd.shape[1]
    kk = kd[table.long()].reshape(b, t, n_kv, hd).permute(0, 2, 1, 3)
    vv = vd[table.long()].reshape(b, t, n_kv, hd).permute(0, 2, 1, 3)
    kk = kk.repeat_interleave(g, 1).contiguous()
    vv = vv.repeat_interleave(g, 1).contiguous()
    mask = (torch.arange(t, device=qf.device)[None]
            < lengths[:, None].long())[:, None, None]
    qs = qf.reshape(b, n_kv * g, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qs, kk, vv, attn_mask=mask)


def decode_build_report(log: str) -> None:
    """Registers, spills and static shared memory of each split-KV decode
    instantiation (head_dim, the g instantiation, q and page or cache
    types: the paged kernels #7/#8 and the contiguous #9 run the same
    ones) and merge pass, from nvcc's ``-Xptxas -v`` output."""
    import re

    kinds = {"ff": "q float32, KV float32",
             "13__nv_bfloat16f": "q bfloat16, KV float32",
             "f13__nv_bfloat16": "q float32, KV bfloat16",
             "13__nv_bfloat16S1_": "q bfloat16, KV bfloat16",
             "f13__nv_fp8_e4m3": "q float32, KV float8_e4m3fn",
             "13__nv_bfloat1613__nv_fp8_e4m3": "q bfloat16, KV float8_e4m3fn",
             "hh": "codes", "Lb0": "float32 out", "Lb1": "codes out"}
    fn, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN5split12(split|merge)"
                      r"_kernelILi(\d+)E(?:Li(\d)E)?(\w+?)EE+v", line)
        if m:
            kind, hd, g, types = m.groups()
            fn = (kind, f"hd {hd}" + (f" G={g}" if g else ""), types)
            spill = "no spills"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and m.groups() != ("0", "0"):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"    {fn[0]}_kernel {fn[1]} {kinds.get(fn[2], fn[2])}: "
                  f"{m.group(1)} registers, {spill}, static shared memory "
                  f"{smem.group(1) if smem else 0} B per block", flush=True)
            fn = None


# --------------------------------------------------- phase 2: kernels --

def check_kernels(tally: Tally) -> None:
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.decode_gqa import decode_gqa, decode_gqa_paged
    from repro_torch.kernels.decode_gqa.ref import (decode_gqa_paged_ref,
                                                    decode_gqa_ref)
    from repro_torch.kernels.flash_prefill import flash_prefill as fp
    from repro_torch.kernels.flash_prefill import flash_prefill_paged
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_paged_ref
    from repro_torch.kernels.lut_dequant_matmul import (
        lut_dequant_matmul, lut_dequant_matmul_gated)
    from repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul import (
        passes)
    from repro_torch.kernels.lut_dequant_matmul.ref import (
        decode_weight, lut_dequant_matmul_gated_ref, lut_dequant_matmul_ref)

    dev = torch.device("cuda")
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def qweight(*shape):
        """A random weight (std 0.02) fitted and encoded by the port's
        own quantizer: realistic codes and table."""
        codes, p = eq.quantize(rnd(*shape, scale=0.02), 7)
        return codes, eq.decode_table(p)

    # float32 FMA (M <= 8) or split tensor-core passes (M > 8; bf16 for
    # the tied unembedding) vs float32 matmul in the plain version, K <=
    # 6144 terms
    def mm_tol(ref):
        return 1e-4 * max(1.0, ref.abs().max().item())

    # the plain GEMM (#1): a decode step, an engine tail chunk (8 slots x
    # 32 tokens) and a full chunk, at the q, k/v and down projections
    x_dt = torch.bfloat16     # the full config's compute dtype
    for m in (8, 256, 2048):
        for k, n in ((2048, 2048), (2048, 1024), (6144, 2048)):
            x = rnd(m, k, dtype=x_dt)
            c, lut = qweight(k, n)
            out = lut_dequant_matmul(x, c, lut, out_dtype=torch.float32)
            ref = lut_dequant_matmul_ref(x, c, lut)
            err = (out - ref).abs().max().item()
            require(err <= mm_tol(ref), f"lut_dequant_matmul M={m} K={k} "
                    f"N={n}: max err {err} > {mm_tol(ref)}")
            w = decode_weight(c, lut, None)
            xf = x.float()
            tally.add("lut_dequant_matmul", err,
                      time_ms(lambda: lut_dequant_matmul(x, c, lut, out_dtype=f32), flush=flush),
                      time_ms(lambda: lut_dequant_matmul_ref(x, c, lut), flush=flush),
                      time_ms(lambda: torch.matmul(xf, w), flush=flush),
                      m * k * 2 + k * n + 1024 + m * n * 4, 2.0 * m * k * n,
                      f"M={m} K={k} N={n}, {plan_label(m, k, n, 1)}",
                      tc_flops=passes(x_dt) * 2.0 * m * k * n if m > 8 else None,
                      core=m != 256)
    # tied unembedding: codes [V, D], M = slots
    m, k, n = 8, 2048, 151936
    x = rnd(m, k, dtype=x_dt)
    c, lut = qweight(n, k)
    out = lut_dequant_matmul(x, c, lut, transpose_codes=True,
                             out_dtype=torch.float32)
    ref = lut_dequant_matmul_ref(x, c, lut, transpose_codes=True)
    err = (out - ref).abs().max().item()
    require(err <= mm_tol(ref), f"transposed unembedding: max err {err}")
    wt = decode_weight(c, lut, None).t()
    xf = x.float()
    tally.add("lut_dequant_matmul", err,
              time_ms(lambda: lut_dequant_matmul(x, c, lut, transpose_codes=True,
                                               out_dtype=f32)),
              time_ms(lambda: lut_dequant_matmul_ref(x, c, lut, transpose_codes=True)),
              time_ms(lambda: torch.matmul(xf, wt)),
              m * k * 2 + k * n + 1024 + m * n * 4, 2.0 * m * k * n,
              f"M={m} K={k} N={n} transposed, {plan_label(m, k, n, 1, True)}",
              core=True)
    del wt, w

    # the gated GEMM (#2): a decode step, an engine tail chunk (8 slots x
    # 32 tokens) and a full chunk; M > 8 on the TF32 tensor cores
    for m in (8, 256, 2048):
        k, n = 2048, 6144
        x = rnd(m, k, dtype=x_dt)
        (cg, lg), (cu, lu) = qweight(k, n), qweight(k, n)
        out = lut_dequant_matmul_gated(x, cg, cu, lg, lu,
                                       out_dtype=torch.float32)
        ref = lut_dequant_matmul_gated_ref(x, cg, cu, lg, lu)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item()
        require(err <= tol, f"gated M={m}: max err {err} > {tol}")
        wgu = torch.cat([decode_weight(cg, lg, None),
                         decode_weight(cu, lu, None)], dim=1)
        xf = x.float()
        tally.add("lut_dequant_matmul_gated", err,
                  time_ms(lambda: lut_dequant_matmul_gated(x, cg, cu, lg, lu,
                                                   out_dtype=f32), flush=flush),
                  time_ms(lambda: lut_dequant_matmul_gated_ref(x, cg, cu, lg, lu),
                          flush=flush),
                  time_ms(lambda: torch.matmul(xf, wgu), flush=flush),
                  m * k * 2 + 2 * k * n + 2048 + m * n * 4, 4.0 * m * k * n,
                  f"M={m} K={k} N={n}, {plan_label(m, k, n, 2)}",
                  tc_flops=passes(x_dt) * 4.0 * m * k * n if m > 8 else None)
        del wgu

    # paged attention at the serving width: 8 rows, n_kv 8, g 2, hd 128,
    # block 16, float32 pages, bf16 queries
    b, n_kv, g, hd, bs = 8, 8, 2, 128, 16
    max_blk = 64
    n_pages = 1 + b * max_blk
    kp, vp = rnd(n_pages, bs, n_kv, hd), rnd(n_pages, bs, n_kv, hd)

    # prefill: the serving chunk, a short chunk and a long context;
    # softmax-weighted averages of O(1) values, float32 exp and sums in
    # another order, the products split TF32 (~2^-20 of float32)
    passes = fp.passes(x_dt, kp.dtype)
    for label, s, q_start, kv_lens, table in prefill_shapes(
            dev, gen, n_pages, bs):
        q = rnd(len(q_start), s, n_kv, g, hd, dtype=x_dt)
        args = (q, kp, vp, table, q_start, kv_lens)
        out = flash_prefill_paged(*args)
        ref = flash_prefill_paged_ref(*args)
        err = (out - ref).abs().max().item()
        require(err <= 1e-4, f"flash_prefill_paged {label}: max err {err} "
                f"> 1e-4")
        pages, flops, tc_flops, tiles = prefill_work(
            q_start, kv_lens, s, n_kv, g, bs, passes)
        tally.add("flash_prefill_paged", err,
                  time_ms(lambda: flash_prefill_paged(*args), flush=flush),
                  time_ms(lambda: flash_prefill_paged_ref(*args), flush=flush),
                  time_ms(sdpa_prefill(q.float(), kp, vp, table, q_start,
                                       kv_lens, bs), flush=flush),
                  q.numel() * 2 + pages * bs * n_kv * hd * 4 * 2
                  + q.numel() * 4 + table.numel() * 4, flops,
                  f"{label}, {tiles} block-tiles", tc_flops=tc_flops)

    # paged decode: the serving rows, short rows and a long context over
    # a pool of 1 + 8 x 256 pages; #9 below reuses the serving rows
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_dec = 1 + b * 4096 // bs
    kpd, vpd = rnd(n_dec, bs, n_kv, hd), rnd(n_dec, bs, n_kv, hd)
    serving = None
    for label, table, lens in decode_shapes(dev, gen, n_dec):
        q = rnd(b, n_kv, g, hd, dtype=x_dt)
        serving = serving or (q, lens, table)
        args = (q, kpd, vpd, table, lens)
        out = decode_gqa_paged(*args)
        ref = decode_gqa_paged_ref(*args)
        err = (out - ref).abs().max().item()
        require(err <= 1e-4, f"decode_gqa_paged {label}: max err {err} > 1e-4")
        require(bool(torch.all(out[lens == 0] == 0)),
                f"decode_gqa_paged {label}: a zero-length row is not zeros")
        n_pos, pages, flops = decode_work(lens, bs, n_kv, g)
        tally.add("decode_gqa_paged", err,
                  time_ms(lambda: decode_gqa_paged(*args), flush=flush),
                  time_ms(lambda: decode_gqa_paged_ref(*args), flush=flush),
                  time_ms(sdpa_decode(q.float(), kpd, vpd, table, lens),
                          flush=flush),
                  q.numel() * 2 + n_pos * n_kv * hd * 4 * 2
                  + q.numel() * 4 + pages * 4 + b * 4, flops,
                  f"{label}, {decode_split(table, lens, n_kv, bs)}")
    qd, lengths, table = serving
    decode_floor("decode_gqa_paged", decode_gqa_paged, (qd, kpd, vpd, table),
                 flush)
    del kpd, vpd
    qds = qd.float().reshape(b, n_kv * g, 1, hd)

    # contiguous flash decode (#9) at #7's shape: the same rows, lengths
    # and queries over [B, 768, n_kv, hd] caches, float32 and bfloat16;
    # the split-KV body with contiguous addressing
    s_max = 768
    n_read = int(lengths.sum())
    maskc = (torch.arange(s_max, device=dev)[None] < lengths[:, None].long())
    maskc = maskc[:, None, None]
    for cdt in (torch.float32, torch.bfloat16):
        kc, vc = rnd(b, s_max, n_kv, hd, dtype=cdt), rnd(b, s_max, n_kv, hd, dtype=cdt)
        out = decode_gqa(qd, kc, vc, lengths)
        ref = decode_gqa_ref(qd, kc, vc, lengths)
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item()
        require(err <= tol, f"decode_gqa {cdt}: max err {err} > {tol}")
        kk = kc.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        vv = vc.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        qdc = qds.to(cdt)
        tally.add("decode_gqa", err,
                  time_ms(lambda: decode_gqa(qd, kc, vc, lengths), flush=flush),
                  time_ms(lambda: decode_gqa_ref(qd, kc, vc, lengths),
                          flush=flush),
                  time_ms(lambda: sdpa(qdc, kk, vv, attn_mask=maskc), flush=flush),
                  qd.numel() * 2 + n_read * n_kv * hd * kc.element_size() * 2
                  + qd.numel() * 4 + b * 4,
                  4.0 * n_kv * g * hd * n_read,
                  f"B={b} S={s_max} lengths<=732 {str(cdt)[6:]}, "
                  f"{contiguous_split(lengths, n_kv, s_max)}")
        del kk, vv
    r = tally.rows["decode_gqa"]
    print(f"  decode_gqa: {r['ms']:.4f} ms over its shapes, library "
          f"{r['library_ms']:.4f} ms, x lib {r['ms'] / r['library_ms']:.2f}",
          flush=True)


def check_f8_kernels(tally: Tally) -> None:
    """#5, #7 and #9 on float8_e4m3fn pages and caches at phase 2's
    serving shapes (the serving chunk; the serving rows over its table;
    8 rows over a 768-position cache), bf16 queries: within 1e-4 of the
    plain version's largest magnitude, timed with their bound at 1 byte
    an element and SDPA on the gathered, upcast KV, in a tally of their
    own (the ``kernels`` line stays at float32 pages).  Each also times
    the kernel on the same values as float32 pages, for the ratio."""
    import torch

    from repro_torch.kernels.decode_gqa import decode_gqa, decode_gqa_paged
    from repro_torch.kernels.decode_gqa.ref import (decode_gqa_paged_ref,
                                                    decode_gqa_ref)
    from repro_torch.kernels.flash_prefill import flash_prefill as fp
    from repro_torch.kernels.flash_prefill import flash_prefill_paged
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_paged_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    f8, bf16 = torch.float8_e4m3fn, torch.bfloat16
    b, n_kv, g, hd, bs, max_blk, s_max = 8, 8, 2, 128, 16, 64, 768
    n_pages = 1 + b * max_blk

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ratio(name, ms, fn32):
        t32 = time_ms(fn32, flush=flush)
        print(f"  {name}: f8 {ms:.4f} ms, float32 pages {t32:.4f} ms, "
              f"f8 / float32 {ms / t32:.3f}", flush=True)

    kp, vp = rnd(n_pages, bs, n_kv, hd, dtype=f8), rnd(n_pages, bs, n_kv, hd, dtype=f8)
    kf, vf = kp.float(), vp.float()
    label, s, q_start, kv_lens, table = prefill_shapes(dev, gen, n_pages, bs)[0]
    q = rnd(b, s, n_kv, g, hd, dtype=bf16)
    args = (q, kp, vp, table, q_start, kv_lens)
    err = require_close("flash_prefill_paged", "on f8",
                        flash_prefill_paged(*args),
                        flash_prefill_paged_ref(*args))
    pages, flops, tc_flops, tiles = prefill_work(
        q_start, kv_lens, s, n_kv, g, bs, fp.passes(bf16, f8))
    ms = time_ms(lambda: flash_prefill_paged(*args), flush=flush)
    tally.add("flash_prefill_paged", err, ms,
              time_ms(lambda: flash_prefill_paged_ref(*args), flush=flush),
              time_ms(sdpa_prefill(q.float(), kf, vf, table, q_start,
                                   kv_lens, bs), flush=flush),
              q.numel() * 2 + pages * bs * n_kv * hd * 2
              + q.numel() * 4 + table.numel() * 4, flops,
              f"{label}, f8 pages, {tiles} block-tiles", tc_flops=tc_flops)
    ratio("flash_prefill_paged", ms, lambda: flash_prefill_paged(
        q, kf, vf, table, q_start, kv_lens))

    lens = torch.tensor([17, 732, 400, 0, 256, 33, 600, 129],
                        dtype=torch.int32, device=dev)
    qd = rnd(b, n_kv, g, hd, dtype=bf16)
    args = (qd, kp, vp, table, lens)
    err = require_close("decode_gqa_paged", "on f8", decode_gqa_paged(*args),
                        decode_gqa_paged_ref(*args))
    n_pos, pages, flops = decode_work(lens, bs, n_kv, g)
    ms = time_ms(lambda: decode_gqa_paged(*args), flush=flush)
    tally.add("decode_gqa_paged", err, ms,
              time_ms(lambda: decode_gqa_paged_ref(*args), flush=flush),
              time_ms(sdpa_decode(qd.float(), kf, vf, table, lens),
                      flush=flush),
              qd.numel() * 2 + n_pos * n_kv * hd * 2 + qd.numel() * 4
              + pages * 4 + b * 4, flops,
              f"8 rows, lengths <= 732, 64 pages, f8 pages, "
              f"{decode_split(table, lens, n_kv, bs)}")
    ratio("decode_gqa_paged", ms, lambda: decode_gqa_paged(
        qd, kf, vf, table, lens))
    del kp, vp, kf, vf

    kc, vc = rnd(b, s_max, n_kv, hd, dtype=f8), rnd(b, s_max, n_kv, hd, dtype=f8)
    kcf, vcf = kc.float(), vc.float()
    args = (qd, kc, vc, lens)
    err = require_close("decode_gqa", "on f8", decode_gqa(*args),
                        decode_gqa_ref(*args))
    kk = kcf.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    vv = vcf.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
    mask = (torch.arange(s_max, device=dev)[None]
            < lens[:, None].long())[:, None, None]
    qs = qd.float().reshape(b, n_kv * g, 1, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: decode_gqa(*args), flush=flush)
    tally.add("decode_gqa", err, ms,
              time_ms(lambda: decode_gqa_ref(*args), flush=flush),
              time_ms(lambda: sdpa(qs, kk, vv, attn_mask=mask), flush=flush),
              qd.numel() * 2 + n_pos * n_kv * hd * 2 + qd.numel() * 4 + b * 4,
              flops, f"B={b} S={s_max} lengths<=732 float8_e4m3fn, "
              f"{contiguous_split(lens, n_kv, s_max)}")
    ratio("decode_gqa", ms, lambda: decode_gqa(qd, kcf, vcf, lens))


# the head layouts beyond qwen3-1.7b's that the attention kernels take:
# (name, n_kv, g, head_dim, block size) of configs the reference
# registers, and qwen3-1.7b's layout on pages of 128 positions
LAYOUTS = (("qwen3-14b", 8, 5, 128, 16), ("minicpm-2b", 36, 1, 64, 16),
           ("paligemma-3b", 1, 8, 256, 16),
           ("recurrentgemma-2b", 1, 10, 256, 16),
           ("qwen3-1.7b", 8, 2, 128, 128))


def check_layouts(tally: Tally) -> None:
    """#5-#9 at LAYOUTS, at the serving chunk (8 rows x 256 queries over
    64 pages) and the serving rows (8 rows, lengths <= 732, 64 pages; #9
    over a 768-position cache): float (bf16 q, float32 pages
    and cache) within 1e-4 of the plain version's scale, codes at most
    1e-3 of the codes one step off; timed with their bound and library
    call like phase 2's qwen3-1.7b shapes, in a tally of their own."""
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.decode_gqa import (decode_gqa, decode_gqa_paged,
                                                decode_gqa_paged_codes)
    from repro_torch.kernels.decode_gqa.ref import (
        decode_gqa_paged_codes_ref, decode_gqa_paged_ref, decode_gqa_ref)
    from repro_torch.kernels.flash_prefill import flash_prefill as fp
    from repro_torch.kernels.flash_prefill import (flash_prefill_paged,
                                                   flash_prefill_paged_codes)
    from repro_torch.kernels.flash_prefill.ref import (
        flash_prefill_paged_codes_ref, flash_prefill_paged_ref)
    from repro_torch.runtime.calibration import ACT_BASES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    b, max_blk, s_max = 8, 64, 768
    n_pages = 1 + b * max_blk
    x_dt = torch.bfloat16

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def codes(x, stacked=False):
        """x as codes under its own fit (per KV head when stacked):
        (codes, table, decoded)."""
        if stacked:
            n_kv = x.shape[2]
            fit = eq.fit(x.permute(2, 0, 1, 3).reshape(n_kv, -1), 7,
                         bases=ACT_BASES, stacked=True)
            c = eq.encode_meta(x, eq.pack_qmeta(fit)[:, None, :])
            lut = eq.decode_table(fit)
            return c, lut, lut[torch.arange(n_kv, device=dev)[:, None],
                               c.long()]
        fit = eq.fit(x, 7, bases=ACT_BASES)
        c = eq.encode(x, fit)
        lut = eq.decode_table(fit)
        return c, lut, lut[c.long()]

    for name, n_kv, g, hd, bs in LAYOUTS:
        lay = f"{name} (n_kv {n_kv}, g {g}, hd {hd}, bs {bs})"
        kp, vp = rnd(n_pages, bs, n_kv, hd), rnd(n_pages, bs, n_kv, hd)
        kc, kl, kd = codes(kp, stacked=True)
        vc, vl, vd = codes(vp, stacked=True)
        oq = eq.pack_qmeta(eq.fit(rnd(1 << 16) * 0.5, 7, bases=ACT_BASES))
        label, s, q_start, kv_lens, table = prefill_shapes(
            dev, gen, n_pages, bs)[0]
        rows = f"{lay}, {label}"
        q = rnd(b, s, n_kv, g, hd, dtype=x_dt)
        args = (q, kp, vp, table, q_start, kv_lens)
        err = require_close("flash_prefill_paged", rows,
                            flash_prefill_paged(*args),
                            flash_prefill_paged_ref(*args))
        pages, flops, tc_flops, tiles = prefill_work(
            q_start, kv_lens, s, n_kv, g, bs, fp.passes(x_dt, kp.dtype), hd)
        tally.add("flash_prefill_paged", err,
                  time_ms(lambda: flash_prefill_paged(*args), flush=flush),
                  time_ms(lambda: flash_prefill_paged_ref(*args), flush=flush),
                  time_ms(sdpa_prefill(q.float(), kp, vp, table, q_start,
                                       kv_lens, bs), flush=flush),
                  q.numel() * 2 + pages * bs * n_kv * hd * 4 * 2
                  + q.numel() * 4 + table.numel() * 4, flops,
                  f"{rows}, {tiles} block-tiles", tc_flops=tc_flops)
        qc, ql, qd = codes(rnd(b, s, n_kv, g, hd))
        args = (qc, kc, vc, ql, kl, vl, oq, table, q_start, kv_lens)
        out = flash_prefill_paged_codes(*args)
        ref = flash_prefill_paged_codes_ref(*args)
        frac = codes_err(out, ref, f"flash_prefill_paged_codes {rows}")
        pages, flops, tc_flops, tiles = prefill_work(
            q_start, kv_lens, s, n_kv, g, bs,
            fp.passes(torch.uint8, torch.uint8), hd)
        tally.add("flash_prefill_paged_codes",
                  (eq.decode_meta(out, oq) - eq.decode_meta(ref, oq))
                  .abs().max().item(),
                  time_ms(lambda: flash_prefill_paged_codes(*args), flush=flush),
                  time_ms(lambda: flash_prefill_paged_codes_ref(*args),
                          flush=flush),
                  time_ms(sdpa_prefill(qd, kd, vd, table, q_start, kv_lens,
                                       bs), flush=flush),
                  qc.numel() * 2 + pages * bs * n_kv * hd * 2
                  + table.numel() * 4 + (1 + 2 * n_kv) * 1024 + 16, flops,
                  f"{rows}, {tiles} block-tiles, {frac:.1e} flipped",
                  tc_flops=tc_flops)

        # the serving rows of decode_shapes over the serving chunk's table
        lens = torch.tensor([17, 732, 400, 0, 256, 33, 600, 129],
                            dtype=torch.int32, device=dev)
        rows = f"{lay}, 8 rows, lengths <= 732, 64 pages"
        q = rnd(b, n_kv, g, hd, dtype=x_dt)
        args = (q, kp, vp, table, lens)
        err = require_close("decode_gqa_paged", rows,
                            decode_gqa_paged(*args),
                            decode_gqa_paged_ref(*args))
        n_pos, pages, flops = decode_work(lens, bs, n_kv, g, hd)
        tally.add("decode_gqa_paged", err,
                  time_ms(lambda: decode_gqa_paged(*args), flush=flush),
                  time_ms(lambda: decode_gqa_paged_ref(*args), flush=flush),
                  time_ms(sdpa_decode(q.float(), kp, vp, table, lens),
                          flush=flush),
                  q.numel() * 2 + n_pos * n_kv * hd * 4 * 2 + q.numel() * 4
                  + pages * 4 + b * 4, flops,
                  f"{rows}, {decode_split(table, lens, n_kv, bs)}")
        qc, ql, qd = codes(rnd(b, n_kv, g, hd))
        args = (qc, kc, vc, ql, kl, vl, oq, table, lens)
        out = decode_gqa_paged_codes(*args)
        ref = decode_gqa_paged_codes_ref(*args)
        frac = codes_err(out, ref, f"decode_gqa_paged_codes {rows}")
        tally.add("decode_gqa_paged_codes",
                  (eq.decode_meta(out, oq) - eq.decode_meta(ref, oq))
                  .abs().max().item(),
                  time_ms(lambda: decode_gqa_paged_codes(*args), flush=flush),
                  time_ms(lambda: decode_gqa_paged_codes_ref(*args),
                          flush=flush),
                  time_ms(sdpa_decode(qd, kd, vd, table, lens), flush=flush),
                  qc.numel() * 2 + n_pos * n_kv * hd * 2 + pages * 4 + b * 4
                  + (1 + 2 * n_kv) * 1024 + 16, flops,
                  f"{rows}, {decode_split(table, lens, n_kv, bs)}, "
                  f"{frac:.1e} flipped")
        del kp, vp, kc, vc, kd, vd

        kc9, vc9 = rnd(b, s_max, n_kv, hd), rnd(b, s_max, n_kv, hd)
        args = (q, kc9, vc9, lens)
        err = require_close("decode_gqa", rows, decode_gqa(*args),
                            decode_gqa_ref(*args))
        kk = kc9.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        vv = vc9.permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        mask = (torch.arange(s_max, device=dev)[None]
                < lens[:, None].long())[:, None, None]
        qs = q.float().reshape(b, n_kv * g, 1, hd)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        tally.add("decode_gqa", err,
                  time_ms(lambda: decode_gqa(*args), flush=flush),
                  time_ms(lambda: decode_gqa_ref(*args), flush=flush),
                  time_ms(lambda: sdpa(qs, kk, vv, attn_mask=mask), flush=flush),
                  q.numel() * 2 + n_pos * n_kv * hd * 4 * 2 + q.numel() * 4
                  + b * 4, flops,
                  f"{lay}, B={b} S={s_max} lengths<=732 float32, "
                  f"{contiguous_split(lens, n_kv, s_max)}")
        del kc9, vc9, kk, vv


def check_lama_kernels(tally: Tally) -> None:
    """The Lama primitives' kernels (#10, #11) at card size, held to
    exact equality with their plain versions."""
    import torch

    from repro_torch.core.lut import mul_lut
    from repro_torch.kernels.exp_histogram import exp_histogram
    from repro_torch.kernels.exp_histogram.ref import exp_histogram_ref
    from repro_torch.kernels.lama_bulk_op import lama_bulk_op
    from repro_torch.kernels.lama_bulk_op.ref import lama_bulk_op_ref

    # the launch module (the package's ``lama_bulk_op`` is the wrapper,
    # which waits for the card to read the range flag)
    bulk = importlib.import_module("repro_torch.kernels.lama_bulk_op.lama_bulk_op")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    # #10: K = 4096 scalar operands, each against an 8192-wide row of
    # 8-bit codes, through the 8-bit multiplication table
    g, m = 4096, 8192
    table = mul_lut(8, device=dev)
    a = torch.randint(0, 256, (g,), generator=gen, device=dev).to(torch.int32)
    b8 = torch.randint(0, 256, (g, m), generator=gen, device=dev).to(torch.uint8)
    out = lama_bulk_op(a, b8, table)
    require(torch.equal(out, lama_bulk_op_ref(a, b8, table)),
            "lama_bulk_op differs from its plain version")
    al, bl = a[:, None].long(), b8.long()
    tally.add("lama_bulk_op", 0.0,
              time_ms(lambda: bulk.launch(a, b8, table), flush=flush),
              time_ms(lambda: lama_bulk_op_ref(a, b8, table), flush=flush),
              time_ms(lambda: table[al, bl], flush=flush),
              b8.numel() + out.numel() * 4, 0.0, f"G={g} m={m} uint8 codes")
    del bl

    # #11: the counters of a 2048 x 2048 projection at 8 rows (G = 16384
    # dot products of 2048 terms), values in [0, 127)
    g, m, e = 16384, 2048, 127
    vals = torch.randint(0, e, (g, m), generator=gen, device=dev).to(torch.int32)
    signs = torch.randint(0, 2, (g, m), generator=gen, device=dev).float() * 2 - 1
    out = exp_histogram(vals, signs, e)
    require(torch.equal(out, exp_histogram_ref(vals, signs, e)),
            "exp_histogram differs from its plain version")
    vl = vals.long()
    tally.add("exp_histogram", 0.0,
              time_ms(lambda: exp_histogram(vals, signs, e), flush=flush),
              time_ms(lambda: exp_histogram_ref(vals, signs, e), flush=flush),
              time_ms(lambda: torch.zeros(g, e, device=dev).scatter_add_(
                  1, vl, signs), flush=flush),
              vals.numel() * 8 + g * e * 4, 0.0, f"G={g} M={m} bins={e}")


def check_codes_kernels(tally: Tally) -> None:
    """The codes path's kernels (#3, #4, #6, #8) at its serving shapes.
    Activation codes come from random tensors under their own fit on
    the activation base grid; weights as in ``check_kernels``."""
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.decode_gqa import decode_gqa_paged_codes
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_paged_codes_ref
    from repro_torch.kernels.flash_prefill import flash_prefill as fp
    from repro_torch.kernels.flash_prefill import flash_prefill_paged_codes
    from repro_torch.kernels.flash_prefill.ref import (
        flash_prefill_paged_codes_ref)
    from repro_torch.kernels.lut_dequant_matmul import (
        lut_dequant_matmul_dual, lut_dequant_matmul_dual_gated)
    from repro_torch.kernels.lut_dequant_matmul.lut_dequant_matmul import (
        gemm_plan, pass_kind, passes)
    from repro_torch.kernels.lut_dequant_matmul.ref import (
        decode_weight, lut_dequant_matmul_dual_gated_ref,
        lut_dequant_matmul_dual_ref)
    from repro_torch.runtime.calibration import ACT_BASES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def act_codes(*shape, scale=1.0):
        """(codes, lut, qmeta) of a random activation under its fit."""
        x = rnd(*shape, scale=scale)
        p = eq.fit(x, 7, bases=ACT_BASES)
        return eq.encode(x, p), eq.decode_table(p), eq.pack_qmeta(p)

    def qweight(*shape):
        codes, p = eq.quantize(rnd(*shape, scale=0.02), 7)
        return codes, eq.decode_table(p), eq.pack_qmeta(p)

    def out_table(y):
        return eq.pack_qmeta(eq.fit(y, 7, bases=ACT_BASES))

    def mm_tol(ref):
        return 1e-4 * max(1.0, ref.abs().max().item())

    def value_err(out, ref, qo):
        """max |decode(out) - decode(ref)| of two code tensors."""
        return (eq.decode_meta(out, qo) - eq.decode_meta(ref, qo)).abs().max().item()

    # bf16 tensor-core passes at M > 8: both decoded operands split hi + lo
    codes_tc = dict(tc_rate=RATES[pass_kind(torch.uint8)])
    for m in (8, 256, 2048):
        xs = {k: act_codes(m, k) for k in (2048, 6144)}
        tc = passes(torch.uint8) * 2.0 * m if m > 8 else None
        for k, n in ((2048, 2048), (2048, 1024), (6144, 2048)):
            xc, lx, qx = xs[k]
            c, lw, qw = qweight(k, n)
            args = (xc, c, lx, lw, qx, qw)
            out = lut_dequant_matmul_dual(*args)
            ref = lut_dequant_matmul_dual_ref(*args)
            err = (out - ref).abs().max().item()
            require(err <= mm_tol(ref), f"dual M={m} K={k} N={n}: max err "
                    f"{err} > {mm_tol(ref)}")
            xf, wf = decode_weight(xc, lx, None), decode_weight(c, lw, None)
            tally.add("lut_dequant_matmul_dual", err,
                      time_ms(lambda: lut_dequant_matmul_dual(*args), flush=flush),
                      time_ms(lambda: lut_dequant_matmul_dual_ref(*args),
                              flush=flush),
                      time_ms(lambda: torch.matmul(xf, wf), flush=flush),
                      m * k + k * n + 2048 + m * n * 4, 2.0 * m * k * n,
                      f"M={m} K={k} N={n}, {plan_label(m, k, n, 1)}",
                      tc_flops=tc and tc * k * n, core=m != 256, **codes_tc)
        # code out (the quantize epilogue); at M = 8 split over a
        # cluster, so the encode runs on the ranks' summed partials
        k, n = 2048, 2048
        xc, lx, qx = xs[k]
        c, lw, qw = qweight(k, n)
        qo = out_table(lut_dequant_matmul_dual_ref(xc, c, lx, lw))
        args = (xc, c, lx, lw, qx, qw)
        splits = gemm_plan(m, k, n, sms, 1)[0]
        require(m > 8 or splits > 1, f"M={m}: split-K expected, got {splits}")
        out = lut_dequant_matmul_dual(*args, out_qmeta=qo)
        ref = lut_dequant_matmul_dual_ref(*args, out_qmeta=qo)
        frac = codes_err(out, ref, f"dual u8 M={m}")
        xf, wf = decode_weight(xc, lx, None), decode_weight(c, lw, None)
        tally.add("lut_dequant_matmul_dual", value_err(out, ref, qo),
                  time_ms(lambda: lut_dequant_matmul_dual(*args, out_qmeta=qo),
                          flush=flush),
                  time_ms(lambda: lut_dequant_matmul_dual_ref(*args, out_qmeta=qo),
                          flush=flush),
                  time_ms(lambda: torch.matmul(xf, wf), flush=flush),
                  m * k + k * n + 2048 + 16 + m * n, 2.0 * m * k * n,
                  f"M={m} K={k} N={n} u8 out, {plan_label(m, k, n, 1)}, "
                  f"{frac:.1e} flipped",
                  tc_flops=tc and tc * k * n, core=m != 256, **codes_tc)

    for m in (8, 256, 2048):
        k, n = 2048, 6144
        xc, lx, qx = act_codes(m, k)
        (cg, lg, qg), (cu, lu, qu) = qweight(k, n), qweight(k, n)
        args = (xc, cg, cu, lx, lg, lu, qx, qg, qu)
        qo = out_table(lut_dequant_matmul_dual_gated_ref(*args))
        out = lut_dequant_matmul_dual_gated(*args, out_qmeta=qo)
        ref = lut_dequant_matmul_dual_gated_ref(*args, out_qmeta=qo)
        frac = codes_err(out, ref, f"dual gated M={m}")
        xf = decode_weight(xc, lx, None)
        wgu = torch.cat([decode_weight(cg, lg, None),
                         decode_weight(cu, lu, None)], dim=1)
        tally.add("lut_dequant_matmul_dual_gated", value_err(out, ref, qo),
                  time_ms(lambda: lut_dequant_matmul_dual_gated(
                      *args, out_qmeta=qo), flush=flush),
                  time_ms(lambda: lut_dequant_matmul_dual_gated_ref(
                      *args, out_qmeta=qo), flush=flush),
                  time_ms(lambda: torch.matmul(xf, wgu), flush=flush),
                  m * k + 2 * k * n + 3072 + 16 + m * n, 4.0 * m * k * n,
                  f"M={m} K={k} N={n} u8 out, {plan_label(m, k, n, 2)}, "
                  f"{frac:.1e} flipped",
                  tc_flops=(passes(torch.uint8) * 4.0 * m * k * n
                            if m > 8 else None), **codes_tc)
        del wgu

    # codes attention at the serving width: 8 rows, n_kv 8, g 2, hd 128,
    # block 16; uint8 pages under per-head tables
    b, n_kv, g, hd, bs = 8, 8, 2, 128, 16
    max_blk = 64
    n_pages = 1 + b * max_blk
    heads = torch.arange(n_kv, device=dev)[:, None]

    def code_pool(n):
        """K and V pools of n pages as codes under per-head tables fitted
        on them, and their decoded values: (kc, kl, vc, vl, kd, vd)."""
        tabs = []
        for _ in range(2):
            x = rnd(n, bs, n_kv, hd)
            fit = eq.fit(x.permute(2, 0, 1, 3).reshape(n_kv, -1), 7,
                         bases=ACT_BASES, stacked=True)
            tabs += [eq.encode_meta(x, eq.pack_qmeta(fit)[:, None, :]),
                     eq.decode_table(fit)]
        kc, kl, vc, vl = tabs
        return kc, kl, vc, vl, kl[heads, kc.long()], vl[heads, vc.long()]

    kc, kl, vc, vl, kd, vd = code_pool(n_pages)
    oq = out_table(rnd(1 << 16, scale=0.5))

    # prefill: the three shapes of check_kernels over the code pages
    passes = fp.passes(torch.uint8, torch.uint8)
    for label, s, q_start, kv_lens, table in prefill_shapes(
            dev, gen, n_pages, bs):
        qc, ql, _ = act_codes(len(q_start), s, n_kv, g, hd)
        args = (qc, kc, vc, ql, kl, vl, oq, table, q_start, kv_lens)
        out = flash_prefill_paged_codes(*args)
        ref = flash_prefill_paged_codes_ref(*args)
        frac = codes_err(out, ref, f"flash_prefill_paged_codes {label}")
        pages, flops, tc_flops, tiles = prefill_work(
            q_start, kv_lens, s, n_kv, g, bs, passes)
        tally.add("flash_prefill_paged_codes", value_err(out, ref, oq),
                  time_ms(lambda: flash_prefill_paged_codes(*args), flush=flush),
                  time_ms(lambda: flash_prefill_paged_codes_ref(*args),
                          flush=flush),
                  time_ms(sdpa_prefill(ql[qc.long()], kd, vd, table, q_start,
                                       kv_lens, bs), flush=flush),
                  qc.numel() + pages * bs * n_kv * hd * 2 + qc.numel()
                  + table.numel() * 4 + (1 + 2 * n_kv) * 1024 + 16, flops,
                  f"{label}, {tiles} block-tiles, {frac:.1e} flipped",
                  tc_flops=tc_flops)

    # decode: check_kernels' three shapes over a pool of 1 + 8 x 256
    # code pages
    del kc, vc, kd, vd
    n_dec = 1 + b * 4096 // bs
    kc, kl, vc, vl, kd, vd = code_pool(n_dec)
    zero = eq.encode_meta(torch.zeros((), device=dev), oq)
    serving = None
    for label, table, lens in decode_shapes(dev, gen, n_dec):
        qc, ql, _ = act_codes(b, n_kv, g, hd)
        args = (qc, kc, vc, ql, kl, vl, oq, table, lens)
        out = decode_gqa_paged_codes(*args)
        ref = decode_gqa_paged_codes_ref(*args)
        frac = codes_err(out, ref, f"decode_gqa_paged_codes {label}")
        require(bool(torch.all(out[lens == 0] == zero)),
                f"decode_gqa_paged_codes {label}: a zero-length row is not "
                f"the code of 0.0")
        n_pos, pages, flops = decode_work(lens, bs, n_kv, g)
        tally.add("decode_gqa_paged_codes", value_err(out, ref, oq),
                  time_ms(lambda: decode_gqa_paged_codes(*args), flush=flush),
                  time_ms(lambda: decode_gqa_paged_codes_ref(*args),
                          flush=flush),
                  time_ms(sdpa_decode(ql[qc.long()], kd, vd, table, lens),
                          flush=flush),
                  qc.numel() + n_pos * n_kv * hd * 2 + qc.numel()
                  + pages * 4 + b * 4 + (1 + 2 * n_kv) * 1024 + 16, flops,
                  f"{label}, {decode_split(table, lens, n_kv, bs)}, "
                  f"{frac:.1e} flipped")
        serving = serving or args[:-1]
    decode_floor("decode_gqa_paged_codes", decode_gqa_paged_codes, serving,
                 flush)


# ------------------------------------------------ phase 3: path check --

PATH_LENS, PATH_CHUNK, PATH_STEPS, PATH_BS = (100, 37), 128, 3, 16


def paged_run(api, cfg, model, dev, kv_dtype, prompts, feed=None,
              pages=None):
    """A 2-row prefill chunk of ``prompts`` and PATH_STEPS decode steps
    through the paged entry points on ``dev``; returns the logits of the
    chunk and of each step (on the CPU).  The decode steps take
    ``feed[i]`` as their tokens when given (the CPU's greedy tokens),
    else this run's own argmax.  ``pages``, a list, receives the K and V
    page pools at the end (on the CPU)."""
    import numpy as np
    import torch

    from repro_torch.runtime.paged_cache import PagedKVCache

    cache = PagedKVCache(num_layers=cfg.num_layers,
                         num_kv_heads=cfg.num_kv_heads,
                         head_dim=cfg.resolved_head_dim, num_slots=2,
                         block_size=PATH_BS, num_blocks=32,
                         max_blocks_per_seq=16, dtype=kv_dtype, device=dev)
    toks = np.zeros((2, PATH_CHUNK), np.int32)
    for i, p in enumerate(prompts):
        cache.bind_slot(i, len(p), reserved=False)
        toks[i, :len(p)] = p
    logits, _ = api.prefill_into_cache(
        model, torch.as_tensor(toks, device=dev), cache.view(cols=8), cfg)
    outs = [logits[:, -1].float().cpu()]
    nxt = logits[:, -1].argmax(-1)
    active = torch.ones(2, dtype=torch.bool, device=dev)
    for step in range(PATH_STEPS):
        if feed is not None:
            nxt = feed[step].to(dev)
        for i in range(2):
            cache.ensure_capacity(i, reserved=False)
        logits, view = api.decode_step_paged(
            model, cache.view(cols=16), nxt[:, None].to(torch.int32),
            active, cfg)
        cache.lengths[:] = view.lengths.cpu().numpy()
        outs.append(logits[:, -1].float().cpu())
        nxt = logits[:, -1].argmax(-1)
    if pages is not None:
        pages.extend((cache.k_pages.cpu(), cache.v_pages.cpu()))
    return outs


def f8_steps_apart(a, b, label: str) -> float:
    """float8_e4m3fn pages ``a`` against ``b``: at most 1e-3 of the
    elements may differ, each to the neighbouring e4m3 value (one
    rounding step: a last-bit difference in the float K or V written
    lands on the other side of a rounding boundary now and then).
    Returns the differing fraction."""
    import torch

    x, y = a.view(torch.uint8).int(), b.view(torch.uint8).int()
    diff = x != y
    mag = ((x & 0x7F) - (y & 0x7F)).abs()
    same_sign = (x & 0x80) == (y & 0x80)
    near_zero = ((x & 0x7F) <= 1) & ((y & 0x7F) <= 1)
    far = diff & ~((mag <= 1) & (same_sign | near_zero))
    if far.any():
        idx = far.nonzero()[:8]
        print(f"  {label}: {int(diff.sum())} bytes differ, {int(far.sum())} "
              f"by more than a step, e.g. at {idx.tolist()}: "
              f"{a.float()[far][:8].tolist()} vs {b.float()[far][:8].tolist()}",
              flush=True)
    require(not far.any(), f"{label}: f8 pages more than one rounding step "
            f"apart")
    frac = diff.float().mean().item()
    require(frac <= 1e-3, f"{label}: {frac:.2e} of the f8 page bytes "
            f"differ > 1e-3")
    return frac


def rel_err(outs, refs):
    return max((a - r).abs().max().item() / max(1.0, r.abs().max().item())
               for a, r in zip(outs, refs))


def compare(label, on_card, on_cpu, rel_tol):
    """Logits within ``rel_tol`` of their scale at every step; greedy
    tokens equal wherever the CPU's top-2 gap exceeds twice the
    tolerance (a smaller gap may be crossed legitimately)."""
    import torch

    for step, (a, r) in enumerate(zip(on_card, on_cpu)):
        tol = rel_tol * max(1.0, r.abs().max().item())
        err = (a - r).abs().max().item()
        top2 = r.topk(2, -1).values
        gaps = top2[:, 0] - top2[:, 1]
        clear = gaps > 2 * tol
        print(f"  {label} step {step}: logits max err {err:.3e} (tol "
              f"{tol:.3e}), top-2 gaps {gaps.tolist()}", flush=True)
        require(err <= tol, f"{label} path check step {step}: err {err} "
                f"> {tol}")
        require(torch.equal(a.argmax(-1)[clear], r.argmax(-1)[clear]),
                f"{label} path check step {step}: greedy tokens differ")


def quantized_model(cfg, seed: int):
    """A card model of ``cfg`` with random weights (``seed``) quantized
    to 7 bits on the card."""
    from repro_torch.core import lama_layers as ll
    from repro_torch.models import api as mapi
    from repro_torch.models.transformer import DecoderLM

    api = mapi.get_model(cfg)
    dense = api.init("cuda", seed=seed)
    qtree, _ = ll.quantize_tree(dense.tree(), 7, axes=api.logical_axes())
    del dense
    return api, DecoderLM(cfg, qtree, device="cuda")


def path_check() -> None:
    """Card against CPU on a 2-layer, full-width model: float activations
    over float32 pages, then over float8_e4m3fn pages, the contiguous
    path (and its dense decode branch against the kernel branch, on the
    card), then activations and KV pages as codes under the same
    act-quant tables on both sides; then the other dense decoders."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lama_layers as ll
    from repro_torch.kernels import _build
    from repro_torch.runtime import calibration as cal

    # float32 compute, so that greedy tokens are a fair equality check
    cfg = get_config(ARCH).replace(num_layers=2, compute_dtype="float32")
    api, gpu = quantized_model(cfg, seed=1)
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PATH_LENS]

    def run(model, dev, kv_dtype, feed=None, pages=None):
        return paged_run(api, cfg, model, dev, kv_dtype, prompts, feed,
                         pages)

    t0 = time.perf_counter()
    card_pages, cpu_pages = [], []
    on_card = run(gpu, torch.device("cuda"), torch.float32, pages=card_pages)
    t1 = time.perf_counter()
    on_cpu = run(cpu, torch.device("cpu"), torch.float32, pages=cpu_pages)
    t2 = time.perf_counter()
    print("  float32 pages, card vs CPU (trash page 0 left out): max abs "
          "difference K " + ", V ".join(
              f"{(a[:, 1:] - b[:, 1:]).abs().max().item():.3e}"
              for a, b in zip(card_pages, cpu_pages)), flush=True)
    # float32 end to end; kernel and plain version differ only in
    # summation order and the library's exp/rsqrt
    compare("float", on_card, on_cpu, 1e-4)
    print(f"  float path check ok: card {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s",
          flush=True)

    # float8_e4m3fn pages: both sides cast K/V at the write and upcast
    # after the load.  A float K or V that differs in its last bits (the
    # card's products are split TF32, within 2^-20 of float32) may round
    # to the neighbouring e4m3 value, an eighth of a binade away, now and
    # then, which moves the logits by far more than 1e-4 of their scale,
    # and the next layer's K and V by more than a step.  So layer 0's
    # pages (their K and V depend on the tokens alone) are held to the
    # codes gate's form, at most 1e-3 of the bytes one step apart; the
    # later layer's differing share is printed; the logits are held to
    # 1e-4 or, if larger, four times the CPU's own spread with every
    # weight table scaled by 1 + rel, rel the smallest of 2^-22, 2^-20,
    # 2^-18 and 2^-16 at which the CPU rounds at least as many layer-0
    # K/V values the other way as the card did (a last-bit change flips
    # fewer than the card's split-TF32 products do).
    f8 = torch.float8_e4m3fn
    t0 = time.perf_counter()
    cpu_pages, card_pages = [], []
    on_cpu = run(cpu, torch.device("cpu"), f8, pages=cpu_pages)
    feed = [o.argmax(-1) for o in on_cpu[:-1]]
    t1 = time.perf_counter()
    on_card = run(gpu, torch.device("cuda"), f8, feed, pages=card_pages)
    t2 = time.perf_counter()
    # every page but the trash page 0, where the padding of the chunk is
    # scattered, many writes to one place in no set order
    flipped = sum(f8_steps_apart(a[0, 1:], b[0, 1:], f"f8 layer-0 {kv} pages")
                  for a, b, kv in zip(card_pages, cpu_pages, "KV"))
    later = [(a[1:, 1:].view(torch.uint8) != b[1:, 1:].view(torch.uint8))
             .float().mean().item() for a, b in zip(card_pages, cpu_pages)]
    print(f"  f8: page bytes apart, card vs CPU: layer 0 K + V {flipped:.2e} "
          f"(one step each); layer 1 K {later[0]:.2e}, V {later[1]:.2e}",
          flush=True)
    for e in (22, 20, 18, 16):
        nudged_pages = []
        spread = rel_err(run(_nudged(cpu, 2.0 ** -e), torch.device("cpu"), f8,
                             feed, nudged_pages), on_cpu)
        own = sum(f8_steps_apart(a[0, 1:], b[0, 1:], f"nudged {kv} pages")
                  for a, b, kv in zip(nudged_pages, cpu_pages, "KV"))
        print(f"  f8: CPU against itself with weight tables x (1 + 2^-{e}): "
              f"layer 0 K + V {own:.2e} apart, logits {spread:.3e} of their "
              f"scale", flush=True)
        if own >= flipped:
            break
    compare("f8 pages", on_card, on_cpu, max(1e-4, 4 * spread))
    print(f"  f8 path check ok: card {t2 - t1:.2f} s, cpu {t1 - t0:.2f} s",
          flush=True)

    # the contiguous path: prefill of a 2-row bucket of 100-token prompts
    # into a 128-position cache, then 4 decode steps feeding the CPU's
    # greedy tokens on both sides
    toks = rng.integers(0, cfg.vocab_size, (2, 100)).astype(np.int32)

    def run_contiguous(model, dev, feed=None):
        logits, cache = api.prefill(model, torch.as_tensor(toks, device=dev),
                                    cfg, 128, cache_dtype=torch.float32)
        outs = [logits[:, -1].float().cpu()]
        nxt = logits[:, -1].argmax(-1)
        for step in range(4):
            if feed is not None:
                nxt = feed[step].to(dev)
            logits, cache = api.decode_step(model, cache,
                                            nxt[:, None].to(torch.int32), cfg)
            outs.append(logits[:, -1].float().cpu())
            nxt = logits[:, -1].argmax(-1)
        return outs

    t0 = time.perf_counter()
    on_cpu = run_contiguous(cpu, torch.device("cpu"))
    feed = [o.argmax(-1) for o in on_cpu[:-1]]
    t1 = time.perf_counter()
    before = _build.launch_counts().get("decode_gqa", 0)
    on_card = run_contiguous(gpu, torch.device("cuda"), feed)
    t2 = time.perf_counter()
    launched = _build.launch_counts().get("decode_gqa", 0) - before
    require(launched == cfg.num_layers * 4,
            f"contiguous path check: decode_gqa launched {launched} times")
    compare("contiguous", on_card, on_cpu, 1e-4)
    with ll.policy(flash_decode=False):
        dense = run_contiguous(gpu, torch.device("cuda"), feed)
    require(_build.launch_counts().get("decode_gqa", 0) - before == launched,
            "the dense decode branch launched decode_gqa")
    compare("contiguous dense vs kernel", dense, on_card, 1e-4)
    print(f"  contiguous path check ok: card {t2 - t1:.2f} s, cpu "
          f"{t1 - t0:.2f} s", flush=True)

    path = os.path.join(ROOT, "build", "chip_smoke_path_calib.json")
    if os.path.exists(path):
        os.unlink(path)
    # calibrated on the card (the CPU would take five times as long);
    # both sides then hold the same tables
    t0 = time.perf_counter()
    gpu, report = cal.calibrate_act_quant(api, gpu, cfg, 7, path=path)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    cpu = copy.deepcopy(gpu).to("cpu")
    t0 = time.perf_counter()
    on_cpu = run(cpu, torch.device("cpu"), torch.uint8)
    t1 = time.perf_counter()
    # both sides decode the CPU's greedy tokens, so every step compares
    # like with like
    feed = [o.argmax(-1) for o in on_cpu[:-1]]
    on_card = run(gpu, torch.device("cuda"), torch.uint8, feed)
    t2 = time.perf_counter()
    # Codes: a last-bit float difference (another summation order, the
    # card's logf) flips an activation or K/V code at a rounding boundary
    # now and then, and a flipped code moves its value by one
    # quantization step, which flips further codes downstream: at full
    # width the logits differ by far more than the 1e-4 of the float
    # path.  The CPU measures that spread on itself, with every weight
    # table scaled by (1 + 2**-22) -- a last-bit change -- and the card
    # is held to four times it (at least 1e-3 of the scale).  A wrong
    # table, site or mask moves the logits by a sizeable share of their
    # scale instead.
    spread = rel_err(run(_nudged(cpu), torch.device("cpu"), torch.uint8,
                         feed), on_cpu)
    print(f"  codes: CPU against itself with last-bit weight tables: logits "
          f"differ by {spread:.3e} of their scale", flush=True)
    compare("codes", on_card, on_cpu, max(1e-3, 4 * spread))
    sqnr = cal.report_means(report)
    print(f"  codes path check ok: calibration on the card {t_cal:.2f} s "
          f"(mean SQNR {min(sqnr.values()):.1f}..{max(sqnr.values()):.1f} dB), "
          f"card {t2 - t1:.2f} s, cpu {t1 - t0:.2f} s", flush=True)


# the other dense decoders the port serves, and the layers phase 9 keeps
# (None: all): qwen3-14b's 40 layers of random float32 weights (56 GB)
# would not fit beside their codes, and 8 of them hold the step's shape
OTHER_DECODERS = (("olmo-1b", None), ("minicpm-2b", None), ("qwen3-14b", 8))


def path_check_configs() -> None:
    """The float path check (float32 pages, float32 compute, 7-bit
    weights) on 2 layers of each of OTHER_DECODERS at full width: olmo-1b
    (non-parametric LayerNorm, g 1), minicpm-2b (head_dim 64, n_kv 36,
    the tied unembedding at an odd vocabulary) and qwen3-14b (g 5, the
    untied unembedding in #1's plain layout).  Both sides decode the
    CPU's greedy tokens.  Logits within 1e-4 of their scale or, if
    larger, four times the CPU's own spread under a last-bit change of
    the weight tables, as the codes check: random olmo-1b weights move
    the CPU's logits by a few 1e-4 of their scale under that change
    alone (qwen3-1.7b's by under 1e-6)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    for name, _ in OTHER_DECODERS:
        cfg = get_config(name).replace(num_layers=2, compute_dtype="float32")
        api, gpu = quantized_model(cfg, seed=1)
        cpu = copy.deepcopy(gpu).to("cpu")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in PATH_LENS]
        t0 = time.perf_counter()
        on_cpu = paged_run(api, cfg, cpu, torch.device("cpu"), torch.float32,
                           prompts)
        feed = [o.argmax(-1) for o in on_cpu[:-1]]
        t1 = time.perf_counter()
        on_card = paged_run(api, cfg, gpu, torch.device("cuda"),
                            torch.float32, prompts, feed)
        t2 = time.perf_counter()
        spread = rel_err(paged_run(api, cfg, _nudged(cpu), torch.device("cpu"),
                                   torch.float32, prompts, feed), on_cpu)
        print(f"  {name}: CPU against itself with last-bit weight tables: "
              f"logits differ by {spread:.3e} of their scale", flush=True)
        compare(name, on_card, on_cpu, max(1e-4, 4 * spread))
        print(f"  {name} path check ok: card {t2 - t1:.2f} s, cpu "
              f"{t1 - t0:.2f} s", flush=True)
        del gpu, cpu
        gc.collect()
        torch.cuda.empty_cache()


def _nudged(model, rel: float = 2 ** -22):
    """``model`` with every weight table scaled by ``1 + rel`` (by default
    a change in the last bits) and nothing else changed."""
    from repro_torch.core.exponential_quant import QWeight

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    QWeight(v.codes, v.lut * (1 + rel), v.qmeta)
                    if isinstance(v, QWeight) else v)
                for k, v in tree.items()}

    return model.with_tree(walk(model.tree()))


# ---------------------------------------------------- phase 4: serving --

def serving_requests(cfg):
    """The serving cell's 12 requests: prompt lengths in 17..700 and 32
    new tokens each, from seed 0."""
    import numpy as np

    from repro_torch.runtime.server import Request

    rng = np.random.default_rng(0)
    lens = rng.integers(17, 701, 12)
    return lens, [Request(i, rng.integers(0, cfg.vocab_size, int(n))
                          .astype(np.int32), max_new_tokens=32)
                  for i, n in enumerate(lens)]


def check_served(outs, reqs, cfg, n_new: int = 32) -> None:
    require(len(outs) == len(reqs), "missing completions")
    for c in outs:
        require(c.status == "ok", f"request {c.uid}: status {c.status}")
        require(len(c.tokens) == n_new,
                f"request {c.uid}: {len(c.tokens)} tokens")
        require(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()),
                f"request {c.uid}: token out of range")


def require_float_path(counts: dict, eng, cfg, label: str) -> None:
    """The float path's launches, exactly: #1 5L + 1 times a dispatch
    (q, k, v, o and w_down a layer, then the unembedding, tied or
    untied), #2 L times a dispatch, #5 L times a prefill dispatch, #7 L
    times a decode step, and no other kernel."""
    n = cfg.num_layers
    disp = eng.prefill_batches + eng.total_decode_steps
    want = {"lut_dequant_matmul": (5 * n + 1) * disp,
            "lut_dequant_matmul_gated": n * disp,
            "flash_prefill_paged": n * eng.prefill_batches,
            "decode_gqa_paged": n * eng.total_decode_steps}
    require(counts == want, f"{label}: launches {counts}, want {want}")


def print_rates(eng, peak_gib: float) -> None:
    graphs, capture_s = eng.graph_captures()
    mode = "graphs" if eng.cuda_graphs else "eager"
    print(f"  [{mode}] prefill "
          f"{eng.prefill_tokens_computed / eng.prefill_dispatch_s:.1f} "
          f"tok/s ({eng.prefill_tokens_computed} tokens in "
          f"{eng.prefill_dispatch_s:.3f} s), decode "
          f"{eng.decode_tokens / eng.decode_dispatch_s:.1f} tok/s "
          f"({eng.decode_tokens} tokens in {eng.decode_dispatch_s:.3f} s, "
          f"{1e3 * eng.decode_dispatch_s / eng.total_decode_steps:.2f} ms/step), "
          f"peak memory {peak_gib:.2f} GiB, page pools {eng.cache.nbytes} B "
          f"({eng.cache.k_pages.dtype}), {graphs} graphs captured in "
          f"{capture_s:.2f} s", flush=True)


def fresh_peak() -> None:
    """Free what nothing holds and restart the peak-memory count, so a
    run's peak holds what is live during it and what it allocates."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def serve_eager(served, reqs, outs, cfg, kernel: str):
    """The A/B of one dispatch a tick: the same requests through an
    Engine on the graph-mode engine's weights (and tables) and config
    (``served``: params, EngineConfig, kv_codes, KV dtype) with
    ``cuda_graphs=False``, once the graph-mode engine is freed.  Same
    kernels in the same order, so the token streams must be equal
    (exactly).  Prints its rates and its profile."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.runtime.engine import Engine

    params, ec, codes, kv_dtype = served
    fresh_peak()
    off = Engine(cfg, params=params, engine=ec, kv_codes=codes,
                 kv_dtype=kv_dtype, device="cuda", cuda_graphs=False)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eager = off.generate(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served(eager, reqs, cfg)
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(outs, eager)),
            "cuda_graphs=False gave other token streams than the graphs")
    require(_build.launch_counts().get(kernel, 0)
            == cfg.num_layers * off.total_decode_steps,
            f"{kernel}: eager launches != {cfg.num_layers} x decode steps")
    print(f"  A/B: cuda_graphs=False served the same {len(eager)} requests "
          f"in {t_run:.2f} s, token streams equal", flush=True)
    print_rates(off, peak)
    profile_decode(off, cfg, kernel)


def step_spans(fn):
    """Run ``fn()`` with every ``StepGraph.step`` bracketed by CUDA
    events.  Returns (wall s, the steps' device span in ms): each span
    runs from the step's first enqueued work to its last, as the device
    saw it, so it bounds the step's busy time from above (it also holds
    the gaps an eager step leaves while the host enqueues)."""
    import torch

    from repro_torch.runtime import step_graph as sg

    pairs = []
    step = sg.StepGraph.step

    def timed(self, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(self, fn)
        b.record()
        pairs.append((a, b))
        return out
    sg.StepGraph.step = timed
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sg.StepGraph.step = step
    return wall, sum(a.elapsed_time(b) for a, b in pairs)


def profiled(fn, kernel: str, attempts: int = 3):
    """``fn()`` under torch.profiler with the launch counters reset
    first and the steps' device spans taken (``step_spans``); busy time
    is the sum of the device's kernel and copy events.  Requires
    that the profile's split-KV kernels (``split::split_kernel``: one a
    launch of #7, #8 or #9, the merge pass apart) number the launches
    the counter ``kernel`` took, so the counters agree with the device
    in graph mode too.  The profiler now and then loses a block of its
    device records in the busiest window (phase 5's, about 62,000
    kernels: in one window of six on the card 24 split kernels, 24
    merges and 5,270 events in all went missing, all kinds alike), so a
    window that sees fewer split kernels than launched is run and
    profiled again, up to ``attempts`` times; one that sees more fails
    at once.  Returns (kernel events, wall s, busy ms, span ms, split
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    for attempt in range(attempts):
        _build.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, span = step_spans(fn)
        # the device's own events only: an eager op's self device time is
        # its kernels' again (a graph's kernels belong to no op)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        seen = sum(e.count for e in events if "split::split_kernel" in e.key)
        launched = _build.launch_counts().get(kernel, 0)
        require(launched > 0 and seen <= launched,
                f"profile: {seen} split-KV kernels on the device, the "
                f"{kernel} counter took {launched} launches")
        if seen == launched:
            break
        print(f"  profile: {seen} split-KV kernels of {launched} launched "
              f"({sum(e.count for e in events)} device events): the "
              f"profiler lost records; profiling the window again",
              flush=True)
    require(seen == launched,
            f"profile: {seen} split-KV kernels on the device, the {kernel} "
            f"counter took {launched} launches, {attempts} windows")
    return events, wall, busy, span, seen


def serve(counts_out: dict):
    """Phase 4; returns the completions, the page-pool bytes and the
    quantized weights (phases 5 and 6 serve the same ones)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.server import InferenceServer

    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = InferenceServer(cfg, quant_bits=7, num_slots=8, prefill_chunk=256,
                          device="cuda", rng_seed=0)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    lens, reqs = serving_requests(cfg)
    sqnr = [db for _, db in srv.quant_report.values()]
    print(f"  setup (random init + quantize on the card) {t_setup:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{len(sqnr)} tensors at 7 bits, round-trip SQNR "
          f"{min(sqnr):.1f}..{max(sqnr):.1f} dB; prompt lengths "
          f"{lens.tolist()}", flush=True)
    fresh_peak()                              # the serving run's own peak
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.generate(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = _build.launch_counts()
    counts_out.update(counts)
    eng = srv.last_engine
    check_served(outs, reqs, cfg)
    for name in FLOAT_PATH:
        require(counts.get(name, 0) > 0, f"{name} never launched while serving")
    require(counts["decode_gqa_paged"] == cfg.num_layers * eng.total_decode_steps,
            f"decode_gqa_paged launches {counts['decode_gqa_paged']} != "
            f"{cfg.num_layers} x {eng.total_decode_steps} decode steps")
    require_float_path(counts, eng, cfg, "phase 4")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  served {len(outs)} requests in {t_run:.2f} s: "
          f"{eng.prefill_batches} prefill dispatches, "
          f"{eng.total_decode_steps} decode steps, launches {counts}",
          flush=True)
    print_rates(eng, peak)
    print(f"  first completion tokens {outs[0].tokens[:8].tolist()}", flush=True)
    pool = eng.cache.nbytes
    profile_decode(eng, cfg, "decode_gqa_paged")
    served = (eng.params, eng.engine_cfg, eng.kv_codes, eng.kv_dtype)
    srv.last_engine = eng = None
    serve_eager(served, reqs, outs, cfg, "decode_gqa_paged")
    return outs, pool, srv.params


def serve_codes(counts_out: dict, float_outs, float_pool: int,
                params) -> None:
    """Phase 5: the same weights (phase 4's ``params``) with activations
    and KV pages as codes, calibrated afresh on the card (a cache file
    under build/, deleted first, so no stale fit can stand in)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime import calibration as cal
    from repro_torch.runtime.server import InferenceServer

    cfg = get_config(ARCH)
    path = os.path.join(ROOT, "build", "chip_smoke_calib.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.unlink(path)
    os.environ["REPRO_ACT_CALIB_CACHE"] = path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = InferenceServer(cfg, params=params, act_quant=7, kv_codes=True,
                          num_slots=8, prefill_chunk=256, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    lens, reqs = serving_requests(cfg)
    t0 = time.perf_counter()
    eng = srv.make_engine(reqs)          # calibrates, on the card
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    require(os.path.exists(path), "calibration wrote no cache entry")
    sqnr = cal.report_means(eng.act_report)
    print(f"  setup {t_setup:.1f} s; calibration on the card {t_cal:.2f} s, "
          f"mean SQNR per site (dB): "
          + ", ".join(f"{k} {v:.2f}" for k, v in sqnr.items()), flush=True)
    fresh_peak()                              # the serving run's own peak
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.generate(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = _build.launch_counts()
    counts_out.update(counts)
    require(srv.last_engine is eng, "the calibrated engine was not reused")
    check_served(outs, reqs, cfg)
    for name in CODES_PATH:
        require(counts.get(name, 0) > 0, f"{name} never launched while "
                f"serving codes")
    require(counts["decode_gqa_paged_codes"]
            == cfg.num_layers * eng.total_decode_steps,
            f"decode_gqa_paged_codes launches "
            f"{counts['decode_gqa_paged_codes']} != {cfg.num_layers} x "
            f"{eng.total_decode_steps} decode steps")
    for name in ("flash_prefill_paged", "decode_gqa_paged",
                 "lut_dequant_matmul_gated"):
        require(counts.get(name, 0) == 0, f"{name} launched "
                f"{counts.get(name)} times while serving codes")
    dispatches = eng.prefill_batches + eng.total_decode_steps
    require(counts.get("lut_dequant_matmul", 0) == dispatches,
            f"lut_dequant_matmul launched {counts.get('lut_dequant_matmul')} "
            f"times, not once per dispatch ({dispatches}): only the tied "
            f"unembedding may take float activations")
    require(eng.cache.k_pages.dtype == torch.uint8, "pages are not uint8")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  served {len(outs)} requests in {t_run:.2f} s: "
          f"{eng.prefill_batches} prefill dispatches, "
          f"{eng.total_decode_steps} decode steps, launches {counts}",
          flush=True)
    print_rates(eng, peak)
    agree = np.mean([np.mean(a.tokens == b.tokens)
                     for a, b in zip(float_outs, outs)])
    print(f"  page pools {eng.cache.nbytes} B uint8 vs {float_pool} B "
          f"float32 ({eng.cache.nbytes / float_pool:.3f}x); greedy-token "
          f"agreement with the float-activation run {agree:.4f} (random "
          f"weights: printed, not gated); attention counters: bytes read "
          f"{eng.attn_bytes_read}, activation bytes {eng.attn_act_bytes}, "
          f"dequants {eng.attn_dequants}", flush=True)
    profile_decode(eng, cfg, "decode_gqa_paged_codes")
    time_encodes(eng.params, cfg)
    served = (eng.params, eng.engine_cfg, eng.kv_codes, eng.kv_dtype)
    srv.last_engine = eng = None
    serve_eager(served, reqs, outs, cfg, "decode_gqa_paged_codes")


# ------------------------------------- phase 6: contiguous serving --

def serve_contiguous(counts_out: dict, params) -> None:
    """Phase 6: phase 4's weights serve 12 requests in three prompt
    buckets (64, 256 and 700 tokens, four each; 32 new tokens) through
    ``generate_bucketed`` over float32 contiguous caches of 768
    positions; then ``generate`` (the Engine) serves the same requests
    for the token agreement, which is printed, not gated (random
    weights: near-ties may flip)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.server import InferenceServer, Request

    cfg = get_config(ARCH)
    rng = np.random.default_rng(2)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=32)
            for i, n in enumerate([64] * 4 + [256] * 4 + [700] * 4)]
    srv = InferenceServer(cfg, params=params, max_len=768, num_slots=8,
                          prefill_chunk=256, device="cuda")
    fresh_peak()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.generate_bucketed(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = _build.launch_counts()
    counts_out.update(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served(outs, reqs, cfg)
    buckets: dict = {}
    for r, c in zip(reqs, outs):
        buckets.setdefault(len(r.prompt), []).append(c)
    steps = sum(cs[0].decode_steps for cs in buckets.values())
    require(counts.get("decode_gqa", 0) == cfg.num_layers * steps,
            f"decode_gqa launches {counts.get('decode_gqa', 0)} != "
            f"{cfg.num_layers} x {steps} decode steps")
    for name in CONTIG_PATH:
        require(counts.get(name, 0) > 0, f"{name} never launched while "
                f"serving the contiguous path")
    for name in PAGED_ATTENTION:
        require(counts.get(name, 0) == 0, f"{name} launched "
                f"{counts.get(name)} times on the contiguous path")
    cache_bytes = (2 * cfg.num_layers * 4 * srv.max_len * cfg.num_kv_heads
                   * cfg.resolved_head_dim * 4)
    print(f"  served {len(outs)} requests in {t_run:.2f} s: {len(buckets)} "
          f"buckets, {steps} decode steps, launches {counts}", flush=True)
    print_bucketed(srv, outs, reqs, peak, cache_bytes)
    t0 = time.perf_counter()
    engine_outs = srv.generate(reqs)
    t_eng = time.perf_counter() - t0
    agree = np.mean([np.mean(a.tokens == b.tokens)
                     for a, b in zip(engine_outs, outs)])
    print(f"  greedy-token agreement with generate (the Engine, {t_eng:.2f} "
          f"s) {agree:.4f} (printed, not gated); first completion tokens "
          f"{outs[0].tokens[:8].tolist()}", flush=True)
    profile_contiguous(srv, cfg)
    # the A/B: the same requests with every step run eagerly
    srv.last_engine = None
    off = InferenceServer(cfg, params=params, max_len=768, num_slots=8,
                          prefill_chunk=256, device="cuda", cuda_graphs=False)
    fresh_peak()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eager = off.generate_bucketed(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(outs, eager)),
            "cuda_graphs=False gave other token streams than the graphs")
    require(_build.launch_counts() == counts,
            "cuda_graphs=False launched other counts than the graphs")
    print(f"  A/B: cuda_graphs=False served the same {len(eager)} requests "
          f"in {t_run:.2f} s, token streams and launch counts equal",
          flush=True)
    print_bucketed(off, eager, reqs, peak, cache_bytes)
    profile_contiguous(off, cfg)


def print_bucketed(srv, outs, reqs, peak: float, cache_bytes: int,
                   cache_dtype: str = "float32") -> None:
    """Phase 6's rates from the completions (a bucket shares one stamp)."""
    buckets: dict = {}
    for r, c in zip(reqs, outs):
        buckets.setdefault(len(r.prompt), []).append(c)
    steps = sum(cs[0].decode_steps for cs in buckets.values())
    prefill_s = sum(cs[0].prefill_s for cs in buckets.values())
    decode_s = sum(cs[0].decode_s for cs in buckets.values())
    prompt_toks = sum(len(r.prompt) for r in reqs)
    decode_toks = sum(len(cs) * cs[0].decode_steps for cs in buckets.values())
    mode = "graphs" if srv.cuda_graphs else "eager"
    print(f"  [{mode}] prefill {prompt_toks / prefill_s:.1f} tok/s "
          f"({prompt_toks} tokens in {prefill_s:.3f} s), decode "
          f"{decode_toks / decode_s:.1f} tok/s ({decode_toks} tokens in "
          f"{decode_s:.3f} s, {1e3 * decode_s / steps:.2f} ms/step, capture "
          f"included), peak memory {peak:.2f} GiB, contiguous cache "
          f"{cache_bytes} B per 4-row bucket ({cache_dtype}, {srv.max_len} "
          f"positions), {srv.bucket_graphs} graphs captured in "
          f"{srv.bucket_capture_s:.2f} s", flush=True)


def profile_contiguous(srv, cfg) -> None:
    """Where a contiguous decode step's time goes: one bucket of 4
    requests of 64-token prompts, 8 new tokens each, through
    ``generate_bucketed`` under torch.profiler; the device's busy share
    and the decode steps' device span, #9's device time (its split and
    merge kernels: no other kernel of the ``split`` namespace runs on
    this path) a decode step, and the top kernels; the split kernels
    seen must number the ``decode_gqa`` counter's launches."""
    import numpy as np

    from repro_torch.runtime.server import Request

    rng = np.random.default_rng(3)
    reqs = [Request(200 + i, rng.integers(0, cfg.vocab_size, 64).astype(np.int32),
                    max_new_tokens=8) for i in range(4)]
    srv.generate_bucketed(reqs[:1])          # warm
    outs = []

    def window():
        outs[:] = srv.generate_bucketed(reqs)
    events, wall, busy, span, seen = profiled(window, "decode_gqa")
    steps = outs[0].decode_steps
    dec9 = [e for e in events if "split::" in e.key]
    ms9 = sum(e.self_device_time_total for e in dec9) / 1e3
    mode = "graphs" if srv.cuda_graphs else "eager"
    print(f"  profile (contiguous) [{mode}]: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), decode "
          f"steps' device span {span:.1f} ms ({100 * span / (wall * 1e3):.1f}"
          f"%); {steps} decode steps of 4 rows, "
          f"{1e3 * outs[0].decode_s / steps:.2f} ms a step (capture "
          f"included); decode_gqa (#9) {ms9:.3f} ms in "
          f"{sum(e.count for e in dec9)} kernels ({seen} split kernels = "
          f"decode_gqa launches), {ms9 / steps:.3f} ms a step", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} x  "
              f"{e.key[:90]}", flush=True)


# ------------------------------------------- phase 8: f8 KV serving --

def serve_f8(float_outs, float_pool: int, params) -> None:
    """Phase 8: phase 4's weights and requests with
    ``kv_dtype="float8_e4m3fn"``, graphs then eager (equal streams); the
    pool must be a quarter of phase 4's float32 pool and the float path
    must launch exactly as counted.  Then one bucket of
    ``generate_bucketed`` (4 requests of 256-token prompts, 32 new
    tokens) on an f8 contiguous cache: #9 launches 28 x decode steps."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.server import InferenceServer, Request

    f8 = torch.float8_e4m3fn
    cfg = get_config(ARCH)
    lens, reqs = serving_requests(cfg)
    srv = InferenceServer(cfg, params=params, num_slots=8, prefill_chunk=256,
                          device="cuda", kv_dtype="float8_e4m3fn")
    fresh_peak()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.generate(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = _build.launch_counts()
    eng = srv.last_engine
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served(outs, reqs, cfg)
    require(eng.cache.k_pages.dtype == f8, "pages are not float8_e4m3fn")
    require_float_path(counts, eng, cfg, "f8 serving")
    require(4 * eng.cache.nbytes == float_pool,
            f"f8 pools {eng.cache.nbytes} B are not a quarter of float32's "
            f"{float_pool} B")
    print(f"  served {len(outs)} requests in {t_run:.2f} s: "
          f"{eng.prefill_batches} prefill dispatches, "
          f"{eng.total_decode_steps} decode steps, launches {counts}",
          flush=True)
    print_rates(eng, peak)
    agree = np.mean([np.mean(a.tokens == b.tokens)
                     for a, b in zip(float_outs, outs)])
    print(f"  page pools {eng.cache.nbytes} B float8_e4m3fn vs {float_pool} "
          f"B float32 ({eng.cache.nbytes / float_pool:.3f}x); greedy-token "
          f"agreement with phase 4 {agree:.4f} (random weights: printed, not "
          f"gated); attention bytes read {eng.attn_bytes_read}", flush=True)
    profile_decode(eng, cfg, "decode_gqa_paged")
    served = (eng.params, eng.engine_cfg, eng.kv_codes, eng.kv_dtype)
    srv.last_engine = eng = None
    serve_eager(served, reqs, outs, cfg, "decode_gqa_paged")

    rng = np.random.default_rng(4)
    breqs = [Request(i, rng.integers(0, cfg.vocab_size, 256).astype(np.int32),
                     max_new_tokens=32) for i in range(4)]
    bsrv = InferenceServer(cfg, params=params, max_len=768, num_slots=8,
                           device="cuda", kv_dtype="float8_e4m3fn")
    fresh_peak()
    _build.reset_launch_counts()
    bouts = bsrv.generate_bucketed(breqs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    bcounts = _build.launch_counts()
    check_served(bouts, breqs, cfg)
    steps = bouts[0].decode_steps
    require(bcounts.get("decode_gqa", 0) == cfg.num_layers * steps,
            f"f8 bucket: decode_gqa launches {bcounts.get('decode_gqa', 0)} "
            f"!= {cfg.num_layers} x {steps} decode steps")
    for name in PAGED_ATTENTION:
        require(bcounts.get(name, 0) == 0, f"{name} launched on the f8 "
                f"contiguous path")
    cache_bytes = (2 * cfg.num_layers * 4 * bsrv.max_len * cfg.num_kv_heads
                   * cfg.resolved_head_dim)
    print(f"  f8 bucket through generate_bucketed: {steps} decode steps, "
          f"launches {bcounts}", flush=True)
    print_bucketed(bsrv, bouts, breqs, peak, cache_bytes, "float8_e4m3fn")


# ------------------------------- phase 9: the other dense decoders --

def serve_dense_decoders() -> None:
    """Phase 9: each of OTHER_DECODERS at full width (depth cut as the
    tuple says), random weights (seed 0) quantized to 7 bits on the card,
    serves 8 requests (prompts 17..400, seed 3, 16 new tokens) through
    ``InferenceServer.generate`` with float32 pages, CUDA graphs on:
    every request ``ok``, the float path launched exactly as counted."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.server import InferenceServer, Request

    for name, layers in OTHER_DECODERS:
        cfg = get_config(name)
        if layers is not None:
            print(f"  {name}: {layers} of its {cfg.num_layers} layers "
                  f"(depth cut; widths as published)", flush=True)
            cfg = cfg.replace(num_layers=layers)
        t0 = time.perf_counter()
        srv = InferenceServer(cfg, quant_bits=7, num_slots=8,
                              prefill_chunk=256, device="cuda", rng_seed=0)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        rng = np.random.default_rng(3)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n))
                        .astype(np.int32), max_new_tokens=16)
                for i, n in enumerate(rng.integers(17, 401, 8))]
        fresh_peak()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        outs = srv.generate(reqs)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = _build.launch_counts()
        eng = srv.last_engine
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_served(outs, reqs, cfg, 16)
        require_float_path(counts, eng, cfg, name)
        print(f"  {name} (L {cfg.num_layers}, d_model {cfg.d_model}, n_kv "
              f"{cfg.num_kv_heads}, g {cfg.num_heads // cfg.num_kv_heads}, "
              f"hd {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
              f"{'tied' if cfg.tie_embeddings else 'untied'}): setup "
              f"{t_setup:.1f} s, served {len(outs)} requests in {t_run:.2f} "
              f"s, {eng.prefill_batches} prefill dispatches, "
              f"{eng.total_decode_steps} decode steps, launches {counts}",
              flush=True)
        print_rates(eng, peak)
        srv.last_engine = eng = None
        del srv
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------- phase 7: Lama primitives --

def lama_primitives(counts_out: dict) -> None:
    """Phase 7: ``lama_vector_matrix`` (Fig. 2: 8-bit v [4096] against
    M [4096, 8192]) exact against integer arithmetic, and
    ``term1_counts`` (Eq. 1's T1 counters of a 2048 x 2048 projection
    at 8 rows under 7-bit codes: 16384 dot products of 2048 terms)
    exact against its plain version and the T4 identity; counters read
    around them, then ms per call and GB/s."""
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels import _build
    from repro_torch.kernels.exp_histogram import term1_counts
    from repro_torch.kernels.exp_histogram.ref import exp_histogram_ref
    from repro_torch.kernels.lama_bulk_op import lama_vector_matrix

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    k, n = 4096, 8192
    v = torch.randint(0, 256, (k,), generator=gen, device=dev).to(torch.int32)
    mm = torch.randint(0, 256, (k, n), generator=gen, device=dev).to(torch.uint8)
    x = torch.randn(8, 2048, generator=gen, device=dev)
    w = torch.randn(2048, 2048, generator=gen, device=dev) * 0.02
    ca, pa = eq.quantize(x, 7)
    fw = eq.fit(w, 7)
    pw = eq.ExpQuantParams(fw.alpha, fw.beta, pa.base, 7)   # shared base
    # row r*2048 + j pairs activation row r with weight column j
    codes_a = ca[:, None, :].expand(8, 2048, 2048).reshape(-1, 2048)
    codes_w = eq.encode(w, pw).t()[None].expand(8, 2048, 2048).reshape(-1, 2048)
    torch.cuda.synchronize()

    _build.reset_launch_counts()
    out = lama_vector_matrix(v, mm, 8)
    t1 = term1_counts(codes_a, pa, codes_w, pw)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    counts_out.update(counts)
    for name in LAMA_PATH:
        require(counts.get(name, 0) == 1, f"{name} launched "
                f"{counts.get(name, 0)} times, not once")
    require(torch.equal(out.long(), (v.long()[:, None] * mm.long()).sum(0)),
            "lama_vector_matrix is not v @ M")
    sa, ea = eq.split_code(codes_a, pa)
    sw, ew = eq.split_code(codes_w, pw)
    signs = (sa * sw).float()
    vals = (ea - pa.e_min) + (ew - pw.e_min)
    require(torch.equal(t1, exp_histogram_ref(vals, signs, t1.shape[1])),
            "term1_counts differs from its plain version")
    require(torch.equal(t1.sum(1), signs.sum(1)),
            "term1_counts: the counts do not sum to the signed count (T4)")
    ms_vm = time_ms(lambda: lama_vector_matrix(v, mm, 8))
    ms_t1 = time_ms(lambda: term1_counts(codes_a, pa, codes_w, pw))
    vm_bytes = mm.numel() + v.numel() * 4 + n * 4
    t1_bytes = codes_a.numel() * 2 + t1.numel() * 4
    print(f"  lama_vector_matrix K={k} N={n} 8-bit: exact, {ms_vm:.4f} ms "
          f"per call ({vm_bytes / ms_vm / 1e6:.1f} GB/s of its {vm_bytes} B "
          f"of operands and result)", flush=True)
    print(f"  term1_counts G={codes_a.shape[0]} M=2048 bins={t1.shape[1]}: "
          f"exact, T4 identity holds, {ms_t1:.4f} ms per call "
          f"({t1_bytes / ms_t1 / 1e6:.1f} GB/s of its {t1_bytes} B of codes "
          f"and counters)", flush=True)


def time_encodes(params, cfg) -> None:
    """The act-site encodes of a codes decode step, alone: six
    ``encode_meta`` calls a layer at the serving rows (attn_in for k/v
    and again for q, attn_q, attn_k, attn_v, mlp_in), 28 layers, under
    the calibrated tables, captured in one CUDA graph and replayed;
    prints ms a step and kernels a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.exponential_quant import encode_meta

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    b, hd, n_kv = 8, cfg.resolved_head_dim, cfg.num_kv_heads
    g = cfg.num_heads // n_kv
    bf16 = torch.bfloat16             # the compute dtype at every site
    x = torch.randn(b, 1, cfg.d_model, generator=gen, device=dev).to(bf16)
    q = torch.randn(b, n_kv, g, hd, generator=gen, device=dev).to(bf16)
    kv = torch.randn(b, 1, n_kv, hd, generator=gen, device=dev).to(bf16)

    def encodes():
        for i in range(cfg.num_layers):
            aq = params.layer(i)["act_q"]
            encode_meta(x, aq["attn_in"]["qmeta"])
            encode_meta(x, aq["attn_in"]["qmeta"])
            encode_meta(q, aq["attn_q"]["qmeta"])
            encode_meta(kv, aq["attn_k"]["qmeta"][:, None, :])
            encode_meta(kv, aq["attn_v"]["qmeta"][:, None, :])
            encode_meta(x, aq["mlp_in"]["qmeta"])
    encodes()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        encodes()
    ms = time_ms(graph.replay, iters=20)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"  act-site encodes of a decode step (6 sites x {cfg.num_layers} "
          f"layers at 8 rows, bf16 in, one captured graph): {ms:.3f} ms "
          f"a step, "
          f"{sum(e.count for e in kernels)} kernels busy {busy:.3f} ms",
          flush=True)


def profile_decode(eng, cfg, kernel: str) -> None:
    """Where a decode step's time goes: 8 requests of 64-token prompts,
    8 new tokens each, through ``eng`` under torch.profiler (after one
    warm request, which also captures the window's keys in graph mode);
    device time by kernel, the device's busy share of the wall time and
    the steps' device span; the split-KV kernels seen must number the
    ``kernel`` counter's launches."""
    import numpy as np

    from repro_torch.runtime.server import Request

    rng = np.random.default_rng(1)
    reqs = [Request(100 + i, rng.integers(0, cfg.vocab_size, 64).astype(np.int32),
                    max_new_tokens=8) for i in range(8)]
    eng.generate(reqs[:1])          # warm
    events, wall, busy, span, seen = profiled(lambda: eng.generate(reqs),
                                              kernel)
    mode = "graphs" if eng.cuda_graphs else "eager"
    print(f"  profile [{mode}]: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%), steps' device "
          f"span {span:.1f} ms ({100 * span / (wall * 1e3):.1f}%); "
          f"{seen // cfg.num_layers} decode steps; {seen} split-KV "
          f"kernels = {kernel} launches", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} x  "
              f"{e.key[:90]}", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on a card", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    start = time.perf_counter()

    def phase(msg: str) -> None:
        print(f"{msg} (at {time.perf_counter() - start:.0f} s)", flush=True)

    logs = _build.build_all()
    phase(f"phase 1: built {len(logs)} kernel libraries")
    print("  nvcc seconds a source (all started together): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(_build.BUILD_SECONDS.items(),
                                          key=lambda kv: -kv[1])), flush=True)
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"  {name}: {len(regs)} kernels, registers {min(regs)}..{max(regs)}"
              f" per thread, {'spills: ' + '; '.join(spills) if spills else 'no spills'}")
        if name == "flash_prefill":
            prefill_build_report(log)
        if name == "lut_dequant_matmul":
            gemm_build_report(log)
        if name == "decode_gqa":
            decode_build_report(log)

    try:
        phase("phase 2: kernels vs plain versions on the card")
        tally = Tally()
        check_kernels(tally)
        check_codes_kernels(tally)
        check_lama_kernels(tally)
        tally.print_core(("lut_dequant_matmul", "lut_dequant_matmul_dual"))
        print("  #5, #7, #9 on float8_e4m3fn pages and caches:", flush=True)
        check_f8_kernels(Tally())
        print("  attention kernels at other head layouts:", flush=True)
        check_layouts(Tally())
        phase("phase 3: 2-layer full-width path checks, card vs CPU")
        path_check()
        path_check_configs()
        phase("phase 4: serving full-width qwen3-1.7b, 7-bit codes")
        counts: dict = {}
        float_outs, float_pool, params = serve(counts)
        phase("phase 5: serving with activations and KV pages as codes")
        codes_counts: dict = {}
        serve_codes(codes_counts, float_outs, float_pool, params)
        phase("phase 6: contiguous serving (generate_bucketed)")
        contig_counts: dict = {}
        serve_contiguous(contig_counts, params)
        phase("phase 7: the Lama primitives at card size")
        lama_counts: dict = {}
        lama_primitives(lama_counts)
        phase("phase 8: serving qwen3-1.7b with float8_e4m3fn KV pages")
        serve_f8(float_outs, float_pool, params)
        phase("phase 9: serving olmo-1b, minicpm-2b and qwen3-14b")
        serve_dense_decoders()
        phase("all phases passed")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # each kernel's launches on the path that first runs it
    path_counts = {**{k: lama_counts for k in LAMA_PATH},
                   "decode_gqa": contig_counts,
                   **{k: codes_counts for k in CODES_PATH},
                   **{k: counts for k in FLOAT_PATH}}
    rows = []
    for name, (src, replaces) in KERNELS.items():
        r = tally.rows[name]
        by = "operations" if r["ops_ms"] > r["bytes_ms"] else "bytes"
        launched = path_counts[name].get(name, 0)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": by, "library_ms": r["library_ms"]})
    print(card)                     # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
