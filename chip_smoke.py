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
  9. the other dense decoders: olmo-1b (8 of its 16 layers),
     minicpm-2b (10 of 40) and qwen3-14b (4 of 40), depth cut to keep
     the script's time with phase 12, at full width, 7-bit random weights,
     8 requests each through ``generate`` with float32 pages, every
     request ``ok`` and the float path's launches exact (qwen3-14b's
     untied unembedding through #1's plain layout);
 10. the prefix cache and speculative decoding (phases 4-9 serve with
     the prefix cache on, the default): phase 4's weights serve 16
     requests sharing a 500-token system prompt after one warm-up (every
     hit copies its boundary page) with the prefix cache on and off --
     reuse and copy counts, the page partition after every tick, the
     streams equal where the top-2 gap is clear, prefill tok/s and TTFT
     printed; then spec_k 1, 4 and 8 against vanilla on 8 repeating
     prompts (and spec_k 4 eager, and on phase 5's codes tables): equal
     streams where the gap is clear, the launches exact through the
     replays, one graph a ("spec", cols) key, the acceptance rate, ms
     and tokens a decode dispatch printed;
 11. mixed-precision weights, the request lifecycle, faults and
     telemetry, every step a CUDA graph, on phase 4's engine shape:
     (a) the paper's Table VI at full width -- the float weights (seed
     0) searched and quantized at 22, 28 and 34 dB on the card, the
     widths of the layer-0 tensors against the CPU's (wk and wv at every
     width, the rest where a width's SQNR lies within 0.05 dB of a
     target), avg bits, quantized fraction, top-1 agreement and relative
     logit RMSE against the float forward (2 x 32 tokens); the 22 dB tree
     serves phase 4's requests with graphs and eager (equal streams,
     exact launches, every request ok), and a 2-layer mixed tree's
     card-vs-CPU path check (1e-4 of the logits' scale); (b) cancel while
     queued, between prefill chunks and mid-decode, a deadline expiring
     mid-decode, ``max_queue`` with both shed policies and
     ``drain_queue``, a snapshot restored into a fresh engine (streams
     against phase 4's where the top-2 gap is clear), the partition
     every tick and the pool whole at the end; (c) NaN written in place
     into a decoding row's page (that request alone fails, its lane
     rests), the freed page taken again (#7 and #5 give their plain
     versions' NaN masks on such a page, and the same traffic on a
     2-layer model ends with the CPU's statuses on the card), one chaos
     corruption caught by the
     checksum audit before the next dispatch (its ms a tick printed), a
     chaos storm (every request terminal, no page leaked, ok streams
     equal the chaos-free run's where the gap is clear); (d) traced
     serving (the Chrome trace validated, decode ms a step traced
     against untraced) and the drift guard on phase 5's tables;
 12. the disaggregated cluster at full width: phase 4's weights through
     ``Cluster`` with 2 prefill and 2 decode workers and CUDA graphs --
     (a) phase 4's 12 requests: every request ok, streams equal phase
     4's where the top-2 gap is clear, the partition of every pool after
     every tick, each worker's launches exact (no #7 on a prefill
     worker, no #5 on a decode worker), one handoff a request that
     outlived its first token, the workers' weights the same tensors;
     handoff bytes, export and import ms and GB/s, graphs a worker,
     decode ms a step, peak memory printed; (b) phase 10a's
     shared-prefix traffic: the router's hit rate and steered count,
     the fleet's prefill tokens against phase 10a's; (c) (a)'s requests
     under migration chaos (seed 11, rate 0.5): drops, streams equal
     (a)'s, the trace valid with every flow closed; (d) phase 5's codes
     tables (``act_quant=7, kv_codes=True``): one fingerprint on every
     handoff, streams against phase 5's; (e) ``spec_k=4`` on the decode
     workers, streams against (a)'s; (f) ``python -m
     repro_torch.launch.serve --prefill-workers 2 --decode-workers 2
     --requests 8 --quant 7`` (qwen3-1.7b at full size: the tiny
     config's head_dim 16 is none the kernels take) as a subprocess, on
     the card;
 13. the MoE decoders at full width (d_model, heads, d_ff, experts and
     vocabulary as published), llama4-scout at 4 of its 48 layers and
     grok-1 at 2 of its 64: (k) #1, #3, #2 and #4 against their plain
     versions at the expert shapes (M the capacity rows, K x N d_model
     x d_ff and back) at phase 2's 1e-4; random weights (seed 0) drawn
     and quantized to 7 bits on the card layer by layer: phase 4's
     engine shape serves
     phase 9's 8 requests with the routed dispatch (the configs'
     default) -- every request ``ok``, the launches exact (one LUT GEMM
     an expert an einsum), the same streams and launches eagerly, the
     replayed decode step, capacity drops per routed call; (b)
     llama4-scout's dense mixture against the routed dispatch on
     prefill chunks of 16 (128 slots, the least capacity: nothing
     dropped), streams equal where the top-2 gap is clear; (d) grok-1
     in codes mode (``act_quant=7, kv_codes=True``, calibrated on the
     card), graphs and eager; (c) card against CPU on the first 2
     layers (1 of grok-1), the routing compared first (a token whose
     top-k margin clears twice the router probabilities' difference
     must pick the same experts; rows with a near-tie choice left out
     and counted), then the logits as phase 3 holds them, within the
     card's spread under weight tables jittered by phase 2's 1e-4;
 14. the policy's A/B modes and the LUT GEMMs' autotuner (every other
     phase runs the default policy, whose LUT GEMMs launch the shape
     plans; here ``autotune=True`` tunes them into
     ``build/chip_smoke_tune.json``, made afresh each run): (a) #1-#4 at
     phase 2's shapes, the shape plan and the tuned plan with their
     device times, both held to the plain version at phase 2's gate,
     and a second autotuner on the same file reading every tuned plan
     back; (b) phase 4's weights and engine shape serve 8 of its
     requests (16 new tokens, the prefix cache off) under the default
     (shape plans), ``autotune=True``, ``mode="materialize"`` and
     ``fuse_epilogues=False``: every request ``ok``,
     launches exact (no #1-#4 in materialize mode, no #2 without fused
     epilogues), streams against the default's where the top-2 gap is
     clear, then a second, replayed pass for the decode ms a step and
     the prefill tok/s; the tuner's seconds are printed.
Phase 3 prints, for olmo-1b, minicpm-2b and qwen3-14b, the card-vs-CPU
error after each layer beside the CPU's own spread under last-bit
weight tables, at the prefill chunk and the first decode step.
Phase 3 also checks the contiguous path (``prefill`` and
``decode_step``) card against CPU, and its dense decode branch against
the kernel branch on the card.  The line before the last is a JSON
object of per-kernel figures; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
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


def codes_err(out, ref, qo, label: str) -> float:
    """The uint8 tolerance: at most 1e-3 of the codes differ, each by one
    rounding step under the out table ``qo`` (a last-bit float
    difference moves a value across a rounding boundary now and then).
    Returns the differing fraction."""
    from repro_torch.core import exponential_quant as eq

    require(out.dtype == ref.dtype and out.shape == ref.shape,
            f"{label}: {out.dtype}{tuple(out.shape)} vs "
            f"{ref.dtype}{tuple(ref.shape)}")
    ok = eq.codes_agree(out, ref, qo)
    require(bool(ok.all()), f"{label}: codes more than one rounding step "
            f"apart, e.g. {out[~ok][:8].tolist()} vs {ref[~ok][:8].tolist()}")
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
        frac = codes_err(out, ref, oq, f"flash_prefill_paged_codes {rows}")
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
        frac = codes_err(out, ref, oq, f"decode_gqa_paged_codes {rows}")
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
        frac = codes_err(out, ref, qo, f"dual u8 M={m}")
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
        frac = codes_err(out, ref, qo, f"dual gated M={m}")
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
        frac = codes_err(out, ref, oq, f"flash_prefill_paged_codes {label}")
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
        frac = codes_err(out, ref, oq, f"decode_gqa_paged_codes {label}")
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
              pages=None, steps: int = PATH_STEPS, drops=None):
    """A 2-row prefill chunk of ``prompts`` and ``steps`` decode steps
    through the paged entry points on ``dev``; returns the logits of the
    chunk and of each step (on the CPU).  The decode steps take
    ``feed[i]`` as their tokens when given (the CPU's greedy tokens),
    else this run's own argmax.  ``pages``, a list, receives the K and V
    page pools at the end (on the CPU); ``drops``, a list, the slots the
    MoE layers' routed dispatch dropped in each dispatch (the cache's
    capacity tally)."""
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

    def tally():
        if drops is not None:
            drops.append(int(cache.moe_counts[2]) - sum(drops))
    tally()
    nxt = logits[:, -1].argmax(-1)
    active = torch.ones(2, dtype=torch.bool, device=dev)
    for step in range(steps):
        if feed is not None:
            nxt = feed[step].to(dev)
        for i in range(2):
            cache.ensure_capacity(i, reserved=False)
        logits, view = api.decode_step_paged(
            model, cache.view(cols=16), nxt[:, None].to(torch.int32),
            active, cfg)
        cache.lengths[:] = view.lengths.cpu().numpy()
        outs.append(logits[:, -1].float().cpu())
        tally()
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
# would not fit beside their codes, and a few of them hold the step's
# shape; each is cut to about a quarter of its depth so that the script,
# phase 12 included, stays within its time
OTHER_DECODERS = (("olmo-1b", 8), ("minicpm-2b", 10), ("qwen3-14b", 4))


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
        on_cpu, cpu_layers = layer_states(lambda: paged_run(
            api, cfg, cpu, torch.device("cpu"), torch.float32, prompts))
        feed = [o.argmax(-1) for o in on_cpu[:-1]]
        t1 = time.perf_counter()
        on_card, card_layers = layer_states(lambda: paged_run(
            api, cfg, gpu, torch.device("cuda"), torch.float32, prompts,
            feed))
        t2 = time.perf_counter()
        on_nudged, nudged_layers = layer_states(lambda: paged_run(
            api, cfg, _nudged(cpu), torch.device("cpu"), torch.float32,
            prompts, feed))
        spread = rel_err(on_nudged, on_cpu)
        print_layer_errors(name, cfg.num_layers, card_layers, cpu_layers,
                           nudged_layers)
        print(f"  {name}: CPU against itself with last-bit weight tables: "
              f"logits differ by {spread:.3e} of their scale", flush=True)
        compare(name, on_card, on_cpu, max(1e-4, 4 * spread))
        print(f"  {name} path check ok: card {t2 - t1:.2f} s, cpu "
              f"{t1 - t0:.2f} s", flush=True)
        del gpu, cpu
        gc.collect()
        torch.cuda.empty_cache()


def layer_states(run):
    """``run()`` with the hidden state after every block of every step
    recorded (on the CPU): returns (its result, the states in the order
    the blocks ran).  The blocks are ``transformer._paged_block``, which
    the paged entry points call by name."""
    from repro_torch.models import transformer

    block, states = transformer._paged_block, []

    def recorded(*args):
        x = block(*args)
        states.append(x.detach().float().cpu())
        return x

    transformer._paged_block = recorded
    try:
        return run(), states
    finally:
        transformer._paged_block = block


def print_layer_errors(name, n_layers, card, cpu, nudged) -> None:
    """Card against CPU, and the CPU against itself under last-bit weight
    tables, after each layer, relative to that layer's hidden-state
    scale: at the prefill chunk (its valid positions, PATH_LENS) and at
    the first decode step.  A layer where the card's error jumps while
    the CPU's own spread does not is a module that differs; an error
    that grows with the spread from layer 0 on is the cascade."""
    import torch

    for step, label in ((0, "prefill"), (1, "decode step 0")):
        for layer in range(n_layers):
            i = step * n_layers + layer
            r = cpu[i]
            if step == 0:   # the chunk's valid positions only
                keep = (torch.arange(r.shape[1])[None, :]
                        < torch.tensor(PATH_LENS)[:, None])
                a, r, n = card[i][keep], r[keep], nudged[i][keep]
            else:
                a, n = card[i], nudged[i]
            scale = r.abs().max().item()
            err = (a - r).abs().max().item() / scale
            own = (n - r).abs().max().item() / scale
            print(f"  {name} {label} layer {layer}: card vs CPU {err:.3e}, CPU "
                  f"spread {own:.3e} ({err / max(own, 1e-30):.1f}x) of the "
                  f"layer's scale {scale:.3e}", flush=True)


def gemm_difference(w) -> float:
    """#1 on the card against a float32 product (TF32 off) of the same
    decoded weight ``w`` (2-D codes, or its leading axis against the
    rest), 256 rows of seed-5 normal x: the largest difference over the
    product's largest magnitude."""
    import torch

    from repro_torch.kernels.lut_dequant_matmul import lut_dequant_matmul

    codes = w.codes.reshape(w.codes.shape[0], -1).contiguous()
    gen = torch.Generator(device=codes.device).manual_seed(5)
    x = torch.randn(256, codes.shape[0], generator=gen, device=codes.device)
    ref = x @ w.lut[codes.long()]
    out = lut_dequant_matmul(x, codes, w.lut, w.qmeta)
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _jittered(model, rel: float):
    """``model`` with each weight table's entries scaled by ``1 + rel`` or
    ``1 - rel``, the signs drawn from seed 0 (a perturbation of each
    weight that the next norm does not undo, as it undoes a uniform
    scale)."""
    import torch

    from repro_torch.core.exponential_quant import QWeight

    gen = torch.Generator().manual_seed(0)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif isinstance(v, QWeight):
                sign = torch.randint(0, 2, v.lut.shape, generator=gen) * 2 - 1
                out[k] = QWeight(v.codes, v.lut * (1 + rel * sign.to(
                    v.lut.device, v.lut.dtype)), v.qmeta)
            else:
                out[k] = v
        return out

    return model.with_tree(walk(model.tree()))


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
    untied), #2 L times a dispatch, #5 L times a prefill or verify
    dispatch, #7 L times a vanilla decode step, and no other kernel."""
    n = cfg.num_layers
    disp = eng.prefill_batches + eng.total_decode_steps
    spec = eng.spec_dispatches
    want = {"lut_dequant_matmul": (5 * n + 1) * disp,
            "lut_dequant_matmul_gated": n * disp,
            "flash_prefill_paged": n * (eng.prefill_batches + spec),
            "decode_gqa_paged": n * (eng.total_decode_steps - spec)}
    want = {k: v for k, v in want.items() if v}     # counters hold launches
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
    PHASE4_RATES.update(ms=1e3 * eng.decode_dispatch_s / eng.total_decode_steps,
                        tok_s=eng.decode_tokens / eng.decode_dispatch_s,
                        peak_gib=peak)
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
    PHASE5["outs"] = outs
    profile_decode(eng, cfg, "decode_gqa_paged_codes")
    time_encodes(eng.params, cfg)
    served = (eng.params, eng.engine_cfg, eng.kv_codes, eng.kv_dtype)
    srv.last_engine = eng = None
    serve_eager(served, reqs, outs, cfg, "decode_gqa_paged_codes")
    return served[0]


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


# ------------------------ phase 10: prefix cache and speculation --

PHASE10_EC = dict(num_slots=8, block_size=16, prefill_chunk=256)


def gate_streams(label, params, cfg, reqs, outs, refs,
                 floor: float = 1e-4) -> int:
    """Greedy streams equal wherever the top-2 gap is clear, as phase 3
    gates: a request whose stream leaves the reference's must do so
    where the model's top-2 logits (a card ``forward`` of the prompt and
    the common tokens) lie within twice the tolerance, ``max(floor, 4 x
    the spread)``, the spread being how far the same ``forward`` moves
    under last-bit weight tables (``_nudged``; with bf16 activations and
    28 layers a last-bit difference moves the logits far more than in
    phase 3's 2-layer float32 checks).  Returns the number of such
    requests."""
    import numpy as np
    import torch

    from repro_torch.models import api as mapi

    api = mapi.get_model(cfg)
    nudged = _nudged(params)

    def last(model, ctx):
        with torch.no_grad():
            return api.forward(model, torch.as_tensor(ctx[None], device="cuda"),
                               cfg)[0][0, -1].float()

    apart = 0
    for r, a, b in zip(reqs, outs, refs):
        n = min(len(a.tokens), len(b.tokens))
        diff = np.flatnonzero(a.tokens[:n] != b.tokens[:n])
        if not len(diff) and len(a.tokens) == len(b.tokens):
            continue
        j = int(diff[0]) if len(diff) else n
        ctx = np.concatenate([r.prompt, b.tokens[:j]]).astype(np.int64)
        logits = last(params, ctx)
        scale = max(1.0, logits.abs().max().item())
        spread = (last(nudged, ctx) - logits).abs().max().item() / scale
        tol = 2 * max(floor, 4 * spread) * scale
        top2 = logits.topk(2).values
        gap = (top2[0] - top2[1]).item()
        print(f"  {label}: request {r.uid} leaves the reference at token {j}: "
              f"top-2 gap {gap:.3e}, clear above {tol:.3e} (spread under "
              f"last-bit tables {spread:.3e} of the logits' scale)", flush=True)
        require(gap <= tol, f"{label}: request {r.uid} differs at token {j} "
                f"where the top-2 gap {gap:.3e} is clear (> {tol:.3e})")
        apart += 1
    return apart


def serve_ticked(eng, reqs):
    """``reqs`` through ``eng`` tick by tick, the page partition audited
    after every tick; the completions sorted by uid."""
    for r in reqs:
        eng.submit(r)
    while eng.pending:
        eng.step()
        eng.check_partition()
    return eng.collect()


def engine_deltas(eng, run):
    """``run()``'s completions and what it added to ``eng``'s counters
    and dispatch seconds (a namespace of the differences)."""
    import types

    names = ("prefill_batches", "prefill_tokens_computed", "prefill_dispatch_s",
             "total_decode_steps", "decode_tokens", "decode_dispatch_s",
             "spec_dispatches", "spec_proposed", "spec_accepted")
    before = {k: getattr(eng, k) for k in names}
    stats = (dataclasses.asdict(eng.prefix_stats)
             if eng.prefix is not None else {})
    outs = run()
    d = {k: getattr(eng, k) - v for k, v in before.items()}
    if eng.prefix is not None:
        d.update({k: v - stats[k]
                  for k, v in dataclasses.asdict(eng.prefix_stats).items()})
    return outs, types.SimpleNamespace(**d)


def serve_prefix_traffic(params) -> None:
    """Phase 10a: prefix traffic on phase 4's weights (8 slots, block 16,
    chunk 256, graphs).  One warm-up request, then 16 that share its
    500-token system prompt (seed 4: 31 whole pages and 4 tokens of the
    32nd, so every hit copies its boundary page), tails of 17..200
    tokens, 32 new tokens each; with the prefix cache on, then off.  Each
    engine first serves the same shapes under another system prompt, so
    that every step is captured before the measured pass.  Every request
    ok, the streams equal where the top-2 gap is clear, 500 tokens reused
    a request, the prefill tokens computed equal the prompts' less the
    reused, one copy a hit, the partition after every tick."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    cfg = get_config(ARCH)
    tails = np.random.default_rng(4).integers(17, 201, 17)

    def traffic(seed):
        rng = np.random.default_rng(seed)
        system = rng.integers(0, cfg.vocab_size, 500)
        return [Request(i, np.concatenate(
                    [system, rng.integers(0, cfg.vocab_size, int(n))]
                ).astype(np.int32), max_new_tokens=32)
                for i, n in enumerate(tails)]

    reqs = traffic(4)
    plens = sum(len(r.prompt) for r in reqs)
    runs = {}
    for on in (True, False):
        fresh_peak()
        eng = Engine(cfg, params=params, device="cuda", engine=EngineConfig(
            **PHASE10_EC, max_seq_len=768, prefix_cache=on))
        warm = traffic(5)
        serve_ticked(eng, warm[:1])
        serve_ticked(eng, warm[1:])
        graphs = eng.graph_captures()[0]

        def measured():
            serve_ticked(eng, reqs[:1])
            t0 = time.perf_counter()
            outs = serve_ticked(eng, reqs[1:])
            torch.cuda.synchronize()
            return outs, time.perf_counter() - t0

        (outs, t_run), d = engine_deltas(eng, measured)
        check_served(outs, reqs[1:], cfg)
        require(eng.graph_captures()[0] == graphs,
                "phase 10a: the measured pass captured a new step")
        ttft = np.mean([c.ttft_s for c in outs]) * 1e3
        print(f"  [prefix cache {'on' if on else 'off'}] 17 requests: prefill "
              f"{d.prefill_tokens_computed} tokens computed, "
              f"{d.prefill_tokens_computed / d.prefill_dispatch_s:.1f} tok/s "
              f"in {d.prefill_batches} dispatches; the 16: mean TTFT "
              f"{ttft:.1f} ms, served in {t_run:.3f} s (every step replayed); "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if on:
            print(f"  prefix stats of the pass: queries {d.queries}, hits "
                  f"{d.hits}, tokens reused {d.tokens_reused}, missed "
                  f"{d.tokens_missed}, copies {d.cow_copies}, evicted "
                  f"{d.evicted_pages}", flush=True)
            require(d.tokens_reused >= 16 * 500,
                    f"{d.tokens_reused} tokens reused < 16 x 500")
            require(d.prefill_tokens_computed == plens - d.tokens_reused,
                    f"prefill computed {d.prefill_tokens_computed} != "
                    f"{plens} - {d.tokens_reused} reused")
            require(d.cow_copies == d.hits >= 16,
                    f"{d.cow_copies} copies for {d.hits} hits")
            PHASE10A.update(reqs=reqs, outs=outs,
                            computed=d.prefill_tokens_computed)
        runs[on] = outs
        del eng
    apart = gate_streams("prefix on vs off", params, cfg, reqs[1:], runs[True],
                         runs[False])
    print(f"  prefix cache on vs off: {16 - apart} of 16 streams equal, "
          f"{apart} apart at a near-tie", flush=True)


def spec_prompts(cfg, params):
    """8 prompts in prompt lookup's home regime (as the reference's
    ``repetitive_prompts``): an 8-token seed and the first 24 tokens of
    the model's own greedy rollout from it (a vanilla engine's), so
    decoding repeats spans the drafter finds."""
    import numpy as np

    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, params=params, device="cuda",
                 engine=EngineConfig(**PHASE10_EC, max_seq_len=256))
    seeds = [np.random.default_rng(100 + i).integers(0, cfg.vocab_size, 8)
             .astype(np.int32) for i in range(8)]
    boots = eng.generate([Request(900 + i, s, max_new_tokens=72)
                          for i, s in enumerate(seeds)])
    return [np.concatenate([s, c.tokens[:24]]).astype(np.int32)
            for s, c in zip(seeds, boots)]


def serve_speculative(params, codes_params) -> None:
    """Phase 10b: speculative decoding on phase 4's weights.  spec_k 1,
    4 and 8 against vanilla on 8 repeating prompts (48 new tokens), each
    engine serving them twice (the first pass captures every step; the
    second is measured): streams equal where the top-2 gap is clear;
    the launches exact through the replays (a verify dispatch launches
    #5 once a layer and #1/#2 as a prefill dispatch does, #7 never); one
    graph a ("spec", cols) key; the same streams with graphs off.  Then
    spec_k 4 on phase 5's codes tables (#6 in the verify dispatch)
    against the vanilla codes engine.  The acceptance rate, ms a decode
    dispatch and tokens a dispatch are printed (random weights: not
    gated)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    cfg = get_config(ARCH)
    prompts = spec_prompts(cfg, params)
    reqs = lambda: [Request(i, p, max_new_tokens=48)
                    for i, p in enumerate(prompts)]
    n = cfg.num_layers

    def run(k, codes=False, graphs=True):
        eng = Engine(cfg, params=codes_params if codes else params,
                     kv_codes=codes, device="cuda", cuda_graphs=graphs,
                     engine=EngineConfig(**PHASE10_EC, max_seq_len=256,
                                         prefix_cache=False, spec_k=k))
        first = serve_ticked(eng, reqs())
        captured = eng.graph_captures()[0]
        _build.reset_launch_counts()
        outs, d = engine_deltas(eng, lambda: serve_ticked(eng, reqs()))
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        check_served(outs, reqs(), cfg, 48)
        require(all(np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(first, outs)),
                f"spec_k {k}: the second pass gave other streams")
        steps = d.total_decode_steps
        print(f"  [spec_k {k}{' codes' if codes else ''}"
              f"{'' if graphs else ' eager'}] {d.spec_dispatches} verify "
              f"dispatches of {steps} decode dispatches, {d.spec_accepted} "
              f"of {d.spec_proposed} drafts accepted "
              f"({d.spec_accepted / max(d.spec_proposed, 1):.3f}), "
              f"{d.decode_tokens / steps:.2f} tokens and "
              f"{1e3 * d.decode_dispatch_s / steps:.2f} ms a decode dispatch",
              flush=True)
        if graphs:
            spec = eng.step_runners["spec"]
            require(eng.graph_captures()[0] == captured,
                    f"spec_k {k}: the second pass captured a new step")
            require(all(r.graph is not None for r in spec.values())
                    and len({key[0] for key in spec}) == len(spec),
                    f"spec_k {k}: not one graph a (spec, cols) key")
            require(bool(spec) == bool(k) and (d.spec_dispatches > 0) == bool(k),
                    f"spec_k {k}: {d.spec_dispatches} verify dispatches, "
                    f"{len(spec)} verify keys")
        if codes:
            v = d.prefill_batches + d.spec_dispatches
            want = {"flash_prefill_paged_codes": n * v,
                    "decode_gqa_paged_codes": n * (steps - d.spec_dispatches),
                    "lut_dequant_matmul": d.prefill_batches + steps}
            for name, w in want.items():
                require(counts.get(name, 0) == w, f"codes spec_k {k}: {name} "
                        f"launched {counts.get(name, 0)} times, want {w}")
            for name in ("flash_prefill_paged", "decode_gqa_paged",
                         "lut_dequant_matmul_gated"):
                require(counts.get(name, 0) == 0,
                        f"codes spec_k {k}: {name} launched")
        else:
            require_float_path(counts, d, cfg, f"spec_k {k}")
        return outs

    vanilla = run(0)
    for k in (1, 4, 8):
        outs = run(k)
        apart = gate_streams(f"spec_k {k}", params, cfg, reqs(), outs, vanilla)
        print(f"  spec_k {k} vs vanilla: {8 - apart} of 8 streams equal",
              flush=True)
        if k == 4:
            eager = run(4, graphs=False)
            require(all(np.array_equal(a.tokens, b.tokens)
                        for a, b in zip(outs, eager)),
                    "spec_k 4: cuda_graphs=False gave other streams")
    codes_vanilla = run(0, codes=True)
    outs = run(4, codes=True)
    # codes logits move by a code step where #6 and #8 round an output
    # code apart: phase 3's floor for codes
    apart = gate_streams("codes spec_k 4", codes_params, cfg, reqs(), outs,
                         codes_vanilla, floor=1e-3)
    print(f"  codes spec_k 4 vs codes vanilla: {8 - apart} of 8 streams "
          f"equal", flush=True)


# ------------- phase 11: mixed widths, lifecycle, faults, telemetry --

TABLE6_TARGETS = (22.0, 28.0, 34.0)
SEARCH_BITS = (3, 4, 5, 6, 7)
# the card's widths against the CPU's: wk and wv of layer 0 at every
# width, the other tensors at each width whose card SQNR lies within
# this margin of a target (the two differ by ~1e-5 dB; a CPU fit of a
# 12.6M-element tensor takes about 16 s a width)
WIDTH_MARGIN_DB = 0.05
SQNR_RTOL = 1e-4
# phase 4's engine shape
PHASE11_EC = dict(num_slots=8, block_size=16, prefill_chunk=256)
PHASE4_RATES: dict = {}
# what phase 12 compares with: phase 5's streams, phase 10a's prefix-on
# streams and prefill tokens computed
PHASE5: dict = {}
PHASE10A: dict = {}
REPLAYED: dict = {}     # decode ms a step with every step replayed


def width_sqnrs(x) -> list[float]:
    """``x``'s round-trip SQNR at every searched width, on its device."""
    from repro_torch.core import exponential_quant as eq

    return [float(eq.sqnr_db(x, eq.fit(x, b))) for b in SEARCH_BITS]


def first_at(sqnrs, target) -> int:
    """``search_bitwidth``'s choice from the SQNR at each width."""
    return next((b for b, s in zip(SEARCH_BITS, sqnrs) if s >= target),
                SEARCH_BITS[-1])


def check_widths(dense) -> dict:
    """11a's width gate on the layer-0 tensors of the float weights: the
    SQNR at every width on the card, and on the CPU where
    WIDTH_MARGIN_DB says; recomputed SQNRs
    within SQNR_RTOL of the card's, and the widths at each target equal
    unless the CPU's SQNR ties the target (printed).  Returns {path:
    card widths at TABLE6_TARGETS}."""
    from repro_torch.core import exponential_quant as eq

    tree = dense.tree()
    picks, worst, checked, cpu_s = {}, 0.0, 0, 0.0
    for path in (("blocks", "attn", "wq"), ("blocks", "attn", "wk"),
                 ("blocks", "attn", "wv"), ("blocks", "attn", "wo"),
                 ("blocks", "mlp", "w_gate"), ("blocks", "mlp", "w_up"),
                 ("blocks", "mlp", "w_down")):
        x = tree
        for k in path:
            x = x[k]
        x = x[0].float()
        card = width_sqnrs(x)
        picks[path] = [first_at(card, t) for t in TABLE6_TARGETS]
        near = [i for i, s in enumerate(card)
                if min(abs(s - t) for t in TABLE6_TARGETS) <= WIDTH_MARGIN_DB]
        todo = (range(len(SEARCH_BITS)) if path[-1] in ("wk", "wv") else near)
        margin = min(abs(s - t) for s in card for t in TABLE6_TARGETS)
        cpu = list(card)
        if todo:
            t0 = time.perf_counter()
            xc = x.cpu()
            for i in todo:
                cpu[i] = float(eq.sqnr_db(xc, eq.fit(xc, SEARCH_BITS[i])))
                err = abs(cpu[i] - card[i])
                worst = max(worst, err / abs(cpu[i]))
                require(err <= SQNR_RTOL * abs(cpu[i]),
                        f"11a: {path} at {SEARCH_BITS[i]} bits: card SQNR "
                        f"{card[i]:.6f} dB, CPU {cpu[i]:.6f}")
                checked += 1
            cpu_s += time.perf_counter() - t0
        for t, pick in zip(TABLE6_TARGETS, picks[path]):
            want = first_at(cpu, t)
            if want != pick:
                tie = cpu[SEARCH_BITS.index(min(want, pick))]
                print(f"  11a: {'.'.join(path)} at {t} dB: card {pick} bits, "
                      f"CPU {want} (SQNR {tie:.6f} dB ties the target)",
                      flush=True)
                require(abs(tie - t) <= SQNR_RTOL * abs(tie),
                        f"11a: {path} at {t} dB: card {pick} bits, CPU {want}")
        print(f"  {'.'.join(path)} layer 0: SQNR at 3..7 bits "
              + ", ".join(f"{s:.3f}" for s in card)
              + f" dB; widths at {TABLE6_TARGETS} dB: {picks[path]}; "
              f"{len(todo)} widths on the CPU; nearest target "
              f"{margin:.3f} dB away", flush=True)
    print(f"  width gate: {checked} widths recomputed on the CPU in "
          f"{cpu_s:.1f} s, card against CPU SQNR at most {worst:.2e} of it",
          flush=True)
    return picks


def table6_and_mixed_serving() -> None:
    """Phase 11a: the paper's Table VI at full width, then serving a
    mixed-width tree."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lama_layers as ll
    from repro_torch.kernels import _build
    from repro_torch.models import api as mapi
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    cfg = get_config(ARCH)
    api = mapi.get_model(cfg)
    axes = api.logical_axes()
    dense = api.init("cuda", seed=0)
    picks = check_widths(dense)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)), device="cuda")
    with torch.no_grad():
        ref = api.forward(dense, toks, cfg)[0].float()
    mixed = None
    for target in TABLE6_TARGETS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qtree, rep = ll.quantize_tree_mixed(dense.tree(), target, axes=axes)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        model = DecoderLM(cfg, qtree, device="cuda")
        with torch.no_grad():
            got = api.forward(model, toks, cfg)[0].float()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        rmse = ((got - ref).pow(2).mean().sqrt() / (ref.std() + 1e-9)).item()
        i = TABLE6_TARGETS.index(target)
        for path in picks:
            require(rep[path][0] == picks[path][i], f"11a: {path} at "
                    f"{target} dB: quantize_tree_mixed chose {rep[path][0]}, "
                    f"the search {picks[path][i]}")
        print(f"  Table VI at {target} dB: widths "
              + ", ".join(f"{'.'.join(p[-1:] if p[0] == 'blocks' else p)} "
                          f"{b}" for p, (b, _) in rep.items())
              + f"; avg bits {ll.avg_bits(rep):.3f}, quantized fraction "
              f"{ll.quantized_fraction(qtree):.6f}, search and fit "
              f"{t_search:.2f} s; top-1 agreement with the float forward "
              f"{agree:.4f}, relative logit RMSE {rmse:.4f} (2 x 32 tokens, "
              f"seed 0; random weights)", flush=True)
        if target == TABLE6_TARGETS[0]:
            mixed = model
        del model, qtree, got
    del dense, ref

    lens, reqs = serving_requests(cfg)
    ec = EngineConfig(**PHASE11_EC, max_seq_len=int(max(lens)) + 32)
    fresh_peak()
    eng = Engine(cfg, params=mixed, engine=ec, device="cuda")
    _build.reset_launch_counts()
    outs = eng.generate(reqs)
    counts = _build.launch_counts()
    check_served(outs, reqs, cfg)
    require_float_path(counts, eng, cfg, "11a mixed")
    print(f"  22 dB tree, phase 4's 12 requests: launches {counts}", flush=True)
    print_rates(eng, torch.cuda.max_memory_allocated() / 2**30)
    p4 = PHASE4_RATES
    print(f"  decode {1e3 * eng.decode_dispatch_s / eng.total_decode_steps:.2f}"
          f" ms a step, {eng.decode_tokens / eng.decode_dispatch_s:.1f} tok/s "
          f"beside phase 4's 7-bit {p4['ms']:.2f} ms, {p4['tok_s']:.1f} tok/s "
          f"(each with its eager first ticks)", flush=True)
    # a second pass, every decode step replayed (its prompts hit the trie);
    # 11d serves 7-bit weights the same way
    again = [Request(1000 + r.uid, r.prompt, r.max_new_tokens) for r in reqs]
    _, d = engine_deltas(eng, lambda: serve_ticked(eng, again))
    REPLAYED["22 dB mixed"] = 1e3 * d.decode_dispatch_s / d.total_decode_steps
    print(f"  second pass: decode {REPLAYED['22 dB mixed']:.3f} ms a step, "
          f"{d.decode_tokens / d.decode_dispatch_s:.1f} tok/s", flush=True)
    # the engine forms no reference cycle: its pools and graphs go with
    # its last reference, before the eager engine is built
    pool = eng.cache.k_pages.nbytes + eng.cache.v_pages.nbytes
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    del eng
    freed = held - torch.cuda.memory_allocated()
    require(freed >= pool, f"11a: dropping the engine freed {freed} B, "
            f"under its {pool} B of pages")
    print(f"  dropped engine (no collection): {freed / 2**30:.3f} GiB "
          f"freed, pages {pool / 2**30:.3f} GiB", flush=True)
    off = Engine(cfg, params=mixed, engine=ec, device="cuda",
                 cuda_graphs=False)
    eager = off.generate(reqs)
    check_served(eager, reqs, cfg)
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(outs, eager)),
            "11a: the mixed tree's eager streams differ from its graphs'")
    print_rates(off, torch.cuda.max_memory_allocated() / 2**30)
    del off, mixed

    # a 2-layer card-vs-CPU path check of a mixed tree (phase 3's rule)
    cfg2 = cfg.replace(num_layers=2, compute_dtype="float32")
    api2 = mapi.get_model(cfg2)
    dense2 = api2.init("cuda", seed=1)
    qtree, rep = ll.quantize_tree_mixed(dense2.tree(), TABLE6_TARGETS[0],
                                        axes=api2.logical_axes())
    del dense2
    gpu = DecoderLM(cfg2, qtree, device="cuda")
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PATH_LENS]
    on_card = paged_run(api2, cfg2, gpu, torch.device("cuda"), torch.float32,
                        prompts)
    on_cpu = paged_run(api2, cfg2, cpu, torch.device("cpu"), torch.float32,
                       prompts)
    compare(f"2-layer 22 dB tree (avg bits {ll.avg_bits(rep):.3f})", on_card,
            on_cpu, 1e-4)


def lifecycle_under_graphs(params, float_outs) -> None:
    """Phase 11b: the request lifecycle with every step a CUDA graph, on
    phase 4's weights, engine shape and requests."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import (TERMINAL_STATUSES, Engine,
                                            EngineConfig, Request)

    cfg = get_config(ARCH)
    lens, reqs = serving_requests(cfg)
    max_seq = int(max(lens)) + 32
    ec = dict(PHASE11_EC, max_seq_len=max_seq)
    eng = Engine(cfg, params=params, device="cuda",
                 engine=EngineConfig(**ec))
    shift = [0.0]
    clock = eng._clock
    eng._clock = lambda: clock() + shift[0]     # a deadline's budget runs out
    # 4 admissions a tick into 8 slots: request 11 waits; request 0's
    # 598-token prompt takes three chunks of 256
    longest, queued = 0, 11
    require(lens[longest] > 2 * PHASE11_EC["prefill_chunk"],
            "11b: request 0's prompt fits two chunks")
    for r in reqs:
        eng.submit(Request(r.uid, r.prompt, r.max_new_tokens,
                           deadline_s=600.0 if r.uid == 2 else None))
    ticks, done = 0, {}
    events = []

    def tick():
        nonlocal ticks
        for c in eng.step():
            done[c.uid] = c
        eng.check_partition()
        ticks += 1

    require(eng.cancel(queued), "11b: the queued request was not live")
    events.append(f"cancelled {queued} while queued")
    tick()
    st = eng._states[longest]
    require(not st.prefill_done and st.prefill_pos > 0,
            f"11b: request {longest} ({lens[longest]} tokens) is not "
            f"between prefill chunks")
    require(eng.cancel(longest), "11b: the long prompt was not live")
    events.append(f"cancelled {longest} after {st.prefill_pos} of "
                  f"{lens[longest]} prompt tokens")
    while not all(eng._states[u].prefill_done and len(eng._states[u].tokens) > 4
                  for u in (1, 2) if eng._states[u].status != "finished"):
        tick()
    require(eng.cancel(1), "11b: request 1 was not live mid-decode")
    events.append(f"cancelled 1 with {len(eng._states[1].tokens)} tokens")
    shift[0] = 1000.0                            # past request 2's 600 s
    tick()
    require(eng._states[2].term == "deadline_exceeded",
            "11b: request 2's deadline did not expire mid-decode")
    events.append(f"request 2's deadline expired with "
                  f"{len(eng._states[2].tokens)} tokens")
    while eng.pending:
        tick()
    outs = eng.collect()
    require(sorted(c.uid for c in outs) == list(range(12)),
            "11b: not one completion a request")
    by = {c.uid: c.status for c in outs}
    require(all(s in TERMINAL_STATUSES for s in by.values()),
            f"11b: statuses {by}")
    want = {u: "ok" for u in range(12)}
    want.update({queued: "cancelled", longest: "cancelled", 1: "cancelled",
                 2: "deadline_exceeded"})
    require(by == want, f"11b: statuses {by}, want {want}")
    fs = eng.fault_stats()
    require(fs["cancelled"] == 3 and fs["deadline_expired"] == 1,
            f"11b: fault_stats {fs}")
    ok = [i for i in range(12) if want[i] == "ok"]
    apart = gate_streams("11b lifecycle", params, cfg, [reqs[i] for i in ok],
                         [outs[i] for i in ok], [float_outs[i] for i in ok])
    eng.prefix.evict(eng.prefix.num_pages)
    eng.check_partition()
    free, size = eng.cache.allocator.free_blocks, eng.cache.allocator.num_blocks
    require(free == size - 1, f"11b: {free} pages free of {size - 1}")
    print(f"  lifecycle ({ticks} ticks, graphs {eng.graph_captures()[0]}): "
          + "; ".join(events) + f"; the other {len(ok)} streams against phase "
          f"4's: {len(ok) - apart} equal, {apart} apart at a near-tie; "
          f"statuses {by}; pool {free} of {size - 1} pages free once the "
          f"trie is cleared", flush=True)
    del eng

    # backpressure: 12 submits against a queue of 2
    for policy in ("reject-new", "shed-oldest"):
        eng = Engine(cfg, params=params, device="cuda", engine=EngineConfig(
            **ec, max_queue=2, shed_policy=policy))
        for r in reqs:
            eng.submit(r)
        outs = serve_ticked(eng, [])
        by = {c.uid: c.status for c in outs}
        kept = [0, 1] if policy == "reject-new" else [10, 11]
        require(by == {u: "ok" if u in kept else "rejected" for u in range(12)}
                and eng.shed == 10, f"11b {policy}: {by}, shed {eng.shed}")
        same = sum(np.array_equal(outs[u].tokens, float_outs[u].tokens)
                   for u in kept)
        print(f"  max_queue 2, {policy}: kept {kept}, 10 rejected; "
              f"{same} of 2 streams equal phase 4's", flush=True)
        del eng
    eng = Engine(cfg, params=params, device="cuda", engine=EngineConfig(**ec))
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()                                   # 8 admitted, 4 queued
    drained = eng.drain_queue()
    outs = serve_ticked(eng, [])
    by = {c.uid: c.status for c in outs}
    require(drained == 4 and list(by.values()).count("rejected") == 4
            and list(by.values()).count("ok") == 8,
            f"11b drain_queue: {drained} drained, {by}")
    print(f"  drain_queue after two ticks: {drained} queued requests rejected, "
          f"8 running served", flush=True)
    del eng

    # snapshot mid-run, restore into a fresh engine on the same params
    eng = Engine(cfg, params=params, device="cuda", engine=EngineConfig(**ec))
    for r in reqs:
        eng.submit(r)
    for _ in range(6):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    live = sum(not r["terminal"] for r in snap["requests"])
    del eng
    eng2 = Engine(cfg, params=params, device="cuda", engine=EngineConfig(**ec))
    require(eng2.restore(snap) == live, "11b: restore re-queued a wrong count")
    outs = serve_ticked(eng2, [])
    check_served(outs, reqs, cfg)
    apart = gate_streams("11b restore", params, cfg, reqs, outs, float_outs)
    print(f"  snapshot after 6 ticks ({live} live, "
          f"{sum(len(r['tokens']) for r in snap['requests'])} tokens), "
          f"restored into a fresh engine: {12 - apart} of 12 streams equal "
          f"phase 4's, {apart} apart at a near-tie", flush=True)
    del eng2
    torch.cuda.synchronize()


def freed_page_kernels() -> tuple:
    """#7 and #5 on the card against their plain versions on the CPU, at
    qwen3-1.7b's head layout, for a row whose last page holds NaN past
    its length (a page freed by a failed request and taken again): the
    NaN elements of each output, kernel and plain version.  Returns
    ((kernel, plain) for #7, for #5), each a count of NaN elements, and
    requires the NaN masks equal (F4: the reference's 0 x NaN)."""
    import torch

    from repro_torch.kernels.decode_gqa import decode_gqa_paged
    from repro_torch.kernels.decode_gqa.ref import decode_gqa_paged_ref
    from repro_torch.kernels.flash_prefill import flash_prefill_paged
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_paged_ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    n_kv, g, hd, bs = 8, 2, 128, 16
    k = torch.randn(6, bs, n_kv, hd, generator=gen, device="cuda")
    v = torch.randn(6, bs, n_kv, hd, generator=gen, device="cuda")
    k[3, 5:] = float("nan")          # page 3: positions 5.. stale NaN
    v[3, 5:] = float("nan")
    table = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([2 * bs + 5], dtype=torch.int32, device="cuda")
    q = torch.randn(1, n_kv, g, hd, generator=gen, device="cuda")
    cpu = [t.cpu() for t in (q, k, v, table, lengths)]

    def masks(label, out, ref):
        a, b = torch.isnan(out.cpu()), torch.isnan(ref)
        require(torch.equal(a, b), f"11c: {label} NaN mask {int(a.sum())} "
                f"elements, its plain version's {int(b.sum())}")
        return int(a.sum()), int(b.sum())
    dec = masks("#7", decode_gqa_paged(q, k, v, table, lengths),
                decode_gqa_paged_ref(*cpu))
    qs = torch.randn(1, 4, n_kv, g, hd, generator=gen, device="cuda")
    start = lengths - 4
    args = (qs, k, v, table, start, lengths)
    pre = masks("#5", flash_prefill_paged(*args),
                flash_prefill_paged_ref(*[t.cpu() for t in args]))
    return dec, pre


def freed_nan_statuses() -> None:
    """11c's freed NaN pages, card against CPU: a 2-layer qwen3-1.7b at
    full width but for a vocabulary of 4096 (float32 compute, the same
    7-bit weights on both sides, phase 3's recipe; the CPU decodes every
    weight table a dispatch, and the vocabulary does not touch the
    pages) serves 12 requests of 17..200 tokens (8 new each) with 8
    slots;
    NaN is written into a decoding row's first page (every layer, K and
    V) between two ticks, and 8 more requests take the freed pages.
    Every status, on the card (the kernels) and on the CPU (the plain
    versions, the reference's semantics), must be equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    cfg = get_config(ARCH).replace(num_layers=2, compute_dtype="float32",
                                   vocab_size=4096)
    _, gpu = quantized_model(cfg, seed=3)
    cpu = copy.deepcopy(gpu).to("cpu")
    rng = np.random.default_rng(13)
    first = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
             for n in rng.integers(17, 201, 12)]
    more = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
            for n in rng.integers(17, 201, 8)]

    def run(model, dev):
        eng = Engine(cfg, params=model, device=dev, engine=EngineConfig(
            num_slots=8, block_size=16, prefill_chunk=256, max_seq_len=216))
        for i, p in enumerate(first):
            eng.submit(Request(i, p, max_new_tokens=8))
        decoding = lambda: [i for i, s in enumerate(eng._slots)   # noqa
                            if s is not None and s.prefill_done]
        for _ in range(60):
            if len(decoding()) == 8:
                break
            eng.step()
        require(len(decoding()) == 8, "11c: eight rows never decoded")
        row = decoding()[0]
        page = int(eng.cache.block_tables[row, 0])
        eng.cache.k_pages[:, page] = float("nan")
        eng.cache.v_pages[:, page] = float("nan")
        while eng.pending:
            eng.step()
            eng.check_partition()
        for i, p in enumerate(more):
            eng.submit(Request(100 + i, p, max_new_tokens=8))
        while eng.pending:
            eng.step()
            eng.check_partition()
        return {c.uid: c.status for c in eng.collect()}, row, page

    t0 = time.perf_counter()
    card = run(gpu, "cuda")
    t1 = time.perf_counter()
    on_cpu = run(cpu, "cpu")
    t2 = time.perf_counter()
    failed = lambda st: sorted(u for u, s in st[0].items()  # noqa: E731
                               if s != "ok")
    print(f"  freed NaN pages, 2 layers, vocabulary 4096: NaN in page "
          f"{card[2]} of row {card[1]}; failed on the card {failed(card)}, "
          f"on the CPU {failed(on_cpu)} ({t1 - t0:.1f} s / {t2 - t1:.1f} s)",
          flush=True)
    require(card == on_cpu, f"11c: the card's statuses {card} != the "
            f"CPU's {on_cpu}")


def faults_under_graphs(params, float_outs) -> None:
    """Phase 11c: a genuine device NaN, the checksum audit and a chaos
    storm, with every step a CUDA graph."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.runtime.engine import Engine, EngineConfig, Request

    cfg = get_config(ARCH)
    lens, reqs = serving_requests(cfg)
    ec = dict(PHASE11_EC, max_seq_len=int(max(lens)) + 32)

    # (i) NaN written in place into a decoding row's page between ticks
    eng = Engine(cfg, params=params, device="cuda", engine=EngineConfig(**ec))
    for r in reqs:
        eng.submit(r)
    decoding = lambda: [i for i, s in enumerate(eng._slots)   # noqa: E731
                        if s is not None and s.prefill_done]
    replayed = lambda: not eng.cuda_graphs or any(   # noqa: E731
        r.replays for r in eng.step_runners["decode"].values())
    for _ in range(40):
        if len(decoding()) == 8 and replayed():
            break
        eng.step()
    require(len(decoding()) == 8 and replayed(),
            "11c: eight rows never decoded together under a replay")
    row = decoding()[0]
    victim = eng._slots[row].request.uid
    page = int(eng.cache.block_tables[row, 0])
    ptr = eng.cache.k_pages.data_ptr()
    eng.cache.k_pages[:, page] = float("nan")
    eng.cache.v_pages[:, page] = float("nan")
    require(eng.cache.k_pages.data_ptr() == ptr, "11c: the poke moved the pool")
    eng.step()
    require(eng.result(victim) is not None
            and eng.result(victim).status == "failed"
            and eng.nan_rows_detected == 1 and row in eng._quarantined,
            f"11c: the poked row {row} (request {victim}) did not fail alone: "
            f"{eng.fault_stats()}")
    # the failed request's pages went back to the free list, NaN and all
    # (the poked page, and in layers 1.. the position it wrote as it
    # failed): who takes them
    c = eng.cache
    finite = (c.k_pages.isfinite().flatten(2).all(-1).all(0)
              & c.v_pages.isfinite().flatten(2).all(-1).all(0))
    nan_pages = set(torch.nonzero(~finite).flatten().tolist()) - {0}
    alloc, handed, took = c.allocator, [0], set()
    take = alloc.alloc

    def counted(n=1, *, reserved=True):
        out = take(n, reserved=reserved)
        handed[0] += len(nan_pages.intersection(out))
        return out
    alloc.alloc = counted
    fault = eng._fault

    def noted(st, kind):
        # a row that grows into a freed NaN page fails in that same tick
        if st.slot >= 0 and nan_pages.intersection(c.slot_blocks[st.slot]):
            took.add(st.request.uid)
        fault(st, kind)
    eng._fault = noted

    def drain_watched():
        while eng.pending:
            eng.step()
            eng.check_partition()
            took.update(s.request.uid for i, s in enumerate(eng._slots)
                        if s is not None
                        and nan_pages.intersection(c.slot_blocks[i]))
        return eng.collect()
    outs = drain_watched()
    # the reference's semantics (F4): a request that takes a freed page
    # and leaves its stale NaN past its length fails too; every failure
    # is a non-finite logits row with its artifact
    failed = [c.uid for c in outs if c.status != "ok"]
    arts = {a["uid"]: a["kind"] for a in eng.replay_artifacts}
    require(len(outs) == 12 and victim in failed
            and all(c.status in ("ok", "failed") for c in outs)
            and all(arts.get(u) == "nan_logits" for u in failed),
            f"11c: statuses {[(c.uid, c.status) for c in outs]}, "
            f"artifacts {arts}")
    others = [i for i in range(12) if i not in failed]
    apart = gate_streams("11c NaN", params, cfg, [reqs[i] for i in others],
                         [outs[i] for i in others],
                         [float_outs[i] for i in others])
    art = eng.replay_artifacts[0]
    print(f"  (i) NaN in page {page} of row {row} (request {victim}) under "
          f"graphs: request {victim} failed ({art['kind']}, tick "
          f"{art['tick']}, {len(art['flight_recorder'])} flight records), "
          f"lane quarantined; failed {failed} (NaN pages held by "
          f"{sorted(took)}); the {len(others)} ok streams: "
          f"{len(others) - apart} equal phase 4's, {apart} apart at a "
          f"near-tie", flush=True)
    # 8 more requests take the freed pages, NaN page included
    rng = np.random.default_rng(12)
    more = [Request(100 + i, rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=16)
            for i, n in enumerate(rng.integers(17, 200, 8))]
    for r in more:
        eng.submit(r)
    later = {c.uid: c.status for c in drain_watched()}
    dec, pre = freed_page_kernels()
    print(f"  pages holding NaN after the fault {sorted(nan_pages)}: handed "
          f"out {handed[0]} times, held by "
          f"requests {sorted(took)}; the 8 more requests' statuses {later} "
          f"({sum(a['kind'] == 'nan_logits' for a in eng.replay_artifacts) - 1}"
          f" more nan_logits artifacts); a row whose last page holds NaN past "
          f"its length: #7 {dec[0]} NaN elements (kernel) / {dec[1]} (plain "
          f"version), #5 {pre[0]} / {pre[1]}", flush=True)
    del eng
    freed_nan_statuses()

    # (ii) one corruption from chaos under the checksum audit (4 requests
    # of 64 tokens: the audit re-reads every recorded page each tick)
    audit = []
    eng = Engine(cfg, params=params, device="cuda", chaos=ChaosConfig(seed=0),
                 engine=EngineConfig(**ec, checksum_pages=True))
    run_audit = eng._audit_pages

    def timed_audit():
        n = len(eng._page_crc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_audit()
        audit.append((time.perf_counter() - t0, n))
    eng._audit_pages = timed_audit
    small = [Request(i, np.random.default_rng(20 + i).integers(
        0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=16)
        for i in range(4)]
    for r in small:
        eng.submit(r)
    for _ in range(4):
        eng.step()
    tokens = {r.uid: len(eng._states[r.uid].tokens) for r in small}
    eng.chaos.cfg.corrupt_rate = 1.0     # one corruption, at this tick's end
    eng.step()
    eng.chaos.cfg.corrupt_rate = 0.0
    require(eng.chaos.corrupt_faults == 1, "11c: no page was corrupted")
    eng.step()
    arts = [a for a in eng.replay_artifacts if a["kind"] == "kv_corruption"]
    require(eng.corruptions_detected == 1 and len(arts) == 1,
            f"11c: corruption not caught: {eng.fault_stats()}")
    owner = arts[0]["uid"]
    require(len(arts[0]["tokens"]) == tokens[owner] + 1,
            "11c: the corrupt page's owner decoded past the audit")
    outs = serve_ticked(eng, [])
    require([c.uid for c in outs if c.status != "ok"] == [owner],
            f"11c: statuses {[(c.uid, c.status) for c in outs]}")
    ms = [1e3 * t for t, n in audit if n]
    n_pages = np.mean([n for _, n in audit if n])
    step_ms = 1e3 * eng.decode_dispatch_s / eng.total_decode_steps
    print(f"  (ii) one chaos corruption under the audit: request {owner} "
          f"failed at the next tick before its dispatch; audit "
          f"{np.mean(ms):.2f} ms a tick (median {np.median(ms):.2f}, max "
          f"{max(ms):.2f}, {len(ms)} ticks) over {n_pages:.1f} pages "
          f"({eng.cache.bytes_per_block * n_pages / 2**20:.1f} MiB) against "
          f"a decode step of {step_ms:.2f} ms", flush=True)
    pages = list(range(1, 1 + min(368, eng.cache.allocator.num_blocks - 1)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.cache.page_checksums(pages)
    t_full = time.perf_counter() - t0
    print(f"  checksums of {len(pages)} pages "
          f"({len(pages) * eng.cache.bytes_per_block / 2**30:.2f} GiB, phase "
          f"4's traffic at its fullest) in one gather and copy: "
          f"{1e3 * t_full:.1f} ms", flush=True)
    del eng

    # (iii) a storm soak (rate 0.03) against the chaos-free run
    rng = np.random.default_rng(30)
    soak = [Request(i, rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new_tokens=16) for i, n in enumerate(
                        rng.integers(17, 129, 16))]
    clean = serve_ticked(Engine(cfg, params=params, device="cuda",
                                engine=EngineConfig(**ec)), soak)
    eng = Engine(cfg, params=params, device="cuda",
                 chaos=ChaosConfig.storm(7), engine=EngineConfig(
                     **ec, quarantine_ticks=4))
    t0 = time.perf_counter()
    outs = serve_ticked(eng, soak)
    t_soak = time.perf_counter() - t0
    by = {c.uid: c.status for c in outs}
    require(len(outs) == 16 and eng.failed == len(eng.replay_artifacts),
            f"11c storm: {len(outs)} completions, failed {eng.failed}, "
            f"{len(eng.replay_artifacts)} artifacts")
    eng.prefix.evict(eng.prefix.num_pages)
    eng.check_partition()
    require(eng.cache.allocator.free_blocks == eng.cache.allocator.num_blocks - 1,
            "11c storm: pages leaked")
    ok = [i for i in range(16) if by[i] == "ok"]
    apart = gate_streams("11c storm", params, cfg, [soak[i] for i in ok],
                         [outs[i] for i in ok], [clean[i] for i in ok])
    fs = eng.fault_stats()
    print(f"  (iii) storm (seed 7, rate 0.03) over 16 requests in "
          f"{t_soak:.2f} s: statuses {sorted(by.items())}; faults "
          + ", ".join(f"{k} {v}" for k, v in fs.items()
                      if k.startswith("chaos_") or k in (
                          "failed", "alloc_faults_absorbed",
                          "nan_rows_detected", "corruptions_detected",
                          "quarantines", "slow_ticks"))
          + f"; {len(ok) - apart} of {len(ok)} ok streams equal the "
          f"chaos-free run's; no page leaked", flush=True)
    del eng


def telemetry_and_drift(params, codes_params) -> None:
    """Phase 11d: traced serving and the drift guard."""
    import warnings

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.runtime import calibration as cal
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    from repro_torch.runtime.telemetry import Telemetry, validate_chrome_trace

    cfg = get_config(ARCH)
    lens, reqs = serving_requests(cfg)
    ec = EngineConfig(**PHASE11_EC, max_seq_len=int(max(lens)) + 32)
    tel = Telemetry(tracing=False)
    eng = Engine(cfg, params=params, device="cuda", engine=ec, telemetry=tel)
    serve_ticked(eng, [Request(900 + r.uid, r.prompt, r.max_new_tokens)
                       for r in reqs])        # captures every key
    rates = {False: [], True: []}
    ticks = {False: [], True: []}     # wall ms a tick: all of step()
    for k, traced in enumerate((False, True, False, True)):
        tel.tracer.enabled = traced
        rs = [Request(100 * (k + 1) + r.uid, r.prompt, r.max_new_tokens)
              for r in reqs]
        n0, s0 = eng.tick_latency.count, eng.tick_latency.total_s
        outs, d = engine_deltas(eng, lambda: serve_ticked(eng, rs))
        check_served(outs, rs, cfg)
        rates[traced].append(1e3 * d.decode_dispatch_s / d.total_decode_steps)
        ticks[traced].append(1e3 * (eng.tick_latency.total_s - s0)
                             / (eng.tick_latency.count - n0))
    REPLAYED["7-bit"] = float(np.mean(rates[False]))
    doc = tel.tracer.export()
    st = validate_chrome_trace(doc)
    require(st["requests"] == 24 and len(tel.traces) == 24,
            f"11d: {st['requests']} request spans, {len(tel.traces)} traces")
    print(f"  traced serving: {len(doc['traceEvents'])} events "
          f"({st['spans']} spans on {st['tracks']} tracks, "
          f"{tel.tracer.dropped} dropped), trace valid; decode ms a step "
          f"(every step replayed, prefix hits) untraced "
          + " / ".join(f"{x:.3f}" for x in rates[False]) + ", traced "
          + " / ".join(f"{x:.3f}" for x in rates[True]) + "; wall ms a "
          "tick (all of step(), from the engine's tick latency) untraced "
          + " / ".join(f"{x:.3f}" for x in ticks[False]) + ", traced "
          + " / ".join(f"{x:.3f}" for x in ticks[True]) + "; replayed "
          "decode ms a step, 7-bit against 11a's 22 dB tree: "
          f"{REPLAYED['7-bit']:.3f} / {REPLAYED['22 dB mixed']:.3f}",
          flush=True)
    reg = eng.metrics
    print("  registry: " + ", ".join(
        f"{k} {reg.value(k)}" for k in (
            "engine.decode.steps", "engine.prefill.chunks",
            "engine.lifecycle.failed", "engine.pages.peak",
            "engine.tick.p50_s", "engine.tick.p99_s")), flush=True)
    del eng

    drift = Engine(cfg, params=codes_params, act_quant=7, kv_codes=True,
                   device="cuda", engine=EngineConfig(
                       **PHASE11_EC, max_seq_len=int(max(lens)) + 32,
                       drift_check_every=8))
    require(drift.act_report is not None, "11d: no calibration report")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        outs = serve_ticked(drift, reqs)
    check_served(outs, reqs, cfg)
    sites = set(cal.report_means(drift.act_report))
    keys = set(drift.telemetry.registry.keys())
    require(drift.drift_checks > 0 and all(
        f"calib.drift.{s}_db" in keys and f"calib.drift.{s}_delta_db" in keys
        for s in sites), f"11d: {drift.drift_checks} checks, gauges "
        f"{sorted(k for k in keys if k.startswith('calib.drift'))}")
    warned = [w for w in caught if "calibration drift" in str(w.message)]
    print(f"  drift guard every 8 ticks: {drift.drift_checks} checks, "
          f"{drift.drift_warnings} warnings ({len(warned)} raised); serving "
          f"SQNR minus the report per site (dB): " + ", ".join(
              f"{s} {drift._drift_delta_db[s]:+.2f}" for s in sorted(sites))
          + " (random weights: printed, not gated)", flush=True)
    del drift


def lifecycle_phase(params, codes_params, float_outs) -> None:
    t0 = time.perf_counter()
    print("  11a: Table VI at full width, and a mixed-width tree served",
          flush=True)
    table6_and_mixed_serving()
    print("  11b: the lifecycle under graphs", flush=True)
    lifecycle_under_graphs(params, float_outs)
    print("  11c: faults under graphs", flush=True)
    faults_under_graphs(params, float_outs)
    print("  11d: telemetry and the drift guard", flush=True)
    telemetry_and_drift(params, codes_params)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------- phase 12: the disaggregated cluster --

PHASE12_CC = (2, 2)       # prefill, decode workers


def weight_ptrs(eng) -> list[int]:
    return [t.data_ptr() for t in eng.params.buffers()]


class WorkerCounts:
    """Each worker's kernel launches: a worker's ``step`` is wrapped to
    add the launch counters' change across it (replays included) to its
    own tally."""

    def __init__(self, clu):
        from repro_torch.kernels import _build

        self.by: dict[str, dict[str, int]] = {}
        for eng in clu.prefill + clu.decode:
            tally = self.by.setdefault(eng.worker_name, {})
            step = eng.step

            def counted(step=step, tally=tally):
                before = _build.launch_counts()
                out = step()
                for k, v in _build.launch_counts().items():
                    if v != before.get(k, 0):
                        tally[k] = tally.get(k, 0) + v - before.get(k, 0)
                return out
            eng.step = counted


class HandoffTimes:
    """CUDA events and wall time around every ``export_slot`` of the
    prefill workers and every ``import_slot`` of the decode workers (the
    events bracket the call, the wall time ends after a synchronise, so
    each is the handoff's whole cost); the fingerprints the exports
    carry."""

    def __init__(self, clu):
        import torch

        self.rows = {"export": [], "import": []}

        def wrap(cache, kind):
            fn = getattr(cache, f"{kind}_slot")

            def timed(*a, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                nbytes = (len(out) * cache.bytes_per_block
                          if kind == "import" else out[0].nbytes * 2)
                self.rows[kind].append((e0.elapsed_time(e1), 1e3 * wall,
                                        nbytes))
                return out
            setattr(cache, f"{kind}_slot", timed)
        for eng in clu.prefill:
            wrap(eng.cache, "export")
        for eng in clu.decode:
            wrap(eng.cache, "import")

    def line(self, kind: str, start: int = 0) -> str:
        """Mean figures of the handoffs from the ``start``-th on."""
        import numpy as np

        rows = self.rows[kind][start:]
        if not rows:
            return f"{kind}: none"
        ev, wall, nb = (np.array(c, float) for c in zip(*rows))
        return (f"{kind} {len(rows)}: {np.mean(nb) / 2**20:.1f} MiB, "
                f"{np.mean(ev):.3f} ms (events) / {np.mean(wall):.3f} ms "
                f"(wall) a handoff, {np.sum(nb) / np.sum(ev) / 1e6:.2f} / "
                f"{np.sum(nb) / np.sum(wall) / 1e6:.2f} GB/s")


def pinned_costs(nbytes: int) -> None:
    """Where an export's time goes: a pinned host allocation of a
    handoff's size, a second one of that size (the caching host
    allocator's), and one device-to-host copy into pinned memory."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        times.append(time.perf_counter() - t0)
        del host
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host.copy_(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host.copy_(dev)
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    print(f"  a handoff's {nbytes / 2**20:.1f} MiB: pinned allocation "
          f"{1e3 * times[0]:.2f} ms first, {1e3 * times[1]:.2f} ms second; "
          f"device-to-pinned copy {1e3 * t_copy:.3f} ms "
          f"({nbytes / t_copy / 1e9:.2f} GB/s)", flush=True)


def drain_cluster(clu, reqs) -> list:
    """``reqs`` through the cluster tick by tick, every worker's page
    partition audited after every tick; completions by uid."""
    for r in reqs:
        clu.submit(r)
    done = []
    while clu.pending:
        done += clu.step()
        clu.check_partition()
    return sorted(done, key=lambda c: c.uid)


def make_cluster(params, ec, **kw):
    from repro_torch.configs import get_config
    from repro_torch.runtime.cluster import Cluster, ClusterConfig
    from repro_torch.runtime.engine import EngineConfig

    return Cluster(get_config(ARCH), params=params, device="cuda",
                   cluster=ClusterConfig(*PHASE12_CC),
                   engine=EngineConfig(**ec), **kw)


def cluster_full_width(params, float_outs) -> dict:
    """12a: phase 4's 12 requests through 2 prefill and 2 decode workers
    with graphs; returns the completions."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(ARCH)
    lens, reqs = serving_requests(cfg)
    ec = dict(PHASE11_EC, max_seq_len=int(max(lens)) + 32)
    fresh_peak()
    base = torch.cuda.memory_allocated()
    clu = make_cluster(params, ec)
    ptrs = weight_ptrs(clu.prefill[0])
    require(all(weight_ptrs(e) == ptrs for e in clu.prefill + clu.decode),
            "12a: the workers hold separate weight tensors")
    pools = sum(e.cache.nbytes for e in clu.prefill + clu.decode)
    counts, times = WorkerCounts(clu), HandoffTimes(clu)
    t0 = time.perf_counter()
    outs = drain_cluster(clu, reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    check_served(outs, reqs, cfg)
    want = sum(r.max_new_tokens > 1 for r in reqs)
    require(clu.handoffs == want and clu.migration_faults == 0,
            f"12a: {clu.handoffs} handoffs, want {want}")
    for eng in clu.prefill + clu.decode:
        got = counts.by[eng.worker_name]
        require_float_path(got, eng, cfg, f"12a {eng.worker_name}")
    require(all(counts.by[e.worker_name].get("decode_gqa_paged", 0) == 0
                for e in clu.prefill)
            and all(counts.by[e.worker_name].get("flash_prefill_paged", 0)
                    == 0 for e in clu.decode),
            f"12a: a worker launched the other role's attention: {counts.by}")
    require(all(e.prefill_tokens_computed == 0 for e in clu.decode)
            and not any(e.step_runners["decode"] for e in clu.prefill)
            and not any(e.step_runners["prefill"] for e in clu.decode),
            "12a: a worker ran the other role's step")
    apart = gate_streams("12a", params, cfg, reqs, outs, float_outs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dec_s = sum(e.decode_dispatch_s for e in clu.decode)
    dec_n = sum(e.total_decode_steps for e in clu.decode)
    st = clu.stats()
    print(f"  (a) 12 requests on {PHASE12_CC[0]}P/{PHASE12_CC[1]}D in "
          f"{t_run:.2f} s over {clu.ticks} ticks: {12 - apart} of 12 streams "
          f"equal phase 4's, {apart} apart at a near-tie; handoffs "
          f"{clu.handoffs}, {clu.handoff_bytes} B "
          f"({clu.handoff_bytes / clu.handoffs / 2**20:.1f} MiB a handoff)",
          flush=True)
    print(f"  {times.line('export')}; {times.line('import')}", flush=True)
    pinned_costs(clu.handoff_bytes // clu.handoffs)
    # a second pass of the same requests (new uids): every decode step
    # replays, the prompts hit the prefill workers' tries
    again = drain_cluster(clu, [dataclasses.replace(r, uid=100 + r.uid)
                                for r in reqs])
    require([c.tokens.tolist() for c in again]
            == [c.tokens.tolist() for c in outs],
            "12a: the second pass's streams differ from the first's")
    dec_s2 = sum(e.decode_dispatch_s for e in clu.decode) - dec_s
    dec_n2 = sum(e.total_decode_steps for e in clu.decode) - dec_n
    print(f"  second pass, pinned blocks cached: "
          f"{times.line('export', len(reqs))}; "
          f"{times.line('import', len(reqs))}", flush=True)
    graphs = {e.worker_name: e.graph_captures()[0]
              for e in clu.prefill + clu.decode}
    print(f"  graphs captured {graphs}; decode workers {1e3 * dec_s / dec_n:.2f}"
          f" ms a step over {dec_n} steps, eager first ticks included (phase "
          f"4: {PHASE4_RATES.get('ms', float('nan')):.2f}), "
          f"{1e3 * dec_s2 / dec_n2:.3f} over the second pass's {dec_n2} "
          f"(every step replayed); prefill tokens "
          f"{st['prefill_tokens_computed']}; launches {counts.by}", flush=True)
    print(f"  peak {peak:.2f} GiB (phase 4, one engine: "
          f"{PHASE4_RATES.get('peak_gib', float('nan')):.2f} GiB), "
          f"{pools / 2**30:.2f} GiB of pools in 4 workers, "
          f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB held "
          f"beyond the weights; weights once ({len(ptrs)} tensors, every "
          f"worker's the same)", flush=True)
    del clu
    return outs


def cluster_phase(params, codes_params, float_outs) -> None:
    """Phase 12: the disaggregated cluster at full width."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.runtime import calibration as cal
    from repro_torch.runtime.chaos import ChaosConfig
    from repro_torch.runtime.telemetry import Telemetry, validate_chrome_trace

    cfg = get_config(ARCH)
    lens, reqs = serving_requests(cfg)
    ec = dict(PHASE11_EC, max_seq_len=int(max(lens)) + 32)
    outs_a = cluster_full_width(params, float_outs)

    # (b) phase 10a's shared-prefix traffic
    fresh_peak()
    pre = PHASE10A["reqs"]
    clu = make_cluster(params, dict(PHASE10_EC, max_seq_len=768))
    outs = drain_cluster(clu, pre[:1])
    outs = drain_cluster(clu, pre[1:])
    check_served(outs, pre[1:], cfg)
    st, rs = clu.stats(), clu.router.stats
    apart = gate_streams("12b", params, cfg, pre[1:], outs, PHASE10A["outs"])
    require(rs.prefix_hits >= 16, f"12b: {rs.prefix_hits} prefix hits")
    print(f"  (b) 17 requests sharing a 500-token prompt: router hit rate "
          f"{rs.cross_worker_hit_rate:.4f} ({rs.prefix_hits} of {rs.routed}), "
          f"steered {rs.steered}; prefill tokens computed across the fleet "
          f"{st['prefill_tokens_computed']} (phase 10a, one engine with "
          f"the prefix cache: {PHASE10A['computed']}); shard pages "
          f"{st['shard_pages']}; {16 - apart} of 16 streams equal phase "
          f"10a's", flush=True)
    del clu

    # (c) migration chaos, traced
    fresh_peak()
    tel = Telemetry(tracing=True)
    clu = make_cluster(params, ec, telemetry=tel,
                       chaos=ChaosConfig(seed=11, migration_fail_rate=0.5))
    t0 = time.perf_counter()
    outs = drain_cluster(clu, reqs)
    t_run = time.perf_counter() - t0
    check_served(outs, reqs, cfg)
    require(clu.migration_faults > 0, "12c: no migration fault fired")
    require(clu.handoffs == len(reqs), f"12c: {clu.handoffs} handoffs")
    apart = gate_streams("12c", params, cfg, reqs, outs, outs_a)
    doc = tel.tracer.export()
    tr = validate_chrome_trace(doc, require_boundary=True)
    drops = sum(e["ph"] == "f" and bool(e["args"].get("dropped"))
                for e in doc["traceEvents"])
    require(drops == clu.migration_faults, f"12c: {drops} dropped flows")
    print(f"  (c) migration chaos (seed 11, rate 0.5): {clu.migration_faults} "
          f"drops re-queued, {clu.handoffs} handoffs delivered, "
          f"{12 - apart} of 12 streams equal (a)'s; {t_run:.2f} s; trace "
          f"{len(doc['traceEvents'])} events valid, {tr['flows']} flows "
          f"closed ({drops} at a drop)", flush=True)
    del clu, tel

    # (d) codes: phase 5's tables, no second calibration
    fresh_peak()
    clu = make_cluster(codes_params, ec, kv_codes=True)
    fp = cal.kv_tables_fingerprint(codes_params.tree()["blocks"]["act_q"])
    fps = []
    for eng in clu.prefill:
        export = eng._export_handoff

        def noted(slot, st, export=export, eng=eng):
            export(slot, st)
            fps.append(eng.outbox[-1].kv_fingerprint)
        eng._export_handoff = noted
    outs = drain_cluster(clu, reqs)
    check_served(outs, reqs, cfg)
    require(len(fps) == len(reqs) and set(fps) == {fp},
            f"12d: handoff fingerprints {set(fps)}, the tables' {fp}")
    apart = gate_streams("12d codes", codes_params, cfg, reqs, outs,
                         PHASE5["outs"], floor=1e-3)
    print(f"  (d) codes (act_quant 7, kv_codes, phase 5's tables): "
          f"{clu.handoffs} handoffs of one fingerprint ({fp:#010x}), "
          f"{clu.handoff_bytes / clu.handoffs / 2**20:.1f} MiB a handoff; "
          f"{12 - apart} of 12 streams equal phase 5's", flush=True)
    del clu

    # (e) speculating decode workers
    fresh_peak()
    clu = make_cluster(params, dict(ec, spec_k=4))
    outs = drain_cluster(clu, reqs)
    check_served(outs, reqs, cfg)
    spec = sum(e.spec_dispatches for e in clu.decode)
    require(spec > 0 and all(e.spec_dispatches == 0 for e in clu.prefill),
            f"12e: verify dispatches {spec} on the decode workers")
    apart = gate_streams("12e spec_k 4", params, cfg, reqs, outs, outs_a)
    acc = (sum(e.spec_accepted for e in clu.decode)
           / max(1, sum(e.spec_proposed for e in clu.decode)))
    print(f"  (e) spec_k 4 on the decode workers: {spec} verify dispatches, "
          f"acceptance {acc:.3f}; {12 - apart} of 12 streams equal (a)'s",
          flush=True)
    del clu

    # (f) the launcher, as a user runs it, at qwen3-1.7b's full size
    # (its tiny config's head_dim 16 is none the kernels take)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--prefill-workers", "2", "--decode-workers", "2",
           "--requests", "8", "--quant", "7"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    name = torch.cuda.get_device_name(0)
    require(res.returncode == 0, f"12f: the launcher exited "
            f"{res.returncode}: {res.stderr[-2000:]}")
    require(f"device: {name}" in res.stdout,
            f"12f: the launcher did not run on {name}: {res.stdout[:500]}")
    served = [ln for ln in res.stdout.splitlines() if ln.startswith("served")]
    require(len(served) == 1 and served[0].startswith("served 8 requests"),
            f"12f: {served}")
    print(f"  (f) {' '.join(cmd[1:])}: exit 0 on {name} in "
          f"{time.perf_counter() - t0:.1f} s; {served[0]}", flush=True)


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


# ------------------------------------------- phase 13: the MoE decoders --

# (arch, layers served, layers of the card-vs-CPU path check): the depth
# cut to keep the script's time and the card's memory (the expert codes
# alone are 2.01 GB a layer of llama4-scout, 4.83 GB of grok-1); widths
# as published
MOE_DECODERS = (("llama4-scout-17b-a16e", 4, 2), ("grok-1-314b", 2, 1))
# each table of phase 13's random weights is fit on at most this many
# leading elements of its tensor, and an expert stack's on expert 0's
# matrix: every element of a tensor is drawn alike, and one fit over
# grok-1's 1.6 G-element layer stack would hold tens of GB
MOE_FIT_ELEMS = 2 ** 26
# 13c's decode steps after its prefill chunk: each costs the CPU a full
# expert pass (capacity 128 whatever the tokens), about 3 s a layer of
# llama4-scout and 7 s of grok-1 (the CPU's time sets grok-1's 1 layer)
MOE_PATH_STEPS = 2
# 8 slots x 16 positions = 128 slots a prefill dispatch (top-1), at most
# the routed dispatch's least capacity: no token can be dropped
MOE_ROOMY_CHUNK = 16
# 13c's weight-table jitter: phase 2's gate on the LUT GEMMs (1e-4 of the
# product's largest magnitude), which 13k holds #1, #2 and #3 to at the
# MoE path's own shapes, and which #1's difference from float32 on the
# served model's layer-0 wq must not exceed; 13c's tolerance is the
# card's spread under it
MOE_JITTER = 1e-4
# 13c: the least share of the router's tokens that must route the same on
# the card and on the CPU (1.0 in every run so far)
MOE_ROUTE_SHARE = 0.9
PHASE13: dict = {}


def moe_gemm_checks(cfg, card) -> None:
    """13k: the LUT GEMMs at the MoE path's own shapes, each held to its
    plain version on the card at phase 2's gate (1e-4 of the plain
    version's largest magnitude).  The routed dispatch runs each expert
    einsum at M = the capacity rows (128 at a decode step and at 13b's
    chunks of 8 x 16; 256 for llama4-scout and 640 for grok-1 at 13a's
    chunks of 8 x 256): #1 at K x N = d_model x d_ff (gate, up) and d_ff
    x d_model (down), x in the served bfloat16 and in 13b / 13c's
    float32; #3 at d_model x d_ff (codes mode's gate and up).  The dense
    mixture (13b, llama4-scout) runs #2 an expert at M = 8 and 128, and
    #4 at the same shapes in codes mode (activation codes in, float
    out, as ``apply_moe_dense`` calls it).
    Weights of std 0.02 fit and encoded by the port's quantizer, passed
    with their table and metadata as the path passes them.  Prints each
    shape's kernel and plain-version times beside the card; none enters
    the kernels line (phase 2's shapes make it)."""
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.lut_dequant_matmul import (
        lut_dequant_matmul, lut_dequant_matmul_dual,
        lut_dequant_matmul_dual_gated, lut_dequant_matmul_gated)
    from repro_torch.kernels.lut_dequant_matmul.ref import (
        lut_dequant_matmul_dual_gated_ref, lut_dequant_matmul_dual_ref,
        lut_dequant_matmul_gated_ref, lut_dequant_matmul_ref)
    from repro_torch.models import moe as M
    from repro_torch.runtime.calibration import ACT_BASES

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    d, f = cfg.d_model, cfg.d_ff
    rows = sorted({M._capacity(cfg, t) for t in (8, 8 * MOE_ROOMY_CHUNK,
                                                  8 * 256)})

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def qweight(k, n):
        codes, p = eq.quantize(rnd(k, n, scale=0.02), 7)
        return codes, eq.decode_table(p), eq.pack_qmeta(p)

    def gate(label, kernel, plain):
        out, ref = kernel(), plain()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item()
        print(f"    {label}: err {err:.3e} (tol {tol:.3e}), kernel "
              f"{time_ms(kernel, flush=flush):.4f} ms, plain "
              f"{time_ms(plain, flush=flush):.4f} ms", flush=True)
        require(err <= tol, f"13k {cfg.name} {label}: max err {err} > {tol}")

    print(f"  13k {cfg.name}: the LUT GEMMs at the expert shapes, M = "
          f"{rows} capacity rows [{card}]", flush=True)
    for k, n in ((d, f), (f, d)):
        c, lut, qm = qweight(k, n)
        for m in rows:
            for dt in (torch.bfloat16, torch.float32):
                x = rnd(m, k).to(dt)
                gate(f"#1 M={m} K={k} N={n} x {str(dt)[6:]}",
                     lambda: lut_dequant_matmul(x, c, lut, qm,
                                                out_dtype=torch.float32),
                     lambda: lut_dequant_matmul_ref(x, c, lut, qm))
            if (k, n) == (d, f):
                xs = rnd(m, k)
                px = eq.fit(xs, 7, bases=ACT_BASES)
                args = (eq.encode(xs, px), c, eq.decode_table(px), lut,
                        eq.pack_qmeta(px), qm)
                gate(f"#3 M={m} K={k} N={n} x codes",
                     lambda: lut_dequant_matmul_dual(*args),
                     lambda: lut_dequant_matmul_dual_ref(*args))
        del c, lut, qm
    if cfg.name.startswith("llama4"):
        (cg, lg, qg), (cu, lu, qu) = qweight(d, f), qweight(d, f)
        for m in (8, 8 * MOE_ROOMY_CHUNK):
            x = rnd(m, d)
            gate(f"#2 M={m} K={d} N={f} x float32 ({cfg.activation})",
                 lambda: lut_dequant_matmul_gated(
                     x, cg, cu, lg, lu, qg, qu, activation=cfg.activation,
                     out_dtype=torch.float32),
                 lambda: lut_dequant_matmul_gated_ref(
                     x, cg, cu, lg, lu, qg, qu, activation=cfg.activation))
            xs = rnd(m, d)
            px = eq.fit(xs, 7, bases=ACT_BASES)
            args = (eq.encode(xs, px), cg, cu, eq.decode_table(px), lg, lu,
                    eq.pack_qmeta(px), qg, qu)
            gate(f"#4 M={m} K={d} N={f} x codes ({cfg.activation})",
                 lambda: lut_dequant_matmul_dual_gated(
                     *args, activation=cfg.activation),
                 lambda: lut_dequant_matmul_dual_gated_ref(
                     *args, activation=cfg.activation))
    del flush
    torch.cuda.empty_cache()


def moe_random_model(cfg, seed: int):
    """A card model of ``cfg`` with random weights drawn on the card from
    ``seed`` and the matmul weights quantized to 7 bits as they are drawn:
    a layer-stacked leaf layer by layer, an expert stack expert by expert
    (one table a layer, shared by its experts, as ``quantize_tree``
    lays it out), so no float tensor larger than one expert's matrix or
    one embedding table is ever held.  The stds are ``init_params``'s;
    the router and the norms stay float."""
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.core import lama_layers as ll
    from repro_torch.models import params as P
    from repro_torch.models.transformer import DecoderLM, model_specs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=dev).mul_(std)

    def fit(x):
        return eq.fit(x.reshape(-1)[:MOE_FIT_ELEMS], 7)

    def quantized(spec):
        std = P.spec_std(spec)
        stacked = spec.axes[0] == "layers"
        shape = spec.shape[1:] if stacked else spec.shape
        n = spec.shape[0] if stacked else 1
        codes = torch.empty((n,) + shape, dtype=torch.uint8, device=dev)
        luts, metas = [], []
        for i in range(n):
            if spec.axes[int(stacked)] == "experts":
                qp = None
                for e in range(shape[0]):
                    x = draw(shape[1:], std)
                    qp = qp or fit(x)
                    codes[i, e] = eq.encode(x, qp)
            else:
                x = draw(shape, std)
                qp = fit(x)
                codes[i] = eq.encode(x, qp)
            del x
            luts.append(eq.decode_table(qp))
            metas.append(eq.pack_qmeta(qp))
        if stacked:
            return eq.QWeight(codes, torch.stack(luts), torch.stack(metas))
        return eq.QWeight(codes[0], luts[0], metas[0])

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if ll.default_predicate(path, torch.empty(node.shape, device="meta")):
            return quantized(node)
        return P._init_leaf(node, gen, dev, torch.float32)

    return DecoderLM(cfg, build(model_specs(cfg), ()), device="cuda")


def moe_launches(eng, cfg, codes: bool = False) -> dict:
    """The MoE path's launches, exactly: a routed layer runs one GEMM an
    expert an einsum -- float, #1 for gate, up and down (3E); codes,
    #3 for gate and up (2E, the buffer encoded once at mlp_in) and #1
    for down (E) -- beside the attention's four projections (#1, or #3
    on codes); the dense mixture runs #2 (gate and up) and #1 (down)
    an expert; the untied unembedding #1; #5 / #6 L times a prefill
    dispatch and #7 / #8 L times a decode step."""
    n, e = cfg.num_layers, cfg.num_experts
    pre, dec = eng.prefill_batches, eng.total_decode_steps
    disp = pre + dec
    if codes:
        want = {"lut_dequant_matmul_dual": (4 + 2 * e) * n * disp,
                "lut_dequant_matmul": (e * n + 1) * disp,
                "flash_prefill_paged_codes": n * pre,
                "decode_gqa_paged_codes": n * dec}
    elif cfg.moe_impl == "dense_mixture":
        want = {"lut_dequant_matmul_gated": e * n * disp,
                "lut_dequant_matmul": ((4 + e) * n + 1) * disp,
                "flash_prefill_paged": n * pre, "decode_gqa_paged": n * dec}
    else:
        want = {"lut_dequant_matmul": ((4 + 3 * e) * n + 1) * disp,
                "flash_prefill_paged": n * pre, "decode_gqa_paged": n * dec}
    return {k: v for k, v in want.items() if v}


def moe_requests(cfg):
    """Phase 9's traffic: 8 requests, prompts 17..400 (seed 3), 16 new
    tokens each."""
    import numpy as np

    from repro_torch.runtime.server import Request

    rng = np.random.default_rng(3)
    return [Request(i, rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=16)
            for i, n in enumerate(rng.integers(17, 401, 8))]


def serve_moe_engine(label, cfg, model, reqs, ec, codes=False, graphs=True,
                     act_quant=None):
    """``reqs`` through a fresh Engine on ``model`` (graphs on or off);
    every request ``ok`` and the launches exact.  Returns (completions,
    the engine, launches, its capacity tally, peak GiB, seconds)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.runtime.engine import Engine, EngineConfig

    fresh_peak()
    eng = Engine(cfg, params=model, engine=EngineConfig(**ec),
                 act_quant=act_quant, kv_codes=codes, device="cuda",
                 cuda_graphs=graphs)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_served(outs, reqs, cfg, 16)
    want = moe_launches(eng, cfg, codes)
    require(launches == want, f"{label}: launches {launches}, want {want}")
    return outs, eng, launches, eng.cache.moe_capacity(), peak, t_run


def print_moe_run(label, eng, launches, cap, peak, t_run, card) -> None:
    """A phase-13 run's launches, then its rates, peak memory, page-pool
    bytes and capacity drops (a dispatch: the routed calls of all its
    layers) beside the card."""
    steps, n = eng.total_decode_steps, eng.cfg.num_layers
    graphs, capture_s = eng.graph_captures()
    drops = (f"{cap['dropped']} of {cap['slots']} slots dropped in "
             f"{cap['calls']} routed calls, "
             f"{cap['dropped'] * n / cap['calls']:.1f} a dispatch"
             if cap["calls"] else "no routed call")
    print(f"  {label}: launches {launches}; {eng.prefill_batches} prefill "
          f"dispatches, {steps} decode steps in {t_run:.2f} s; {graphs} "
          f"graphs captured in {capture_s:.2f} s", flush=True)
    print(f"    decode {1e3 * eng.decode_dispatch_s / steps:.2f} ms a step "
          f"(eager first ticks in), prefill "
          f"{eng.prefill_tokens_computed / eng.prefill_dispatch_s:.1f} "
          f"tok/s, peak {peak:.2f} GiB, page pools {eng.cache.nbytes} B "
          f"({eng.cache.k_pages.dtype}), capacity: {drops} [{card}]",
          flush=True)


def moe_replayed_ms(eng, reqs) -> float:
    """Decode ms a step of ``reqs`` served again on ``eng`` (new uids; its
    decode keys captured by the first pass, so every step replays)."""
    import dataclasses as dc

    again = [dc.replace(r, uid=r.uid + 1000) for r in reqs]
    _, d = engine_deltas(eng, lambda: eng.generate(again))
    return 1e3 * d.decode_dispatch_s / d.total_decode_steps


def serve_moe_decoder(name: str, layers: int, check_layers: int,
                      card: str) -> None:
    """Phase 13 for one MoE config: 13k, its LUT GEMMs at the expert
    shapes; then full width, ``layers`` deep, random weights (seed 0)
    quantized on the card; phase 4's engine shape (8
    slots, block 16, chunk 256, graphs, prefix cache on) serves phase
    9's 8 requests -- every request ``ok``, the launches exact, the same
    streams and launches eagerly; the replayed decode step; then, for
    llama4-scout, the dense mixture against the routed dispatch where
    capacity cannot bind, for grok-1, codes mode; then the card-vs-CPU
    path check on the first ``check_layers`` layers."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(name)
    print(f"  {name}: {layers} of its {cfg.num_layers} layers (depth cut; "
          f"widths as published: d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, "
          f"{cfg.num_heads} / {cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size})", flush=True)
    cfg = cfg.replace(num_layers=layers)
    moe_gemm_checks(cfg, card)
    fresh_peak()
    t0 = time.perf_counter()
    model = moe_random_model(cfg, 0)
    torch.cuda.synchronize()
    nbytes = sum(b.numel() * b.element_size() for b in model.buffers())
    print(f"    weights drawn and quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s: {nbytes / 1e9:.2f} GB, set-up "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    reqs = moe_requests(cfg)
    ec = dict(num_slots=8, block_size=16, prefill_chunk=256,
              max_seq_len=max(len(r.prompt) for r in reqs) + 16)
    outs, eng, launches, cap, peak, t_run = serve_moe_engine(
        "13a", cfg, model, reqs, ec)
    print_moe_run(f"13a {name} [graphs]", eng, launches, cap, peak, t_run,
                  card)
    ms = moe_replayed_ms(eng, reqs)
    print(f"    decode {ms:.3f} ms a step replayed (second pass) [{card}]",
          flush=True)
    PHASE13[name] = dict(ms=ms, peak=peak, cap=cap, launches=launches,
                         steps=eng.total_decode_steps,
                         prefill=eng.prefill_batches)
    del eng
    eager, eng, launches_e, cap_e, peak_e, t_e = serve_moe_engine(
        "13a eager", cfg, model, reqs, ec, graphs=False)
    require(launches_e == launches and cap_e == cap,
            f"13a {name}: eager launches {launches_e} / capacity {cap_e}, "
            f"graphs {launches} / {cap}")
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(outs, eager)),
            f"13a {name}: cuda_graphs=False gave other token streams")
    print_moe_run(f"13a {name} [eager, streams equal the graphs']", eng,
                  launches_e, cap_e, peak_e, t_e, card)
    del eng
    if name.startswith("llama4"):
        moe_dense_vs_routed(cfg, model, reqs, ec, card)
    else:
        moe_codes(cfg, model, reqs, ec, card)
    gc.collect()
    torch.cuda.empty_cache()
    moe_path_check(name, cfg, model, check_layers)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_dense_vs_routed(cfg, model, reqs, ec, card) -> None:
    """13b: the dense mixture (every expert on every token) against the
    routed dispatch, both on an engine whose prefill dispatch holds 8 x
    MOE_ROOMY_CHUNK = 128 slots, the least capacity, so no token is
    dropped (the counter shows none): streams equal wherever the top-2
    gap is clear.  Float32 compute on both: the two round their bf16
    activations at other places (the gated kernel's product against
    three GEMMs), which a random model's small logit gaps turn into
    other tokens within a few steps."""
    roomy = dict(ec, prefill_chunk=MOE_ROOMY_CHUNK)
    cfg = cfg.replace(compute_dtype="float32")
    routed, eng, launches, cap, peak, t_r = serve_moe_engine(
        "13b routed", cfg, model, reqs, roomy)
    require(cap["dropped"] == 0, f"13b: {cap['dropped']} slots dropped")
    print_moe_run(f"13b routed, chunk {MOE_ROOMY_CHUNK}", eng, launches, cap,
                  peak, t_r, card)
    del eng
    dcfg = cfg.replace(moe_impl="dense_mixture")
    dense, eng, launches, cap, peak, t_d = serve_moe_engine(
        "13b dense mixture", dcfg, model, reqs, roomy)
    print_moe_run(f"13b dense mixture, chunk {MOE_ROOMY_CHUNK}", eng,
                  launches, cap, peak, t_d, card)
    del eng
    apart = gate_streams("13b", model, cfg, reqs, dense, routed)
    print(f"  13b: {len(reqs) - apart} of {len(reqs)} dense-mixture streams "
          f"equal the routed ones, {apart} apart at a near-tie", flush=True)


def moe_codes(cfg, model, reqs, ec, card) -> None:
    """13d: codes mode (``act_quant=7, kv_codes=True``), calibrated afresh
    on the card: every request ``ok``, the codes launches exact, and the
    same streams eagerly."""
    import numpy as np
    import torch

    path = os.path.join(ROOT, "build", "chip_smoke_moe_calib.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.unlink(path)
    os.environ["REPRO_ACT_CALIB_CACHE"] = path
    t0 = time.perf_counter()
    outs, eng, launches, cap, peak, t_run = serve_moe_engine(
        "13d codes", cfg, model, reqs, ec, codes=True, act_quant=7)
    require(os.path.exists(path), "13d: calibration wrote no cache entry")
    require(eng.cache.k_pages.dtype == torch.uint8, "13d: pages not uint8")
    print(f"  13d codes (act_quant 7, kv_codes, calibrated on the card; "
          f"{time.perf_counter() - t0:.1f} s with the run):", flush=True)
    print_moe_run(f"13d {cfg.name} codes [graphs]", eng, launches, cap, peak,
                  t_run, card)
    params = eng.params
    del eng
    eager, eng, launches_e, cap_e, peak_e, t_e = serve_moe_engine(
        "13d codes eager", cfg, params, reqs, ec, codes=True,
        graphs=False)
    require(launches_e == launches, f"13d: eager launches {launches_e}")
    require(all(np.array_equal(a.tokens, b.tokens)
                for a, b in zip(outs, eager)),
            "13d: cuda_graphs=False gave other token streams")
    print_moe_run(f"13d {cfg.name} codes [eager, streams equal]", eng,
                  launches_e, cap_e, peak_e, t_e, card)


def moe_path_check(name, cfg, model, n_layers: int) -> None:
    """13c: card against CPU on the first ``n_layers`` layers at full
    width (float32 compute, float32 pages): one 2-row prefill chunk and
    MOE_PATH_STEPS decode steps (phase 3's ``paged_run``), both sides
    decoding the CPU's greedy tokens.  The CPU holds the weights decoded
    to float32 once (the values the kernels' plain versions decode on
    every call; the embedding stays codes, a row gather).

    The routing rule: every router call's choices are compared first
    (:func:`moe_routing`).  At least MOE_ROUTE_SHARE of the router's
    tokens must route the same; a token whose top-k margin clears twice
    the call's largest card-vs-CPU router-probability difference must;
    a row leaves the comparison from the dispatch in which one of its
    tokens routed apart on (and every row does if that dispatch dropped
    slots on either side), and at least one row must stay at every
    dispatch.  The logits of the rows left are held as phase 3 holds
    them: within the tolerance of their scale, greedy tokens equal where
    the top-2 gap is clear.  The tolerance is 1e-4 or, if larger, the
    card's own spread under weight tables jittered by MOE_JITTER (each
    entry scaled by 1 +- 1e-4, the whole of phase 2's gate, which 13k
    holds the GEMMs to at these shapes; #1's difference from float32 on
    layer 0's ``wq`` is held within it here, so the spread is what a
    GEMM at its gate could do, and no factor is added to it).  A
    last-bit change would not do: these random models draw ``wq``/``wk``
    with the fan-in of their heads axis and have no qk-norm, so
    attention scores reach ~1e3 and the softmax turns the GEMMs' ~1e-5
    difference into ~1e-3 of a layer's scale."""
    import numpy as np
    import torch

    from repro_torch.core.exponential_quant import QWeight
    from repro_torch.models import api as mapi
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import DecoderLM

    cfg2 = cfg.replace(num_layers=n_layers, compute_dtype="float32")
    api = mapi.get_model(cfg2)

    def head(v):
        if isinstance(v, QWeight):
            return QWeight(v.codes[:n_layers], v.lut[:n_layers],
                           v.qmeta[:n_layers])
        return v[:n_layers]

    tree = model.tree()
    tree["blocks"] = {k: ({kk: head(vv) for kk, vv in v.items()}
                          if isinstance(v, dict) else head(v))
                      for k, v in tree["blocks"].items()}
    gpu = DecoderLM(cfg2, tree, device="cuda")
    t0 = time.perf_counter()

    def decoded(w: QWeight, experts: bool) -> torch.Tensor:
        """``w`` decoded to float32 on the CPU, a layer (and an expert) a
        table gather on the card at a time."""
        out = torch.empty(w.codes.shape, dtype=torch.float32)
        stacked = w.lut.ndim == 2
        for i in range(w.codes.shape[0] if stacked else 1):
            codes, lut = (w.codes[i], w.lut[i]) if stacked else (w.codes,
                                                                  w.lut)
            dst = out[i] if stacked else out
            for c, d in (zip(codes, dst) if experts else ((codes, dst),)):
                d.copy_(lut[c.long()])
        return out

    def to_cpu(node, path=()):
        if isinstance(node, dict):
            return {k: to_cpu(v, path + (k,)) for k, v in node.items()}
        if not isinstance(node, QWeight):
            return node.cpu()
        if path == ("embed", "tokens"):
            return QWeight(node.codes.cpu(), node.lut.cpu(), node.qmeta.cpu())
        return decoded(node, "moe" in path)

    cpu = DecoderLM(cfg2, to_cpu(tree), device="cpu")
    t_copy = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PATH_LENS]
    router = M._router

    def routed_run(model, dev, feed=None):
        """(logits, layer states, router calls (probs, choices), slots
        dropped a dispatch)."""
        calls, drops = [], []

        def rec(p, xf, c):
            out = router(p, xf, c)
            calls.append((out[0].float().cpu(), out[2].cpu()))
            return out
        M._router = rec
        try:
            outs, states = layer_states(lambda: paged_run(
                api, cfg2, model, dev, torch.float32, prompts, feed,
                steps=MOE_PATH_STEPS, drops=drops))
        finally:
            M._router = router
        return outs, states, calls, drops

    t0 = time.perf_counter()
    on_cpu, cpu_states, cpu_run, cpu_drops = routed_run(
        cpu, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    feed = [o.argmax(-1) for o in on_cpu[:-1]]
    on_card, card_states, card_run, card_drops = routed_run(
        gpu, torch.device("cuda"), feed)
    jitter = gemm_difference(gpu.layer(0)["attn"]["wq"])
    require(jitter <= MOE_JITTER, f"13c {name}: #1 differs from float32 by "
            f"{jitter:.3e} of its output on layer 0's wq > {MOE_JITTER}")
    nudged, _, nudged_run, nudged_drops = routed_run(
        _jittered(gpu, MOE_JITTER), torch.device("cuda"), feed)
    require(len(card_run) == len(cpu_run) == n_layers * (1 + MOE_PATH_STEPS),
            f"13c {name}: {len(card_run)} / {len(cpu_run)} router calls")

    def kept_spread(outs, refs, off_rows):
        require(not any(off.all() for off in off_rows), f"13c {name}: the "
                f"jitter routed every row apart")
        return max((a - r)[~off].abs().max().item()
                   / max(1.0, r[~off].abs().max().item())
                   for a, r, off in zip(outs, refs, off_rows))

    # the card's own spread under jittered weight tables, on the rows whose
    # routing the jitter left alone
    own = moe_routing(f"13c {name} jittered", cfg2, nudged_run, nudged_drops,
                      card_run, card_drops)
    spread = kept_spread(nudged, on_card, own["rows"])
    tol = max(1e-4, spread)
    rt = moe_routing(f"13c {name}", cfg2, card_run, card_drops, cpu_run,
                     cpu_drops, gate=True)
    off_rows = rt["rows"]
    print(f"  13c {name}: {n_layers} layers; routing equal on {rt['same']} "
          f"of {rt['same'] + rt['apart']} router tokens (at least "
          f"{MOE_ROUTE_SHARE:.0%} required), router probabilities apart by "
          f"at most {rt['delta']:.3e} (a clear margin: over twice that "
          f"in its call; {rt['clear']} tokens clear); slots dropped a "
          f"dispatch card {card_drops}, CPU {cpu_drops}; rows left out of "
          f"the logits {[o.nonzero().flatten().tolist() for o in off_rows]}; "
          f"#1's difference from float32 on layer 0's wq {jitter:.3e} of "
          f"its output (at most {MOE_JITTER}); the card's own spread under "
          f"tables jittered by {MOE_JITTER} {spread:.3e}, tol {tol:.3e}; the "
          f"CPU's copy {t_copy:.1f} s, its run {t_cpu:.1f} s", flush=True)
    # each layer's output on the rows kept (the chunk's valid positions),
    # at the prefill chunk and the first decode step
    valid = (torch.arange(PATH_CHUNK)[None, :]
             < torch.tensor(PATH_LENS)[:, None])
    for i, (a, r) in enumerate(zip(card_states[:2 * n_layers],
                                   cpu_states[:2 * n_layers])):
        step, layer = divmod(i, n_layers)
        keep = ~off_rows[step]
        mask = (valid & keep[:, None]) if step == 0 else keep[:, None]
        scale = r[mask].abs().max().item()
        err = (a[mask] - r[mask]).abs().max().item() / scale
        print(f"  13c {name} {'prefill' if step == 0 else 'decode step 0'} "
              f"layer {layer}: card vs CPU {err:.3e} of the layer's scale "
              f"{scale:.3e}", flush=True)
    for step, (a, r, off) in enumerate(zip(on_card, on_cpu, off_rows)):
        compare(f"13c {name} (dispatch {step})", [a[~off]], [r[~off]], tol)
    del gpu, cpu


def moe_routing(label, cfg, calls_a, drops_a, calls_b, drops_b,
                gate: bool = False) -> dict:
    """Side a's router calls against side b's (b the reference), over
    ``paged_run``'s 2 rows, ``cfg.num_layers`` calls a dispatch.  In each
    call, delta is the largest difference between the two sides' router
    probabilities on the rows still compared; a token of those rows whose
    top-k margin on b (the k-th probability over the next) exceeds twice
    delta cannot legitimately route apart.  A row leaves the comparison
    from the dispatch in which one of its tokens routed apart on, and
    every row does if that dispatch dropped slots on either side (a
    changed choice moves which slots a full expert drops).  With
    ``gate``, requires equal choices on every clear token, at least
    MOE_ROUTE_SHARE of the tokens routed the same, and a row compared at
    every dispatch.  Returns the rows left out after each dispatch
    (``rows``) and the counts of tokens routed the same, apart and
    clear, and the largest delta."""
    import torch

    n, k = cfg.num_layers, cfg.experts_per_token
    out = torch.zeros(2, dtype=torch.bool)
    apart = torch.zeros(2, dtype=torch.bool)     # in this dispatch
    rows, same_n, apart_n, clear_n, delta_max = [], 0, 0, 0, 0.0
    for c, ((pa, ea), (pb, eb)) in enumerate(zip(calls_a, calls_b)):
        live = ~out.repeat_interleave(pa.shape[0] // 2)
        same = (torch.sort(ea, -1).values == torch.sort(eb, -1).values
                ).all(-1)
        if live.any():
            delta = (pa - pb)[live].abs().max().item()
            top = torch.sort(pb, -1, descending=True).values
            clear = live & ((top[:, k - 1] - top[:, k]) > 2 * delta)
            bad = int((clear & ~same).sum())
            require(not gate or bad == 0, f"{label}: {bad} tokens with a "
                    f"clear top-k margin routed apart at router call {c}")
            delta_max = max(delta_max, delta)
            clear_n += int(clear.sum())
        same_n += int(same.sum())
        apart_n += int((~same).sum())
        apart |= ~same.reshape(2, -1).all(-1)
        out |= apart
        if c % n == n - 1:
            d = c // n
            if apart.any() and max(drops_a[d], drops_b[d]) > 0:
                out[:] = True
            apart[:] = False
            rows.append(out.clone())
            require(not gate or not out.all(), f"{label}: no row left to "
                    f"compare after dispatch {c // n}")
    share = same_n / max(1, same_n + apart_n)
    require(not gate or share >= MOE_ROUTE_SHARE, f"{label}: routing equal "
            f"on {share:.3f} of the router's tokens < {MOE_ROUTE_SHARE}")
    return {"rows": rows, "same": same_n, "apart": apart_n,
            "clear": clear_n, "delta": delta_max}


# ---------------------- phase 14: the policy's A/B modes and the tuner --

# 14b's settings: the default (fused, the shape plans), tuned plans,
# decode-then-matmul, and the kernels without their epilogues
POLICY_AB = (("auto", {}), ("autotune=True", dict(autotune=True)),
             ("materialize", dict(mode="materialize")),
             ("fuse_epilogues=False", dict(fuse_epilogues=False)))
POLICY_REQUESTS = 8


def tuner_ops():
    return importlib.import_module("repro_torch.kernels.lut_dequant_matmul.ops")


def tuned_vs_shape_plans(card: str) -> None:
    """14a: #1-#4 at phase 2's shapes: each shape's shape plan (the
    default) and tuned plan (``autotune=True``, tuned at its first call)
    with their device times, both held to the plain version at phase 2's
    gate; the sums a kernel; then a second ``Autotuner`` on the same
    file reads every tuned plan back."""
    import torch

    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.lut_dequant_matmul import (
        lut_dequant_matmul, lut_dequant_matmul_dual,
        lut_dequant_matmul_dual_gated, lut_dequant_matmul_gated)
    from repro_torch.kernels.lut_dequant_matmul.ref import (
        lut_dequant_matmul_dual_gated_ref, lut_dequant_matmul_dual_ref,
        lut_dequant_matmul_gated_ref, lut_dequant_matmul_ref)
    from repro_torch.runtime.calibration import ACT_BASES

    ops, lk = tuner_ops(), lut_launch_module()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32, bf, u8 = torch.float32, torch.bfloat16, torch.uint8

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def qweight(k, n):
        codes, p = eq.quantize(rnd(k, n, scale=0.02), 7)
        return codes, eq.decode_table(p), eq.pack_qmeta(p)

    def act_codes(m, k):
        x = rnd(m, k)
        p = eq.fit(x, 7, bases=ACT_BASES)
        return eq.encode(x, p), eq.decode_table(p), eq.pack_qmeta(p)

    def out_table(y):
        return eq.pack_qmeta(eq.fit(y, 7, bases=ACT_BASES))

    sums: dict = {}
    keys = []

    def one(kind, m, k, n, x_dtype, call, plain, qo=None, **extra):
        """``call(autotune)`` runs the wrapper; ``plain()`` the plain
        version."""
        transposed = bool(extra.get("transposed", False))
        nw = 2 if kind in ("gated", "dual_gated") else 1
        label = (f"{kind} M={m} K={k} N={n}" + (" transposed" if transposed
                                                else "")
                 + (" u8 out" if qo is not None else ""))
        shape = lk.gemm_plan(m, k, n, sms, nw, transposed)
        tuned_out = call(True)
        key = ops.plan_key(kind, m, k, n, x_dtype, dev, **extra)
        tuned = ops._TUNER.peek(key) or shape
        ref = plain()
        for name, out in (("tuned", tuned_out), ("shape", call(None))):
            if qo is None:
                require_close(kind, f"14a {label} {name} plan", out, ref)
            else:
                codes_err(out, ref, qo, f"14a {label} {name} plan")
        t_shape = time_ms(lambda: call(None), flush=flush)
        t_tuned = time_ms(lambda: call(True), flush=flush)
        acc = sums.setdefault(kind, [0.0, 0.0])
        acc[0] += t_shape
        acc[1] += t_tuned
        n_cands = len(lk.candidate_plans(m, k, n, sms, nw, transposed))
        if n_cands > 1:
            keys.append(key)
        print(f"  14a {label:40s} shape plan {str(shape):12s} {t_shape:8.4f} "
              f"ms, tuned {str(tuned):12s} {t_tuned:8.4f} ms "
              f"({n_cands} candidates)", flush=True)

    for m in (8, 256, 2048):
        for k, n in ((2048, 2048), (2048, 1024), (6144, 2048)):
            x = rnd(m, k).to(bf)
            c, lut, _ = qweight(k, n)
            one("plain", m, k, n, bf,
                lambda a: lut_dequant_matmul(x, c, lut, out_dtype=f32,
                                             autotune=a),
                lambda: lut_dequant_matmul_ref(x, c, lut))
    m, k, n = 8, 2048, 151936
    x = rnd(m, k).to(bf)
    c, lut, _ = qweight(n, k)
    one("plain", m, k, n, bf,
        lambda a: lut_dequant_matmul(x, c, lut, transpose_codes=True,
                                     out_dtype=f32, autotune=a),
        lambda: lut_dequant_matmul_ref(x, c, lut, transpose_codes=True),
        transposed=True)
    del c
    for m in (8, 256, 2048):
        k, n = 2048, 6144
        x = rnd(m, k).to(bf)
        (cg, lg, _), (cu, lu, _) = qweight(k, n), qweight(k, n)
        one("gated", m, k, n, bf,
            lambda a: lut_dequant_matmul_gated(x, cg, cu, lg, lu,
                                               out_dtype=f32, autotune=a),
            lambda: lut_dequant_matmul_gated_ref(x, cg, cu, lg, lu))
    for m in (8, 256, 2048):
        for k, n in ((2048, 2048), (2048, 1024), (6144, 2048)):
            xc, lx, qx = act_codes(m, k)
            c, lw, qw = qweight(k, n)
            args = (xc, c, lx, lw, qx, qw)
            one("dual", m, k, n, u8,
                lambda a: lut_dequant_matmul_dual(*args, autotune=a),
                lambda: lut_dequant_matmul_dual_ref(*args))
            if (k, n) == (2048, 2048):
                qo = out_table(lut_dequant_matmul_dual_ref(*args))
                one("dual", m, k, n, u8,
                    lambda a: lut_dequant_matmul_dual(*args, out_qmeta=qo,
                                                      autotune=a),
                    lambda: lut_dequant_matmul_dual_ref(*args, out_qmeta=qo),
                    qo=qo, out_quant=True)
    for m in (8, 256, 2048):
        k, n = 2048, 6144
        xc, lx, qx = act_codes(m, k)
        (cg, lg, qg), (cu, lu, qu) = qweight(k, n), qweight(k, n)
        args = (xc, cg, cu, lx, lg, lu, qx, qg, qu)
        qo = out_table(lut_dequant_matmul_dual_gated_ref(*args))
        one("dual_gated", m, k, n, u8,
            lambda a: lut_dequant_matmul_dual_gated(*args, out_qmeta=qo,
                                                    autotune=a),
            lambda: lut_dequant_matmul_dual_gated_ref(*args, out_qmeta=qo),
            qo=qo, out_quant=True)
    del flush
    for kind, (a, b) in sums.items():
        print(f"  14a {kind}: phase 2's shapes summed, shape plans {a:.4f} "
              f"ms, tuned {b:.4f} ms ({b / a:.3f}x) [{card}]", flush=True)
    tuner = ops._TUNER
    again = ops.Autotuner(tuner.path)
    for key in keys:
        plan = tuner.peek(key)
        require(plan is not None and again.peek(key) == plan,
                f"14a: {key}: a second tuner read {again.peek(key)}, the "
                f"first holds {plan}")
    with open(tuner.path) as f:
        entries = json.load(f)["entries"]
    print(f"  14a: a second Autotuner on {os.path.relpath(tuner.path, ROOT)} "
          f"read back all {len(keys)} tuned plans; the file holds "
          f"{len(entries)} plans", flush=True)
    print_tuner("14a")


def print_tuner(label: str) -> None:
    t = tuner_ops()._TUNER
    print(f"  {label}: the autotuner spent {t.seconds:.2f} s in this process "
          f"so far, {t.fallbacks} fallbacks to the shape plan, {t.dropped} "
          f"candidates dropped", flush=True)


def policy_launches(eng, cfg, kw: dict) -> dict:
    """The launches a policy's run must make: the float path's
    attention always; #1 5L + 1 and #2 L times a dispatch when fused,
    #1 7L + 1 (the gated MLP as two dense calls) and no #2 without
    fused epilogues, no LUT GEMM in materialize mode."""
    n = cfg.num_layers
    disp = eng.prefill_batches + eng.total_decode_steps
    want = {"flash_prefill_paged": n * eng.prefill_batches,
            "decode_gqa_paged": n * eng.total_decode_steps}
    if kw.get("mode", "auto") != "materialize":
        fused_ep = kw.get("fuse_epilogues", True)
        want["lut_dequant_matmul"] = ((5 if fused_ep else 7) * n + 1) * disp
        if fused_ep:
            want["lut_dequant_matmul_gated"] = n * disp
    return {k: v for k, v in want.items() if v}


def serve_policies(params, card: str) -> None:
    """14b: phase 4's weights and engine shape (8 slots, block 16, chunk
    256, graphs; the prefix cache off, so the second pass recomputes
    every prompt) serve phase 4's first POLICY_REQUESTS requests, 16 new
    tokens each, under each of POLICY_AB, each on an Engine made and run
    inside its policy: every request ok, the launches exact, the streams
    against the default's where the top-2 gap is clear; then the same
    requests again on that engine (every step replayed) for the decode
    ms a step and the prefill tok/s."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import lama_layers as ll
    from repro_torch.kernels import _build
    from repro_torch.runtime.engine import Engine, EngineConfig

    cfg = get_config(ARCH)
    _, reqs = serving_requests(cfg)
    reqs = [dc.replace(r, max_new_tokens=16) for r in reqs[:POLICY_REQUESTS]]
    ec = EngineConfig(num_slots=8, block_size=16, prefill_chunk=256,
                      max_seq_len=max(len(r.prompt) for r in reqs) + 16,
                      prefix_cache=False)
    first, rows = None, []
    for label, kw in POLICY_AB:
        fresh_peak()
        with ll.policy(**kw):
            eng = Engine(cfg, params=params, engine=ec, device="cuda")
            _build.reset_launch_counts()
            outs = eng.generate(reqs)
            torch.cuda.synchronize()
            counts = _build.launch_counts()
            want = policy_launches(eng, cfg, kw)
            again = [dc.replace(r, uid=r.uid + 1000) for r in reqs]
            outs2, d = engine_deltas(eng, lambda: eng.generate(again))
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_served(outs, reqs, cfg, 16)
        require(counts == want, f"14b {label}: launches {counts}, want {want}")
        require(all(np.array_equal(a.tokens, b.tokens)
                    for a, b in zip(outs, outs2)),
                f"14b {label}: the replayed pass gave other streams")
        graphs, capture_s = eng.graph_captures()
        ms = 1e3 * d.decode_dispatch_s / d.total_decode_steps
        tok_s = d.prefill_tokens_computed / d.prefill_dispatch_s
        apart = (0 if first is None else
                 gate_streams(f"14b {label}", params, cfg, reqs, outs, first))
        first = outs if first is None else first
        rows.append((label, ms, tok_s))
        print(f"  14b {label:21s} launches {counts}; {graphs} graphs in "
              f"{capture_s:.2f} s; replayed: decode {ms:.3f} ms a step "
              f"({d.total_decode_steps} steps), prefill {tok_s:.1f} tok/s "
              f"({d.prefill_tokens_computed} tokens); peak {peak:.2f} GiB; "
              f"{apart} streams apart from the default's at an unclear "
              f"top-2 gap [{card}]", flush=True)
        del eng, outs2
    base_ms, base_tok = rows[0][1], rows[0][2]
    for label, ms, tok_s in rows[1:]:
        print(f"  14b {label}: decode {ms / base_ms:.3f}x the default's ms a "
              f"step, prefill {tok_s / base_tok:.3f}x its tok/s", flush=True)
    print_tuner("14b")


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
    # every run tunes the LUT GEMMs' plans afresh: no cache from an
    # earlier run decides a gate
    tune_cache = os.path.join(ROOT, "build", "chip_smoke_tune.json")
    os.makedirs(os.path.dirname(tune_cache), exist_ok=True)
    if os.path.exists(tune_cache):
        os.unlink(tune_cache)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = tune_cache

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
        codes_params = serve_codes(codes_counts, float_outs, float_pool,
                                   params)
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
        phase("phase 10: the prefix cache and speculative decoding")
        serve_prefix_traffic(params)
        serve_speculative(params, codes_params)
        phase("phase 11: mixed widths, the lifecycle, faults and telemetry")
        lifecycle_phase(params, codes_params, float_outs)
        phase("phase 12: the disaggregated cluster")
        cluster_phase(params, codes_params, float_outs)
        phase("phase 13: the MoE decoders llama4-scout and grok-1")
        for name, layers, check in MOE_DECODERS:
            serve_moe_decoder(name, layers, check, card)
        phase("phase 14: the policy's A/B modes and the LUT GEMMs' autotuner")
        tuned_vs_shape_plans(card)
        serve_policies(params, card)
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
