#!/usr/bin/env python3
"""Device time of the four LUT-dequant GEMMs on one CUDA card.

    PYTHONPATH=src python3 tools/gemm_time.py [--iters 10]

Times ``lut_dequant_matmul`` (#1), ``..._gated`` (#2), ``..._dual`` (#3)
and ``..._dual_gated`` (#4) at ``chip_smoke.py``'s phase-2 shapes of
qwen3-1.7b (M = 8, 256 and 2048; bf16 x, and #1 once with float32 x;
#3/#4 on activation codes, #4 with u8 out), each
call between CUDA events after the stream slept while the host enqueued
it, a 64 MiB buffer overwritten first so the codes come from device
memory.  Prints the card's name and power limit, then one JSON line:
mean ms a call per kernel and shape.  It runs the ``repro_torch`` found
on PYTHONPATH (and builds that tree's kernels), so two trees compare in
one session on one card:

    PYTHONPATH=parent/src python3 tools/gemm_time.py
    PYTHONPATH=src python3 tools/gemm_time.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

K, N_FF = 2048, 6144        # d_model and d_ff of qwen3-1.7b
DENSE = ((2048, 2048), (2048, 1024), (6144, 2048))


def time_ms(fn, iters: int, flush) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.lut_dequant_matmul import (
        lut_dequant_matmul, lut_dequant_matmul_dual,
        lut_dequant_matmul_dual_gated, lut_dequant_matmul_gated)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    f32 = torch.float32

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def weight(k, n):
        codes, p = eq.quantize(rnd(k, n, scale=0.02), 7)
        return codes, eq.decode_table(p), eq.pack_qmeta(p)

    def act(m, k):
        x = rnd(m, k)
        p = eq.fit(x, 7)
        return eq.encode(x, p), eq.decode_table(p), eq.pack_qmeta(p)

    out = {}

    def run(name, label, fn):
        out[f"{name} {label}"] = time_ms(fn, args.iters, flush)

    for m in (8, 256, 2048):
        x = rnd(m, 6144).to(torch.bfloat16)
        xcs = act(m, 6144)
        for k, n in DENSE:
            c, lut, qm = weight(k, n)
            xk = x[:, :k].contiguous()
            run("#1", f"M={m} K={k} N={n}",
                lambda: lut_dequant_matmul(xk, c, lut, out_dtype=f32))
            xc = xcs[0][:, :k].contiguous()
            run("#3", f"M={m} K={k} N={n}",
                lambda: lut_dequant_matmul_dual(xc, c, xcs[1], lut, xcs[2], qm))
        c, lut, qm = weight(2048, 2048)
        xc = xcs[0][:, :2048].contiguous()
        run("#3", f"M={m} K=2048 N=2048 u8 out",
            lambda: lut_dequant_matmul_dual(xc, c, xcs[1], lut, xcs[2], qm,
                                            out_qmeta=xcs[2]))
        # float32 x: three TF32 passes on the one-weight prefill body,
        # beside #3's three bf16 passes on the same shape
        xf = x[:, :2048].float()
        run("#1", f"M={m} K=2048 N=2048 f32 x",
            lambda: lut_dequant_matmul(xf, c, lut, out_dtype=f32))
    c, lut, _ = weight(151936, K)
    x8 = rnd(8, K).to(torch.bfloat16)
    run("#1", f"M=8 K={K} N=151936 transposed",
        lambda: lut_dequant_matmul(x8, c, lut, transpose_codes=True,
                                   out_dtype=f32))
    del c
    (cg, lg, qg), (cu, lu, qu) = weight(K, N_FF), weight(K, N_FF)
    for m in (8, 256, 2048):
        x = rnd(m, K).to(torch.bfloat16)
        run("#2", f"M={m} K={K} N={N_FF}",
            lambda: lut_dequant_matmul_gated(x, cg, cu, lg, lu, out_dtype=f32))
        xc, lx, qx = act(m, K)
        run("#4", f"M={m} K={K} N={N_FF} u8 out",
            lambda: lut_dequant_matmul_dual_gated(
                xc, cg, cu, lx, lg, lu, qx, qg, qu, out_qmeta=qx))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
