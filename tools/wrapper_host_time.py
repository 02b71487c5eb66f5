#!/usr/bin/env python3
"""Host time of the paged attention wrappers on one CUDA card.

    PYTHONPATH=src python3 tools/wrapper_host_time.py [--rounds 50]

Times on the host's clock a step's worth of wrapper calls (28, one per
layer of qwen3-1.7b) of ``decode_gqa_paged`` (#7) and
``decode_gqa_paged_codes`` (#8) at ``chip_smoke.py``'s serving decode
shape (8 rows, 8 KV heads x 2 query heads, head_dim 128, 64 pages of
16, lengths <= 732), and of ``flash_prefill_paged`` (#5) and
``flash_prefill_paged_codes`` (#6) at its serving chunk (8 rows of 256
queries over the same pages), enqueued while the stream sleeps: the
timer reads what a call costs the host (argument checks, workspace, the
CUDA calls that enqueue its kernels), not the device's work.  Prints
the card's name and power limit, then per wrapper the median over the
rounds in microseconds a call, as one JSON line.  It runs the
``repro_torch`` found on PYTHONPATH, so two trees compare on one card
in one run:

    PYTHONPATH=parent/src python3 tools/wrapper_host_time.py
    PYTHONPATH=src python3 tools/wrapper_host_time.py
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

CALLS = 28          # paged attention calls in one step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import exponential_quant as eq
    from repro_torch.kernels.decode_gqa.ops import (decode_gqa_paged,
                                                   decode_gqa_paged_codes)
    from repro_torch.kernels.flash_prefill.ops import (
        flash_prefill_paged, flash_prefill_paged_codes)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, n_kv, g, hd, bs, width = 8, 8, 2, 128, 16, 64
    n = 1 + b * width
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: b * width]
             + 1).to(torch.int32).reshape(b, width).contiguous()
    lengths = torch.tensor([17, 732, 400, 0, 256, 33, 600, 129],
                           dtype=torch.int32, device=dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = rnd(b, n_kv, g, hd).to(torch.bfloat16)
    kp, vp = rnd(n, bs, n_kv, hd), rnd(n, bs, n_kv, hd)
    fit = eq.fit(rnd(1 << 14), 7)
    lut, qmeta = eq.decode_table(fit), eq.pack_qmeta(fit)
    heads = lut.expand(n_kv, 256).contiguous()

    def codes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    qc, kc, vc = (codes(b, n_kv, g, hd), codes(n, bs, n_kv, hd),
                  codes(n, bs, n_kv, hd))
    s = 256                                    # the serving chunk
    qp = rnd(b, s, n_kv, g, hd).to(torch.bfloat16)
    qpc = codes(b, s, n_kv, g, hd)
    q_start = (lengths - s).clamp_min(0)
    calls = {
        "decode_gqa_paged": lambda: decode_gqa_paged(q, kp, vp, table,
                                                     lengths),
        "decode_gqa_paged_codes": lambda: decode_gqa_paged_codes(
            qc, kc, vc, lut, heads, heads, qmeta, table, lengths),
        "flash_prefill_paged": lambda: flash_prefill_paged(
            qp, kp, vp, table, q_start, lengths),
        "flash_prefill_paged_codes": lambda: flash_prefill_paged_codes(
            qpc, kc, vc, lut, heads, heads, qmeta, table, q_start, lengths),
    }
    out = {}
    for name, fn in calls.items():
        fn()                                   # build, load, warm up
        torch.cuda.synchronize()
        per_call = []
        for _ in range(args.rounds):
            torch.cuda._sleep(20_000_000)       # keep the device busy
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            per_call.append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
        out[name] = {"host_us_per_call": statistics.median(per_call),
                     "min_us": min(per_call), "max_us": max(per_call)}
    print(json.dumps({"calls_per_round": CALLS, "rounds": args.rounds,
                      "wrappers": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
