#!/usr/bin/env python3
"""Device time of the five attention kernels on one CUDA card.

    PYTHONPATH=src python3 tools/attn_time.py [--iters 10]

Times ``flash_prefill_paged`` (#5), ``flash_prefill_paged_codes`` (#6),
``decode_gqa_paged`` (#7), ``decode_gqa_paged_codes`` (#8) and the
contiguous ``decode_gqa`` (#9) at ``chip_smoke.py``'s phase-2 shapes of
qwen3-1.7b (8 KV heads, g 2, head_dim 128, pages of 16): prefill at the
serving chunk (8 rows x 256 queries over 64 pages), a short chunk (8 x
16) and a long context (one 256-query chunk at 3840 of 4096 positions);
paged decode at the serving rows (lengths <= 732 over 64 pages), short
rows (<= 64 over 8 pages) and 8 rows at 4096 positions; #9 at the
serving rows over a 768-position float32 and bfloat16 cache.  bf16 q,
float32 pages (codes: uint8 under fitted tables).  Each call runs between
CUDA events after the stream slept while the host enqueued it, a 64 MiB
buffer overwritten first so the pages come from device memory.  Prints
the card's name and power limit, then one JSON line: mean ms a call per
kernel and shape, and each kernel's sum over its shapes.  It runs the
``repro_torch`` found on PYTHONPATH (and builds that tree's kernels), so
two trees compare on one card, one after the other:

    PYTHONPATH=parent/src python3 tools/attn_time.py
    PYTHONPATH=src python3 tools/attn_time.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

B, N_KV, G, HD, BS = 8, 8, 2, 128, 16
SERVING = [17, 732, 400, 0, 256, 33, 600, 129]


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
    from repro_torch.kernels.decode_gqa import (decode_gqa, decode_gqa_paged,
                                                decode_gqa_paged_codes)
    from repro_torch.kernels.flash_prefill import (flash_prefill_paged,
                                                   flash_prefill_paged_codes)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def codes(x, stacked=False):
        """x as codes under its own fit (per KV head when stacked):
        (codes, table)."""
        if stacked:
            fit = eq.fit(x.permute(2, 0, 1, 3).reshape(x.shape[2], -1), 7,
                         stacked=True)
            return (eq.encode_meta(x, eq.pack_qmeta(fit)[:, None, :]),
                    eq.decode_table(fit))
        fit = eq.fit(x, 7)
        return eq.encode(x, fit), eq.decode_table(fit)

    out = {}

    def run(name, label, fn):
        out[f"{name} {label}"] = time_ms(fn, args.iters, flush)
        out[f"{name} sum"] = out.get(f"{name} sum", 0.0) + out[f"{name} {label}"]

    n_pages = 1 + B * 4096 // BS
    kp, vp = rnd(n_pages, BS, N_KV, HD), rnd(n_pages, BS, N_KV, HD)
    (kc, kl), (vc, vl) = codes(kp, True), codes(vp, True)
    oq = eq.pack_qmeta(eq.fit(rnd(1 << 16) * 0.5, 7))
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).to(torch.int32)

    def table(rows, width):
        return perm[: rows * width].reshape(rows, width).contiguous()

    starts = torch.tensor([0, 256, 512, 768, 128, 384, 0, 300], **i32)
    for label, s, valid, q_start, bt in (
            ("8 rows x 256 queries, 64 pages", 256,
             [256, 256, 256, 200, 256, 17, 256, 0], starts, table(8, 64)),
            ("8 rows x 16 queries, 64 pages", 16,
             [16, 16, 16, 16, 16, 9, 16, 0], starts, table(8, 64)),
            ("1 row x 256 queries at 3840", 256, [256],
             torch.tensor([3840], **i32), table(1, 4096 // BS))):
        valid = torch.tensor(valid, **i32)
        kv_lens = torch.where(valid > 0, q_start + valid, 0).to(torch.int32)
        q = rnd(len(valid), s, N_KV, G, HD, dtype=torch.bfloat16)
        run("#5", label, lambda: flash_prefill_paged(q, kp, vp, bt, q_start,
                                                     kv_lens))
        qc, ql = codes(rnd(len(valid), s, N_KV, G, HD))
        run("#6", label, lambda: flash_prefill_paged_codes(
            qc, kc, vc, ql, kl, vl, oq, bt, q_start, kv_lens))

    for label, width, lengths in (
            ("8 rows, lengths <= 732, 64 pages", 64, SERVING),
            ("8 rows, lengths <= 64, 8 pages", 8, [1, 17, 64, 0, 33, 48, 5, 64]),
            ("8 rows at 4096, 256 pages", 256, [4096] * 8)):
        bt, lens = table(B, width), torch.tensor(lengths, **i32)
        q = rnd(B, N_KV, G, HD, dtype=torch.bfloat16)
        run("#7", label, lambda: decode_gqa_paged(q, kp, vp, bt, lens))
        qc, ql = codes(rnd(B, N_KV, G, HD))
        run("#8", label, lambda: decode_gqa_paged_codes(
            qc, kc, vc, ql, kl, vl, oq, bt, lens))
    del kp, vp, kc, vc

    lens = torch.tensor(SERVING, **i32)
    q = rnd(B, N_KV, G, HD, dtype=torch.bfloat16)
    for cdt in (torch.float32, torch.bfloat16):
        k, v = rnd(B, 768, N_KV, HD, dtype=cdt), rnd(B, 768, N_KV, HD, dtype=cdt)
        run("#9", f"B=8 S=768 lengths<=732 {str(cdt)[6:]}",
            lambda: decode_gqa(q, k, v, lens))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
