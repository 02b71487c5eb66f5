#!/usr/bin/env python3
"""Wall time of a scheduler tick on one CUDA card, for an A/B of two trees.

    PYTHONPATH=src python3 tools/tick_ab.py [--runs 4]

Full-width qwen3-1.7b, random weights (seed 0) quantized to 7 bits on
the card, serves requests of ``chip_smoke.py``'s phase-4 shapes (12
prompts of its lengths, 17..700, 32 new tokens each; fresh random tokens
each run, so that no run hits the prefix cache) through an Engine of 8
slots, block 16, chunk 256, with CUDA graphs.  One run captures every
step; in each later run every step replays.  A run's numbers: ms a
decode step inside the decode dispatches, and the wall ms of each
``Engine.step()`` call (all of a tick: admission, the lifecycle's
per-tick work, the dispatches, telemetry), their median and mean.

It runs whichever ``repro_torch`` is on PYTHONPATH, so an older tree
unpacked under ``build/`` compares with this one in one chip call (run
parent, change, change, parent).  Where the Engine takes ``telemetry``,
the runs alternate tracing off and on.  Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tick_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.runtime import engine as E
    from repro_torch.runtime.server import InferenceServer

    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}",
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = get_config("qwen3-1.7b")
    params = InferenceServer(cfg, quant_bits=7, device="cuda",
                             rng_seed=0).params
    # chip_smoke.py's phase-4 prompt lengths (not imported from it: it
    # puts its own checkout's src first on sys.path)
    lens = np.random.default_rng(0).integers(17, 701, 12)
    draws = iter(range(1, 1 << 20))

    def fresh():
        rng = np.random.default_rng(next(draws))
        return [E.Request(i, rng.integers(0, cfg.vocab_size, int(n))
                          .astype(np.int32), max_new_tokens=32)
                for i, n in enumerate(lens)]

    tracing = "telemetry" in inspect.signature(E.Engine).parameters
    kw = {}
    if tracing:
        from repro_torch.runtime.telemetry import Telemetry
        kw["telemetry"] = Telemetry(tracing=False)
    eng = E.Engine(cfg, params=params, device="cuda",
                   engine=E.EngineConfig(num_slots=8, block_size=16,
                                         prefill_chunk=256, max_seq_len=768),
                   **kw)
    eng.generate(fresh())                       # capture every step
    runs = []
    for k in range(args.runs):
        traced = tracing and k % 2 == 1
        if tracing:
            eng.tracer.enabled = traced
        steps0, dec0 = eng.total_decode_steps, eng.decode_dispatch_s
        for r in fresh():
            eng.submit(r)
        walls = []
        while eng.pending:
            t0 = time.perf_counter()
            eng.step()
            walls.append(time.perf_counter() - t0)
        eng.collect()
        runs.append({
            "traced": traced,
            "decode_ms_a_step": round(
                1e3 * (eng.decode_dispatch_s - dec0)
                / (eng.total_decode_steps - steps0), 4),
            "ticks": len(walls),
            "tick_ms_median": round(1e3 * statistics.median(walls), 4),
            "tick_ms_mean": round(1e3 * statistics.fmean(walls), 4)})
    print(json.dumps({"tick_ab": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
