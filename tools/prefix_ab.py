#!/usr/bin/env python3
"""Serving with the prefix cache on against off, on one CUDA card.

    PYTHONPATH=src python3 tools/prefix_ab.py [--pairs 3]

Full-width qwen3-1.7b, random weights (seed 0) quantized to 7 bits on
the card, serves requests of ``chip_smoke.py``'s phase-4 shapes (12
prompts of its lengths, 17..700, 32 new tokens each; fresh random
tokens each run, so that no run shares a prefix with an earlier one)
through an Engine of 8 slots, block 16, chunk 256, with CUDA graphs,
on float32 pages and on float8_e4m3fn pages, with ``prefix_cache`` on
and off.
Each (pages, prefix cache) engine serves the requests once to capture
its steps, then the pairs alternate which side runs first; a run's ms a
decode step and its prefill tok/s are taken inside its dispatches.
Prints the card's name and power limit, then one JSON line: per pages
and side, the runs' ms a step and prefill tok/s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefix_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
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
        return [Request(i, rng.integers(0, cfg.vocab_size, int(n))
                        .astype(np.int32), max_new_tokens=32)
                for i, n in enumerate(lens)]

    out = {}
    for pages in ("float32", "float8_e4m3fn"):
        engines = {}
        for on in (True, False):
            eng = Engine(cfg, params=params, device="cuda", kv_dtype=pages,
                         engine=EngineConfig(num_slots=8, block_size=16,
                                             prefill_chunk=256,
                                             max_seq_len=768, prefix_cache=on))
            eng.generate(fresh())               # capture every step
            engines[on] = eng
        runs = {True: [], False: []}
        for pair in range(args.pairs):
            for on in ((True, False) if pair % 2 == 0 else (False, True)):
                eng = engines[on]
                names = ("total_decode_steps", "decode_dispatch_s",
                         "prefill_tokens_computed", "prefill_dispatch_s")
                before = [getattr(eng, k) for k in names]
                eng.generate(fresh())
                steps, dec_s, toks, pre_s = (
                    getattr(eng, k) - b for k, b in zip(names, before))
                runs[on].append((round(1e3 * dec_s / steps, 3),
                                 round(toks / pre_s, 1)))
        out[pages] = {f"prefix_cache_{'on' if on else 'off'}": runs[on]
                      for on in (True, False)}
        del engines
        torch.cuda.empty_cache()
    print(json.dumps({"ms_a_step_and_prefill_tok_s": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
