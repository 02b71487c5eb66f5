"""Serving launcher of the PyTorch port (counterpart of the JAX
package's ``launch/serve.py``, with its flags): continuous-batching
Engine over a paged KV cache, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --tiny --requests 16 --quant 7 --slots 8 --block-size 16

``--device cpu`` runs the plain PyTorch versions on the CPU instead (the
default, ``cuda``, raises without a card); ``--arch`` names one of
``repro_torch.configs``'s architectures.

``--bucketed`` runs the legacy length-bucketed contiguous-cache path
instead (the baseline the engine is measured against).  A family the
Engine does not support (``--arch recurrentgemma-2b``, the hybrid;
``--arch paligemma-3b``, the vlm, each request after 256 stub patch
embeddings; ``--arch rwkv6-3b``; ``--arch seamless-m4t-medium``, the
encdec, each prompt's stub audio frames into its encoder) serves through
``InferenceServer.generate``, which falls back to that path.  As in the
reference, ``--max-len`` sizes the cache without the patches: the
server raises ``ValueError`` when a vlm bucket's patches, prompt and new
tokens do not fit it.  The Engine's flags (``--act-quant``, ``--kv-codes``,
``--spec-k``, ``--chaos``, ``--max-queue`` and the cluster's) then raise
``ValueError``, as the reference's Engine does for such a family.

``--prefill-workers N --decode-workers M`` serves through the
disaggregated cluster instead of one unified engine: N prefill
workers (each with a shard of the consistent-hashed prefix cache)
hand finished prompts' KV pages to M decode workers — greedy decode
over the migrated pages is token-identical to the unified engine,
and the printout adds handoff/router counters (pages moved, bytes,
cross-worker prefix hit rate).

Failure-model knobs: ``--deadline-s`` stamps every request with a
wall-clock budget, ``--max-queue``/``--shed-policy`` bound the waiting
queue, and ``--chaos <seed>`` arms the seeded fault injectors at every
site (ChaosConfig.storm).  Ctrl-C drains gracefully: running slots
finish their tokens, still-queued requests complete with
``status=rejected``, and every submitted request stays accounted for.

Observability: ``--trace PATH`` arms per-request span tracing and
writes a Chrome-trace/Perfetto JSON on exit (load it in
https://ui.perfetto.dev — one track per worker, one row per slot lane,
one row per request, counter tracks for queue depth/free pages/tok-s);
``--metrics-json PATH`` appends a snapshot of the full metrics
registry as one JSONL line.  Both dump on SIGINT too (the partial
trace of an interrupted run is exactly what a hang post-mortem needs),
and the end-of-run stats printout is a render of the same registry the
dumps come from.
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.runtime.cluster import Cluster, ClusterConfig
from repro_torch.runtime.engine import (Engine, EngineConfig, Request, ST_OK,
                                        SHED_POLICIES)
from repro_torch.runtime.server import InferenceServer
from repro_torch.runtime.telemetry import Telemetry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--quant", type=int, default=None,
                    help="DNA-TEQ exponent bits for weights (e.g. 7)")
    ap.add_argument("--act-quant", type=int, default=None,
                    help="DNA-TEQ exponent bits for ACTIVATIONS: fits "
                         "per-(layer, site) params on sample prompts at "
                         "startup (disk-cached) and serves act tensors "
                         "as uint8 codes through the dual-LUT kernel "
                         "(engine path only)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--slots", type=int, default=8,
                    help="concurrent decode slots")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="max prompt tokens one scheduler tick may "
                         "prefill per sequence (chunked flash prefill); "
                         "long prompts interleave with running decodes")
    ap.add_argument("--kv-dtype", default="float32",
                    help='e.g. "float8_e4m3fn" for the narrow-byte cache')
    ap.add_argument("--kv-codes", action="store_true",
                    help="store KV pages as calibrated u8 DNA-TEQ "
                         "exponent codes decoded through per-head LUTs "
                         "inside the attention kernels (requires "
                         "--act-quant; engine and cluster paths)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: max prompt-lookup draft "
                         "tokens verified per decode tick (0 disables; "
                         "greedy acceptance is exact, so served tokens "
                         "are identical either way)")
    ap.add_argument("--bucketed", action="store_true",
                    help="legacy length-bucketed contiguous-cache path")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable radix-tree KV reuse across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of system prompt shared by all requests "
                         "(exercises the prefix cache)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget from submit; "
                         "blown budgets end with status=deadline_exceeded")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound on the waiting queue; overload resolves "
                         "per --shed-policy (engine path only)")
    ap.add_argument("--shed-policy", choices=SHED_POLICIES,
                    default="reject-new",
                    help="overload policy once --max-queue is full")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="arm the seeded chaos injectors at every fault "
                         "site (deterministic per seed; engine path only)")
    ap.add_argument("--prefill-workers", type=int, default=0,
                    help="disaggregated cluster: prompt-only workers "
                         "sharding the prefix cache (0 = unified engine)")
    ap.add_argument("--decode-workers", type=int, default=0,
                    help="disaggregated cluster: decode-only workers "
                         "admitting migrated KV pages (0 = unified engine)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="arm request tracing and write a Chrome-trace/"
                         "Perfetto JSON here on exit or SIGINT "
                         "(engine/cluster paths)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="append a JSONL snapshot of the metrics "
                         "registry here on exit or SIGINT")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the card, the default) or "cpu" (the '
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, tiny=args.tiny)
    device = resolve_device(args.device)
    print("device: " + (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size,
                          args.shared_prefix).astype(np.int32)
    reqs = [
        Request(i, np.concatenate(
            [shared, rng.integers(0, cfg.vocab_size,
                                  args.prompt_len).astype(np.int32)]),
                max_new_tokens=args.new_tokens,
                deadline_s=args.deadline_s)
        for i in range(args.requests)
    ]

    disagg = args.prefill_workers > 0 or args.decode_workers > 0
    if disagg and args.bucketed:
        ap.error("--bucketed and --prefill/--decode-workers are exclusive")
    if args.kv_codes:
        if args.act_quant is None:
            ap.error("--kv-codes requires --act-quant")
        if args.bucketed:
            ap.error("--kv-codes applies to the engine and cluster "
                     "paths only")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    if args.spec_k and args.bucketed:
        ap.error("--spec-k applies to the engine and cluster paths only")
    # a family without the Engine serves through generate's fallback
    fallback = not Engine.supports(cfg) and not args.bucketed
    if fallback:
        engine_only = [flag for flag, on in (
            ("--act-quant", args.act_quant is not None),
            ("--kv-codes", args.kv_codes), ("--spec-k", args.spec_k > 0),
            ("--chaos", args.chaos is not None),
            ("--max-queue", args.max_queue is not None),
            ("--prefill-workers/--decode-workers", disagg)) if on]
        if engine_only:
            raise ValueError(
                f"family {cfg.family!r} has no Engine (it serves through "
                f"generate's bucketed fallback): {', '.join(engine_only)} "
                f"need one")
    bucketed = args.bucketed or fallback
    if bucketed and (args.trace or args.metrics_json):
        print("note: --trace/--metrics-json apply to the engine and "
              "cluster paths only; the bucketed baseline is untraced")

    # one telemetry bundle for the run: the stats printout, the
    # --metrics-json snapshot and the --trace timeline all read it
    tel = Telemetry(tracing=args.trace is not None)

    def dump_telemetry(label: str) -> None:
        if args.trace:
            doc = tel.tracer.export(args.trace)
            print(f"trace: {len(doc['traceEvents'])} events -> "
                  f"{args.trace} (load in ui.perfetto.dev)")
        if args.metrics_json:
            tel.registry.dump_jsonl(args.metrics_json, label=label)
            print(f"metrics: {len(tel.registry.keys())} keys -> "
                  f"{args.metrics_json}")

    if disagg:
        clu = Cluster(
            cfg, quant_bits=args.quant, act_quant=args.act_quant,
            kv_dtype=args.kv_dtype, kv_codes=args.kv_codes,
            chaos=(None if args.chaos is None
                   else ChaosConfig.storm(args.chaos)),
            telemetry=tel, device=device,
            cluster=ClusterConfig(
                prefill_workers=max(args.prefill_workers, 1),
                decode_workers=max(args.decode_workers, 1)),
            engine=EngineConfig(num_slots=args.slots,
                                block_size=args.block_size,
                                max_seq_len=max(args.max_len,
                                                args.shared_prefix
                                                + args.prompt_len
                                                + args.new_tokens),
                                prefix_cache=not args.no_prefix_cache,
                                prefill_chunk=args.prefill_chunk,
                                max_queue=args.max_queue,
                                shed_policy=args.shed_policy,
                                spec_k=args.spec_k))
        t0 = time.time()
        try:
            outs = clu.generate(reqs)
        except KeyboardInterrupt:
            # SIGINT mid-run: the partial trace and metrics are the
            # post-mortem, dumped before propagating
            dump_telemetry("cluster-interrupted")
            raise
        dt = time.time() - t0
        quant_report = clu.quant_report
        cs = clu.stats()
        label = (f"cluster ({clu.cluster_cfg.prefill_workers}P/"
                 f"{clu.cluster_cfg.decode_workers}D, {args.slots} "
                 f"slots/worker, block {args.block_size})")
    elif bucketed:
        if args.act_quant is not None:
            print("note: --act-quant applies to the engine path only; "
                  "the bucketed baseline stays fp-act")
        server = InferenceServer(cfg, quant_bits=args.quant,
                                 max_len=max(args.max_len,
                                             args.shared_prefix
                                             + args.prompt_len
                                             + args.new_tokens),
                                 kv_dtype=args.kv_dtype, device=device)
        t0 = time.time()
        outs = server.generate_bucketed(reqs)
        label = (f"generate (family {cfg.family!r}: the bucketed fallback)"
                 if fallback else "bucketed (legacy contiguous cache)")
        dt = time.time() - t0
        quant_report = server.quant_report
    else:
        eng = Engine(
            cfg, quant_bits=args.quant, act_quant=args.act_quant,
            kv_dtype=args.kv_dtype, kv_codes=args.kv_codes,
            chaos=(None if args.chaos is None
                   else ChaosConfig.storm(args.chaos)),
            telemetry=tel, device=device,
            engine=EngineConfig(num_slots=args.slots,
                                block_size=args.block_size,
                                max_seq_len=max(args.max_len,
                                                args.shared_prefix
                                                + args.prompt_len
                                                + args.new_tokens),
                                prefix_cache=not args.no_prefix_cache,
                                prefill_chunk=args.prefill_chunk,
                                max_queue=args.max_queue,
                                shed_policy=args.shed_policy,
                                spec_k=args.spec_k))
        # graceful SIGINT drain: first ^C stops admitting (queued
        # requests go terminal with status=rejected) while running
        # slots finish; a second ^C raises KeyboardInterrupt as usual
        interrupted = False

        def _sigint(signum, frame):
            nonlocal interrupted
            if interrupted:
                raise KeyboardInterrupt
            interrupted = True
            print("\n^C: draining — running slots finish, queued "
                  "requests rejected (^C again to abort)")

        prev = signal.signal(signal.SIGINT, _sigint)
        t0 = time.time()
        try:
            for r in reqs:
                eng.submit(r)
            drained = False
            while eng.pending:
                if interrupted and not drained:
                    eng.drain_queue()
                    drained = True
                eng.step()
            outs = eng.run()
        except KeyboardInterrupt:
            # hard abort (second ^C): the partial trace and metrics
            # are the post-mortem, dumped before propagating
            dump_telemetry("engine-aborted")
            raise
        finally:
            signal.signal(signal.SIGINT, prev)
        dt = time.time() - t0
        quant_report = eng.quant_report
        label = (f"engine ({args.slots} slots, block {args.block_size}, "
                 f"peak KV {eng.cache.peak_kv_bytes()/1e6:.2f} MB over "
                 f"{eng.total_decode_steps} decode steps)")

    tokens = sum(len(c.tokens) for c in outs)
    print(f"served {len(outs)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s) — {label}")
    # the stats printout is a render of the metrics registry, the store
    # --metrics-json snapshots
    if disagg:
        import statistics as st
        ok = [c for c in outs if c.status == ST_OK] or outs
        print(f"ttft: mean {st.mean(c.ttft_s for c in ok)*1e3:.1f} ms, "
              f"max {max(c.ttft_s for c in ok)*1e3:.1f} ms")
        for prefix in ("cluster.", "router.") + (
                ("chaos.",) if args.chaos is not None else ()):
            print(tel.registry.render(prefix))
        clu.check_partition()
    if not bucketed and not disagg:
        import statistics as st
        by_status: dict[str, int] = {}
        for c in outs:
            by_status[c.status] = by_status.get(c.status, 0) + 1
        if set(by_status) != {ST_OK}:
            print("statuses: " + ", ".join(
                f"{k}={v}" for k, v in sorted(by_status.items())))
        ok = [c for c in outs if c.status == ST_OK] or outs
        print(f"ttft: mean {st.mean(c.ttft_s for c in ok)*1e3:.1f} ms, "
              f"max {max(c.ttft_s for c in ok)*1e3:.1f} ms; queue wait "
              f"mean {st.mean(c.queue_wait_s for c in ok)*1e3:.1f} ms")
        print(tel.registry.render("engine."))
        if args.chaos is not None:
            print(tel.registry.render("chaos."))
            if eng.replay_artifacts:
                print(f"replay artifacts: {len(eng.replay_artifacts)}")
    if disagg and clu.act_report is not None:
        import statistics as st
        # per-head KV sites nest their SQNR lists: flatten them
        sq = [float(s) for v in clu.act_report.values()
              for s in np.asarray(v).ravel()]
        print(f"act-quant: {len(sq)} (layer, site) tensors calibrated, "
              f"mean SQNR {st.mean(sq):.1f} dB "
              f"(sites: {', '.join(sorted(clu.act_report))})")
    if not bucketed and not disagg and eng.act_report is not None:
        import statistics as st
        sq = [float(s) for v in eng.act_report.values()
              for s in np.asarray(v).ravel()]
        print(f"act-quant: {len(sq)} (layer, site) tensors calibrated, "
              f"mean SQNR {st.mean(sq):.1f} dB "
              f"(sites: {', '.join(sorted(eng.act_report))})")
    if quant_report:
        import statistics as st
        bits = [b for b, _ in quant_report.values()]
        sqnr = [s for _, s in quant_report.values()]
        print(f"quantized {len(bits)} tensors, avg bits {st.mean(bits):.2f}, "
              f"avg SQNR {st.mean(sqnr):.1f} dB")
    if not bucketed:
        dump_telemetry(label)


if __name__ == "__main__":
    main()
