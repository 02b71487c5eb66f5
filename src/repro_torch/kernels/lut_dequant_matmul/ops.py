"""Public wrappers of the fused LUT-dequant matmuls, and their autotuner.

A CPU tensor goes to the plain PyTorch version (``ref.py``); a CUDA
tensor goes to the hand-written kernel (``lut_dequant_matmul.py``), or
the call raises.  Outputs are float32 inside, cast to ``out_dtype``
(default: x's dtype; float32 for the dual variants, whose x is codes) as
the reference's wrapper does.  The dual variants return uint8 codes when
given ``out_qmeta`` (the quantize epilogue).

**Autotuning** (the counterpart of the reference's tile autotuner).  A
launch on the card takes a plan, ``(splits, k_per_split)``: all the
bodies take at launch time (tile, pipeline stage and stage count are
compile-time).  By default (``autotune`` None or False) it is the shape
plan, ``gemm_plan``: the same for every run and every card of a kind.
With ``autotune=True`` the first call at a key times the candidate plans
(``candidate_plans``, the shape plan first) on the call's own operands,
keeps those whose output agrees with the shape plan's at the kernels'
gate, and launches the fastest, if it beats the shape plan by more than
``MARGIN``; the choice is kept in memory and in a JSON file
(:class:`Autotuner`).  Under a CUDA graph capture the tuner only reads
what it has.  Tuning is asked for, never a default: a plan is tuned a
power-of-two M bucket and chosen by timing, so the same rows computed at
another M, or in another run, may be summed in another order and round
differently.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import sys
import time

import torch

from repro_torch.core.exponential_quant import codes_agree
from repro_torch.kernels import _build
from repro_torch.kernels.lut_dequant_matmul import lut_dequant_matmul as _k
from repro_torch.kernels.lut_dequant_matmul.ref import (
    lut_dequant_matmul_dual_gated_ref,
    lut_dequant_matmul_dual_ref,
    lut_dequant_matmul_gated_ref,
    lut_dequant_matmul_ref,
)

TUNE_VERSION = 1
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
# a candidate replaces the shape plan only when it is this much faster:
# closer plans would flip from run to run with the timing noise
MARGIN = 0.03
TIMED_RUNS = 5
# the stream sleeps this many cycles (~0.5 ms) before each timed launch,
# so the events time the device's work and not the wrapper's host time
_SLEEP_CYCLES = 1_000_000
ACT_CODE_REP = "u8code"


def default_cache_path() -> str:
    """``$REPRO_TORCH_AUTOTUNE_CACHE``, else a file under ``~/.cache``.
    Not the reference's ``REPRO_AUTOTUNE_CACHE``: the reference rewrites
    that whole file under its own version."""
    return os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch",
        "lut_dequant_matmul_tune.json")


def m_bucket(m: int) -> int:
    """M's autotuner bucket: 8 for the decode body's M <= 8, else the
    next power of two."""
    return 8 if m <= 8 else 1 << (m - 1).bit_length()


def xrep(x_dtype) -> str:
    """The activation operand's representation, as a key token."""
    return ACT_CODE_REP if x_dtype == torch.uint8 else str(x_dtype)[6:]


def tune_key(device: str, sms: int, kind: str, m: int, k: int, n: int,
             decode_mode: str, rep: str, extra: str) -> str:
    return "|".join([device, str(sms), kind, str(m_bucket(m)), str(k),
                     str(n), decode_mode, rep, extra])


class Autotuner:
    """Persistent plan choices of the four LUT GEMMs.

    Disk format (JSON)::

        {"version": 1,
         "entries":
            {"<device>|<sms>|<kind>|<m bucket>|<k>|<n>|<decode_mode>|<xrep>|<extra>":
             {"plan": [splits, k_per_split], "us": 123.4}}}

    Only a plan that agreed with the shape plan's output is kept.
    ``seconds`` sums the time spent tuning; ``fallbacks`` counts the keys
    where no candidate ran (the shape plan then runs and nothing is
    kept); ``dropped`` the candidates that raised or disagreed."""

    def __init__(self, path: str | None = None):
        self._path = path
        self._mem: dict[str, tuple[int, int]] = {}
        self._disk_loaded = False
        self.seconds = 0.0
        self.fallbacks = 0
        self.dropped = 0

    @property
    def path(self) -> str:
        if self._path is None:
            self._path = default_cache_path()
        return self._path

    # -- persistence ---------------------------------------------------
    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(blob, dict) or blob.get("version") != TUNE_VERSION:
            return {}
        entries = blob.get("entries")
        return entries if isinstance(entries, dict) else {}

    def _load_disk(self) -> None:
        if self._disk_loaded:
            return
        self._disk_loaded = True
        for key, ent in self._read().items():
            try:
                self._mem.setdefault(key, tuple(int(v) for v in ent["plan"]))
            except (KeyError, TypeError, ValueError):
                continue

    def _save_disk(self, key: str, plan, us: float) -> None:
        """Add one entry to the file (written to a temporary file, then
        renamed over it)."""
        entries = self._read()
        entries[key] = {"plan": list(plan), "us": round(us, 2)}
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": TUNE_VERSION, "entries": entries}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # -- selection -----------------------------------------------------
    def peek(self, key: str) -> tuple[int, int] | None:
        """The kept plan (memory, then disk), or None; never times and
        never writes.  What a call under a graph capture gets."""
        if key not in self._mem:
            self._load_disk()
        return self._mem.get(key)

    def get(self, key: str, candidates, bench, agree) -> tuple[int, int]:
        """The plan for ``key``: kept, or tuned now.  ``bench(plan) ->
        (seconds, output)`` runs a candidate; ``agree(output,
        reference)`` holds it to candidate 0's output (the shape plan).
        A candidate that raises or disagrees is dropped; if candidate 0
        itself raises, nothing validates: candidate 0 is returned (its
        launch will raise again) and nothing is kept."""
        cached = self.peek(key)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        try:
            return self._tune(key, list(candidates), bench, agree)
        finally:
            self.seconds += time.perf_counter() - t0

    def _tune(self, key, candidates, bench, agree):
        timed, ref = [], None
        for i, plan in enumerate(candidates):
            try:
                t, out = bench(plan)
                ok = i == 0 or bool(agree(out, ref))
            except (RuntimeError, ValueError) as e:
                self.dropped += 1
                print(f"autotune {key}: plan {plan} failed: {e}",
                      file=sys.stderr)
                if i == 0:
                    break
                continue
            if i == 0:
                ref = out
            if not ok:
                self.dropped += 1
                print(f"autotune {key}: plan {plan} disagrees with the shape "
                      f"plan's output; dropped", file=sys.stderr)
                continue
            timed.append((t, plan))
        if not timed:
            self.fallbacks += 1
            print(f"autotune {key}: no candidate validated; the shape plan "
                  f"{candidates[0]} runs and nothing is kept",
                  file=sys.stderr)
            return candidates[0]
        t_shape = timed[0][0]
        t, plan = min(timed, key=lambda tp: tp[0])
        if t > (1.0 - MARGIN) * t_shape:
            t, plan = timed[0]
        self._mem[key] = plan
        self._save_disk(key, plan, t * 1e6)
        return plan


_TUNER = Autotuner()


@functools.lru_cache(maxsize=None)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def _key(kind, m, k, n, x_dtype, dev, decode_mode, extra) -> str:
    return tune_key(_device_name(dev.index or 0), _k.num_sms(dev), kind, m,
                    k, n, decode_mode, xrep(x_dtype), extra)


def _bench(run, plan):
    """(median seconds of TIMED_RUNS launches after a warm one, the warm
    launch's output).  CUDA events on the current stream; the launches
    are not counted (they go to a discarded record)."""
    with _build.recording_launches():
        out = run(plan)
        stream = torch.cuda.current_stream()
        events = []
        for _ in range(TIMED_RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SLEEP_CYCLES)
            a.record(stream)
            run(plan)
            b.record(stream)
            events.append((a, b))
        events[-1][1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events) / 1e3, out


def floats_agree(out, ref) -> bool:
    """The float kernels' gate: within 1e-4 of the largest magnitude."""
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    return (out - ref).abs().max().item() <= tol


def codes_within_gate(out, ref, qmeta) -> bool:
    """The uint8 gate: codes one rounding step apart at most under the
    out table, and at most 1e-3 of them differing."""
    return (bool(codes_agree(out, ref, qmeta).all())
            and int((out != ref).sum()) <= 1e-3 * ref.numel())


def _plan_for(kind, x, m, k, n, nw, transposed, decode_mode, extra,
              autotune, run, agree):
    """The plan a call launches: the shape plan unless ``autotune`` is
    True; then the tuner's kept plan, or one tuned now (under a capture:
    the kept plan, else the shape plan)."""
    dev = x.device
    sms = _k.num_sms(dev)
    if not autotune:
        return _k.gemm_plan(m, k, n, sms, nw, transposed)
    cands = _k.candidate_plans(m, k, n, sms, nw, transposed)
    if len(cands) == 1:
        return cands[0]
    key = _key(kind, m, k, n, x.dtype, dev, decode_mode, extra)
    if torch.cuda.is_current_stream_capturing():
        return _TUNER.peek(key) or cands[0]
    return _TUNER.get(key, cands, lambda p: _bench(run, p), agree)


def key_extra(kind: str, *, epilogue=None, bias=False, transposed=False,
              activation="silu", out_quant=False) -> str:
    """The key's last field: what besides the shapes selects the body."""
    if kind == "plain":
        return f"{epilogue}|{int(bias)}|{int(transposed)}"
    if kind == "gated":
        return str(activation)
    if kind == "dual":
        return f"{epilogue}|{int(bias)}|{int(out_quant)}"
    return f"{activation}|{int(out_quant)}"


def plan_key(kind: str, m: int, k: int, n: int, x_dtype, device, *,
             decode_mode: str = "gather", **extra) -> str:
    """The autotuner's key of a call of ``kind`` (``plain``, ``gated``,
    ``dual``, ``dual_gated``) with these shapes on ``device``;
    ``extra`` as :func:`key_extra` takes it."""
    return _key(kind, m, k, n, x_dtype, torch.device(device), decode_mode,
                key_extra(kind, **extra))


def lut_dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                       lut: torch.Tensor, qmeta: torch.Tensor | None = None,
                       *, decode_mode: str = "gather",
                       epilogue: str | None = None, bias=None,
                       transpose_codes: bool = False,
                       out_dtype=None, autotune: bool | None = None
                       ) -> torch.Tensor:
    """``act(x[M, K] @ dec(codes) + bias)``; codes ``[K, N]`` uint8, or
    ``[N, K]`` with ``transpose_codes=True`` (a tied embedding table)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return lut_dequant_matmul_ref(
            x, codes, lut, qmeta, out_dtype=out_dtype, epilogue=epilogue,
            bias=bias, transpose_codes=transpose_codes,
            decode_mode=decode_mode)
    run = functools.partial(_k.launch, x, codes, lut, qmeta, bias,
                            transpose_codes=transpose_codes,
                            decode_mode=decode_mode, epilogue=epilogue)
    m, k = x.shape[0], x.shape[-1]
    n = codes.shape[0] if transpose_codes else codes.shape[-1]
    plan = _plan_for("plain", x, m, k, n, 1, transpose_codes, decode_mode,
                     key_extra("plain", epilogue=epilogue,
                               bias=bias is not None,
                               transposed=transpose_codes),
                     autotune, lambda p: run(plan=p), floats_agree)
    return run(plan=plan).to(out_dtype)


def lut_dequant_matmul_gated(x: torch.Tensor, codes_g: torch.Tensor,
                             codes_u: torch.Tensor, lut_g: torch.Tensor,
                             lut_u: torch.Tensor, qmeta_g=None, qmeta_u=None,
                             *, activation: str = "silu",
                             decode_mode: str = "gather",
                             out_dtype=None, autotune: bool | None = None
                             ) -> torch.Tensor:
    """``act(x @ dec(codes_g)) * (x @ dec(codes_u))`` with one shared x:
    the gated-MLP front half in one kernel."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return lut_dequant_matmul_gated_ref(
            x, codes_g, codes_u, lut_g, lut_u, qmeta_g, qmeta_u,
            activation=activation, out_dtype=out_dtype,
            decode_mode=decode_mode)
    run = functools.partial(_k.launch_gated, x, codes_g, codes_u, lut_g,
                            lut_u, qmeta_g, qmeta_u, decode_mode=decode_mode,
                            activation=activation)
    m, k, n = x.shape[0], x.shape[-1], codes_g.shape[-1]
    plan = _plan_for("gated", x, m, k, n, 2, False, decode_mode,
                     key_extra("gated", activation=activation), autotune,
                     lambda p: run(plan=p), floats_agree)
    return run(plan=plan).to(out_dtype)


def _out_agree(out_qmeta):
    if out_qmeta is None:
        return floats_agree
    return lambda out, ref: codes_within_gate(out, ref, out_qmeta)


def lut_dequant_matmul_dual(x_codes: torch.Tensor, codes: torch.Tensor,
                            lut_x: torch.Tensor, lut_w: torch.Tensor,
                            qmeta_x=None, qmeta_w=None, *,
                            decode_mode: str = "gather",
                            epilogue: str | None = None, bias=None,
                            out_qmeta=None,
                            out_dtype=torch.float32,
                            autotune: bool | None = None) -> torch.Tensor:
    """``act(dec_x(x_codes[M, K]) @ dec_w(codes[K, N]) + bias)`` with both
    operands uint8 codes, each decoded through its own table in the
    kernel.  ``out_qmeta`` re-encodes the result: uint8 codes out."""
    if x_codes.device.type == "cpu":
        return lut_dequant_matmul_dual_ref(
            x_codes, codes, lut_x, lut_w, qmeta_x, qmeta_w,
            out_qmeta=out_qmeta, out_dtype=out_dtype, epilogue=epilogue,
            bias=bias, decode_mode=decode_mode)
    run = functools.partial(_k.launch_dual, x_codes, codes, lut_x, lut_w,
                            qmeta_x, qmeta_w, out_qmeta=out_qmeta, bias=bias,
                            decode_mode=decode_mode, epilogue=epilogue)
    m, k, n = x_codes.shape[0], x_codes.shape[-1], codes.shape[-1]
    plan = _plan_for("dual", x_codes, m, k, n, 1, False, decode_mode,
                     key_extra("dual", epilogue=epilogue,
                               bias=bias is not None,
                               out_quant=out_qmeta is not None),
                     autotune, lambda p: run(plan=p), _out_agree(out_qmeta))
    out = run(plan=plan)
    return out if out_qmeta is not None else out.to(out_dtype)


def lut_dequant_matmul_dual_gated(x_codes: torch.Tensor, codes_g: torch.Tensor,
                                  codes_u: torch.Tensor, lut_x: torch.Tensor,
                                  lut_g: torch.Tensor, lut_u: torch.Tensor,
                                  qmeta_x=None, qmeta_g=None, qmeta_u=None, *,
                                  activation: str = "silu", out_qmeta=None,
                                  decode_mode: str = "gather",
                                  out_dtype=torch.float32,
                                  autotune: bool | None = None
                                  ) -> torch.Tensor:
    """The gated-MLP front half on an activation-code operand: one shared
    decode of ``x_codes`` feeds both matmuls; ``out_qmeta`` re-encodes
    ``act(g) * u`` so the down projection reads codes."""
    if x_codes.device.type == "cpu":
        return lut_dequant_matmul_dual_gated_ref(
            x_codes, codes_g, codes_u, lut_x, lut_g, lut_u, qmeta_x, qmeta_g,
            qmeta_u, activation=activation, out_qmeta=out_qmeta,
            out_dtype=out_dtype, decode_mode=decode_mode)
    run = functools.partial(_k.launch_dual_gated, x_codes, codes_g, codes_u,
                            lut_x, lut_g, lut_u, qmeta_x, qmeta_g, qmeta_u,
                            out_qmeta=out_qmeta, decode_mode=decode_mode,
                            activation=activation)
    m, k, n = x_codes.shape[0], x_codes.shape[-1], codes_g.shape[-1]
    plan = _plan_for("dual_gated", x_codes, m, k, n, 2, False, decode_mode,
                     key_extra("dual_gated", activation=activation,
                               out_quant=out_qmeta is not None),
                     autotune, lambda p: run(plan=p), _out_agree(out_qmeta))
    out = run(plan=plan)
    return out if out_qmeta is not None else out.to(out_dtype)
