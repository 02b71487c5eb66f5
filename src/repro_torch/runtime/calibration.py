"""Activation-quantization calibration (port of the JAX package's
``runtime/calibration.py``): fit per-(layer, site) DNA-TEQ params on
sample prompts and attach them to the params.

One forward over the prompts through the model's
``collect_act_calibration`` hook captures the float tensor at every site
of :data:`repro_torch.models.layers.ACT_SITES`; each (layer, site) gets
its own (alpha, beta, base) from the port's alternating-LS / base-grid
fit (:func:`repro_torch.core.exponential_quant.fit`, one stacked fit
over the ``[L, N]`` rows).  The KV sites ``attn_k``/``attn_v`` are fit
per KV head (``[L * n_kv, N]`` rows): heads see very different key and
value scales.  The tables ride the params as ``blocks.act_q[site] =
{"lut": [L, 256], "qmeta": [L, 4]}`` (``[L, n_kv, 256]`` /
``[L, n_kv, 4]`` per head), so a layer's slice is what its matmuls and
attends read.  Everything runs on the params' device.

**Cache.**  Fits are kept on disk in the reference's v2 JSON format, so
a reference-fit entry loads into the port unchanged (and back)::

    {"version": 2,
     "entries": {"<cfg.name>|L<layers>|d<d_model>|f<d_ff>|b<bits>|"
                 "c<n>x<len>|p<prompts crc32>|s<seed>|w<params fingerprint>":
                 {"sites": {"attn_in": [[alpha, beta, base, bits], ...],
                            "attn_k": [[[...per head], ...per layer]], ...},
                  "sqnr_db": {...same nesting...}}}}

at ``REPRO_ACT_CALIB_CACHE`` (default ``~/.cache/repro/
act_quant_calib.json``) or a ``path=`` argument; writes are atomic
(tmp + rename); a blob of another version is ignored and replaced
whole.  Tables are not stored: they are rebuilt from the params by the
ALU decode of the 256 code points, so a hit and a fresh fit give the
same tables.  The key's weight fingerprint sums float values in the
port's order, so keys need not match the reference's.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from repro_torch.core import exponential_quant as eq

_CALIB_VERSION = 2

# sites fit per head, with the head axis of the captured [L, B, S, n_kv,
# hd] sample
PER_HEAD_SITES: dict[str, int] = {"attn_k": -2, "attn_v": -2}

# The activation base grid: the weight grid extended down to
# 2^(1/256), for the narrow bands of post-norm activations, with more
# alternating-LS iterations for the fine bases to converge.
ACT_BASES: tuple[float, ...] = tuple(
    float(2.0 ** (1.0 / k)) for k in (1, 2, 3, 4, 6, 8, 12, 16, 24,
                                      32, 48, 64, 96, 128, 192, 256))
ACT_FIT_ITERS = 20


def cache_path() -> str:
    return os.environ.get(
        "REPRO_ACT_CALIB_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro",
                     "act_quant_calib.json"))


def _params_fingerprint(params) -> str:
    """Float-buffer count and total L1 mass of the weights, so cached
    params never cross weight sets (for a quantized model: the decode
    tables, norms and float leaves)."""
    leaves = [b for b in params.buffers() if b.is_floating_point()]
    if not leaves:
        return "none"
    tot = sum(float(b.abs().sum(dtype=torch.float64)) for b in leaves)
    return f"{len(leaves)}_{tot:.6e}"


def calib_key(cfg, bits: int, prompts: np.ndarray, seed: int,
              params) -> str:
    """Cache key: architecture, bits, the prompts (shape and content)
    and the weight values."""
    p = np.ascontiguousarray(np.asarray(prompts, np.int32))
    crc = zlib.crc32(p.tobytes())
    return (f"{cfg.name}|L{cfg.num_layers}|d{cfg.d_model}|f{cfg.d_ff}"
            f"|b{bits}|c{p.shape[0]}x{p.shape[1]}|p{crc:08x}|s{seed}"
            f"|w{_params_fingerprint(params)}")


def lut_from_qmeta(qmeta: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` packed params -> ``[..., 256]`` decode tables (the
    ALU decode of every code), the one construction used by fresh fits
    and cache hits."""
    codes = torch.arange(256, dtype=torch.int32, device=qmeta.device)
    return eq.decode_meta(codes, qmeta.to(torch.float32)[..., None, :])


def _site_rows(site: str, x: torch.Tensor) -> torch.Tensor:
    """The fit's rows of a captured ``[L, ...]`` sample: one per layer,
    or one per (layer, head) for :data:`PER_HEAD_SITES`."""
    if site in PER_HEAD_SITES:
        x = torch.movedim(x, PER_HEAD_SITES[site] % x.ndim, 1)
        return x.reshape(x.shape[0] * x.shape[1], -1)
    return x.reshape(x.shape[0], -1)


def _lead(site: str, x: torch.Tensor) -> tuple[int, ...]:
    if site in PER_HEAD_SITES:
        return (x.shape[0], x.shape[PER_HEAD_SITES[site]])
    return (x.shape[0],)


def fit_sites(samples: dict, bits: int):
    """Fit per-(layer, site) params on captured activations
    ``{site: [L, ...]}``.  Returns ``(act_q, report)``: ``act_q[site] =
    {"lut": [L, 256], "qmeta": [L, 4]}`` (``[L, n_kv, ...]`` for the
    per-head sites) and ``report[site]`` the round-trip SQNR in dB with
    the same nesting, as lists."""
    act_q, report = {}, {}
    for site, x in samples.items():
        rows = _site_rows(site, x.to(torch.float32))
        qp = eq.fit(rows, bits, bases=ACT_BASES, iters=ACT_FIT_ITERS,
                    stacked=True)
        lead = _lead(site, x)
        metas = eq.pack_qmeta(qp).reshape(lead + (4,))
        sqnr = eq.sqnr_db(rows, qp, stacked=True).reshape(lead)
        act_q[site] = {"lut": lut_from_qmeta(metas), "qmeta": metas}
        report[site] = sqnr.double().cpu().numpy().tolist()
    return act_q, report


def measure_sqnr(samples: dict, act_q: dict) -> dict[str, float]:
    """Round-trip SQNR (dB) of captured activations under fitted tables
    (``encode_meta`` then ``decode_meta``, the serving encode): one mean
    per site present in both."""
    out: dict[str, float] = {}
    for site, x in samples.items():
        if site not in act_q:
            continue
        rows = _site_rows(site, x.to(torch.float32))
        qmeta = act_q[site]["qmeta"].to(torch.float32).reshape(-1, 1, 4)
        back = eq.decode_meta(eq.encode_meta(rows, qmeta), qmeta)
        num = (rows * rows).sum(-1)
        den = ((rows - back) ** 2).sum(-1) + 1e-12
        out[site] = float((10.0 * torch.log10(num / den + 1e-12)).mean())
    return out


def report_means(report: dict | None) -> dict[str, float]:
    """Per-site mean SQNR of a calibration report (heads flattened)."""
    if not report:
        return {}
    return {site: float(np.mean(np.asarray(v, np.float64)))
            for site, v in report.items()}


def kv_tables_fingerprint(act_q: dict) -> int:
    """CRC32 over the packed per-head attn_k/attn_v params: the identity
    of a codes-mode KV byte stream (pages decode right only under the
    tables they were encoded with)."""
    crc = 0
    for site in ("attn_k", "attn_v"):
        q = np.ascontiguousarray(
            act_q[site]["qmeta"].detach().cpu().numpy().astype(np.float32))
        crc = zlib.crc32(q.tobytes(), crc)
    return crc


def _act_q_from_entry(entry: dict, device):
    act_q = {}
    for site, metas in entry["sites"].items():
        qmeta = torch.tensor(metas, dtype=torch.float32, device=device)
        act_q[site] = {"lut": lut_from_qmeta(qmeta), "qmeta": qmeta}
    return act_q, {s: list(v) for s, v in entry.get("sqnr_db", {}).items()}


def _load_entry(path: str, key: str) -> dict | None:
    try:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("version") != _CALIB_VERSION:
            return None
        return blob.get("entries", {}).get(key)
    except (OSError, ValueError):
        return None


def _save_entry(path: str, key: str, act_q: dict, report: dict) -> None:
    entry = {"sites": {site: t["qmeta"].detach().cpu().numpy()
                       .astype(np.float32).tolist()
                       for site, t in act_q.items()},
             "sqnr_db": report}
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        blob = {"version": _CALIB_VERSION, "entries": {}}
        try:
            with open(path) as f:
                old = json.load(f)
            if old.get("version") == _CALIB_VERSION:
                blob["entries"].update(old.get("entries", {}))
        except (OSError, ValueError):
            pass
        blob["entries"][key] = entry
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def attach_act_quant(params, act_q: dict):
    """A new module over ``params``' tensors with ``blocks.act_q`` set to
    ``act_q`` (``params`` itself is left as it is)."""
    tree = params.tree()
    tree["blocks"] = {**tree["blocks"], "act_q": act_q}
    return params.with_tree(tree)


def strip_act_quant(params):
    """``params`` without attached act-quant tables (itself if none)."""
    tree = params.tree()
    if "act_q" not in tree["blocks"]:
        return params
    tree["blocks"] = {k: v for k, v in tree["blocks"].items() if k != "act_q"}
    return params.with_tree(tree)


def calibrate_act_quant(api, params, cfg, bits: int,
                        prompts: np.ndarray | None = None,
                        seq_len: int = 32, n_prompts: int = 4,
                        seed: int = 0, path: str | None = None):
    """Fit (or load) per-(layer, site) act-quant params; returns
    ``(params_with_act_q, report)``.  ``prompts`` overrides the default
    random sample (``[n_prompts, seq_len]`` ids from ``seed``).  Tables
    already attached to ``params`` are removed first, so the key and the
    forward see only the weights."""
    if api.collect_act_calibration is None:
        raise ValueError(
            f"model family {cfg.family!r} has no act-quant calibration "
            f"hook (collect_act_calibration)")
    params = strip_act_quant(params)
    if prompts is None:
        rng = np.random.default_rng(seed)
        prompts = rng.integers(0, cfg.vocab_size,
                               (n_prompts, seq_len)).astype(np.int32)
    prompts = np.asarray(prompts, np.int32)
    path = path or cache_path()
    key = calib_key(cfg, bits, prompts, seed, params)
    entry = _load_entry(path, key)
    if entry is not None:
        act_q, report = _act_q_from_entry(entry, params.device)
        return attach_act_quant(params, act_q), report
    samples = api.collect_act_calibration(
        params, torch.as_tensor(prompts, device=params.device), cfg)
    act_q, report = fit_sites(samples, bits)
    _save_entry(path, key, act_q, report)
    return attach_act_quant(params, act_q), report


__all__ = ["calibrate_act_quant", "attach_act_quant", "strip_act_quant",
           "fit_sites", "cache_path", "calib_key", "lut_from_qmeta",
           "measure_sqnr", "report_means", "kv_tables_fingerprint",
           "PER_HEAD_SITES", "ACT_BASES", "ACT_FIT_ITERS"]
