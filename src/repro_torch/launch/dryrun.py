"""Dry run of every (architecture x input shape x mesh) cell on the
``meta`` device (port of the JAX package's ``launch/dryrun.py``, with its
flags and file names):

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A --shape S
        --mesh single|multi|both --quant B --serve-rules v1|v2
        --serve-params fsdp|tp --kv-dtype bf16|f8 --train-rules tp|cp
        --moe routed|dense_mixture|ep_a2a --tag T --out DIR --force]

It needs no card and no compiler.  Each cell builds the reference's step
for its shape on the ``meta`` device: train (the loss, autograd and
AdamW), prefill or decode.  The parameters are DTensors laid out by
:mod:`repro_torch.sharding.rules` on a ``DeviceMesh`` over the ``fake``
process-group backend at the production mesh's 256 or 512 ranks; the
inputs come from ``models.api.input_specs`` and a decode step's cache
from the family's ``abstract_cache``.  One record a cell goes to
``<out>/<pod16x16|pod2x16x16>/<arch>__<shape>[__q<B>][__<tag>].json``
(default ``build/dryrun``).

What a record holds, per device:

* **memory** (``memory_analysis``): the parameter, optimizer-state and
  input (and a decode step's cache) bytes of the local shards, exactly,
  plus the peak live bytes of the traced step: an op counter sees every
  rank-local op under DTensor and adds each new output's bytes until the
  tensor is freed (a weakref finaliser).  The gradients, the recomputed
  blocks and AdamW's new tensors are live inside that trace, so the
  gradient bytes are reported but not added again.  The trace runs on
  the reference's cost pair (1 and 2 units of depth) and its peak is
  extrapolated to full depth as the FLOPs are.  ``fits_80gb_hbm``
  against the card's 80 GB.
* **FLOPs**: ``torch.utils.flop_counter``'s formulas over the same local
  ops, on the pair (``cost_pair_cfgs``), extrapolated by the reference's
  ``extrap`` (its negative-delta fallback included), plus
  ``wkv_analytic_flops`` (the reference adds it because XLA counts a
  scan body once; the port's WKV loop is traced, so its einsums, two of
  the six flops a state element, are in the traced count too).
* **collective bytes**: every functional collective DTensor issues
  (``CommDebugMode`` counts them; the op counter sums their result
  bytes, the reference's proxy), and the expert-parallel all-to-alls
  from their buffers' shapes (``models.moe_ep.count_all_to_all``): a
  ``cpu`` mesh's DTensor emulates an all-to-all with an all-gather, and
  a redistribution between two sharded dims is counted as that
  all-gather.
* **roofline**: the three terms against the card's datasheet figures
  (:data:`PEAKS`), ``model_flops_estimate``'s usefulness ratio.

``model_flops_estimate``, ``analytic_hbm_bytes``, ``cost_pair_cfgs`` and
``wkv_analytic_flops`` are the reference's arithmetic on configs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from unittest import mock

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import tree as T
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import (SHAPES_BY_NAME, ModelConfig, RunShape,
                                      supports_shape)
from repro_torch.core import lama_layers as ll
from repro_torch.core.exponential_quant import QWeight
from repro_torch.launch.mesh import PRODUCTION, MeshShape, use_mesh
from repro_torch.models import api as mapi
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R

# The card's datasheet figures (NVIDIA H100 SXM5 80GB HBM3, 700 W).  A
# 16-rank model axis spans two 8-GPU NVLink nodes, so its slowest link
# is a GPU's own InfiniBand NIC: one ConnectX-7 at 400 Gb/s NDR per GPU
# (the DGX H100 layout), 50 GB/s each way.
PEAKS = {
    "card": "NVIDIA H100 80GB HBM3 at 700 W (datasheet)",
    "peak_flops": 989e12,       # bf16 dense tensor-core FLOP/s
    "hbm_bw": 3.35e12,          # B/s
    "link_bw": 50e9,            # B/s a GPU: 400 Gb/s NDR InfiniBand NIC
    "link": "InfiniBand NDR 400 Gb/s, one ConnectX-7 a GPU (DGX H100)",
    "hbm_bytes": 80e9,
}

_DTYPES = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn}

_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all"}


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


# ------------------------------------------------ the reference's arithmetic

def model_flops_estimate(cfg: ModelConfig, shape: RunShape) -> float:
    """MODEL_FLOPS: 6*N_active*D for train, 2*N_active*D for inference."""
    api = mapi.get_model(cfg)
    n = api.param_count()
    n -= cfg.vocab_size * cfg.d_model  # exclude embedding gather
    if cfg.is_moe:
        e, k = cfg.num_experts, cfg.experts_per_token
        # expert weights contribute k/e of their flops
        expert_params = (3 * cfg.d_model * cfg.d_ff * cfg.num_experts
                         * cfg.num_layers)
        n = n - expert_params + expert_params * k / e
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def cost_pair_cfgs(cfg: ModelConfig):
    """(cfg_1unit, cfg_2units, units_full) for depth extrapolation."""
    if cfg.family == "hybrid":
        period = len(cfg.attention_pattern or ("rec", "rec", "local"))
        return (cfg.replace(num_layers=period, scan_layers=False),
                cfg.replace(num_layers=2 * period, scan_layers=False),
                cfg.num_layers / period)
    if cfg.family == "encdec":
        return (cfg.replace(enc_layers=1, dec_layers=1, num_layers=2,
                            scan_layers=False),
                cfg.replace(enc_layers=2, dec_layers=2, num_layers=4,
                            scan_layers=False),
                float(cfg.enc_layers))
    return (cfg.replace(num_layers=1, scan_layers=False),
            cfg.replace(num_layers=2, scan_layers=False),
            float(cfg.num_layers))


def _abstract_cache(api, cfg: ModelConfig, b: int, s: int, dtype):
    if cfg.family == "encdec":
        return api.abstract_cache(cfg, b, s, enc_len=min(s, 4096),
                                  dtype=dtype)
    return api.abstract_cache(cfg, b, s, dtype=dtype)


def analytic_hbm_bytes(cfg: ModelConfig, shape: RunShape, chips: int,
                       quant: int | None = None,
                       param_shard_degree: int | None = None,
                       kv_dtype=torch.bfloat16) -> dict:
    """Fused-execution HBM traffic estimate (per chip): params read (+
    write, + optimizer state r/w + grads for train), the KV/state cache
    read + write (serving), one activation read + write per fused block
    op (~c_act a layer) + remat recompute reads, logits / loss traffic
    (the reference's model, term for term)."""
    api = mapi.get_model(cfg)
    pdt = torch.bfloat16 if shape.is_serving else torch.float32
    ap = api.abstract_params(pdt)
    if quant and shape.is_serving:
        ap, _ = ll.abstract_quantize(ap, api.logical_axes(), bits=quant)
    p_bytes = _tree_bytes(ap)
    p_shard = param_shard_degree or chips
    n_params = api.param_count()
    b, s = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, cfg.num_layers
    act_bytes = 2  # bf16

    if shape.kind == "train":
        weight_traffic = (
            2 * p_bytes          # params read + write
            + 4 * 4 * n_params   # mu/nu read + write (f32)
            + 2 * 4 * n_params   # grads write + read
        )
        c_act = 16 if not cfg.is_moe else 24
        act_traffic = L * b * s * d * act_bytes * c_act * (4 / 3)  # remat
        logits_traffic = 3 * b * s * cfg.vocab_size * 4
        total = weight_traffic + act_traffic + logits_traffic
        return {"total_bytes": total, "per_chip_bytes": total / chips,
                "param_bytes": p_bytes}
    if shape.kind == "prefill":
        cache = _abstract_cache(api, cfg, b, s, torch.bfloat16)
        c_act = 12 if not cfg.is_moe else 18
        per_chip = (p_bytes / p_shard
                    + (_tree_bytes(cache)
                       + L * b * s * d * act_bytes * c_act
                       + b * cfg.vocab_size * 4) / chips)
        return {"total_bytes": per_chip * chips, "per_chip_bytes": per_chip,
                "param_bytes": p_bytes}
    cache_b = _tree_bytes(_abstract_cache(api, cfg, b, s, kv_dtype))
    per_chip = (p_bytes / p_shard   # every resident weight read per token
                + (cache_b          # cache read (+ small write)
                   + b * cfg.vocab_size * 4
                   + L * b * d * act_bytes * 12) / chips)
    return {"total_bytes": per_chip * chips, "per_chip_bytes": per_chip,
            "param_bytes": p_bytes}


def wkv_analytic_flops(cfg: ModelConfig, shape: RunShape,
                       layers: float) -> float:
    """WKV time-scan flops: ~6 flops per (K,V) state element a token."""
    if cfg.family != "rwkv" or shape.kind == "decode":
        return 0.0
    h = cfg.d_model // cfg.rwkv_head_dim
    per_tok = 6.0 * h * cfg.rwkv_head_dim ** 2 * layers
    tokens = shape.global_batch * shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd+bwd
    return per_tok * tokens * mult


# ----------------------------------------------------------- the tracer

class OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Sees every rank-local op (an op on DTensors is handed back to
    DTensor, which runs it as local ops and collectives): FLOPs by
    ``torch.utils.flop_counter``'s formulas, the operand and result
    bytes of each op (an unfused upper bound on memory traffic), the
    live bytes of new outputs and their peak, and each collective's
    result bytes by kind."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.coll = {k: {"count": 0, "result_bytes": 0}
                     for k in _COLLECTIVES.values()}

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's shape propagation, not a rank's op
        self.ops += 1
        pkt = func._overloadpacket
        if pkt in self.registry:
            self.flops += self.registry[pkt](*args, **kwargs, out_val=out)
        kind = _COLLECTIVES.get(pkt.__name__)
        if kind and "c10d" in func.namespace:
            self.coll[kind]["count"] += 1
            self.coll[kind]["result_bytes"] += sum(
                o.numel() * o.element_size() for o in outs)
        if func.is_view:
            return out
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for o in outs:
            if any(o is a for a in ins):
                continue                        # in place
            n = o.numel() * o.element_size()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(o, self._free, n)
        return out


@contextlib.contextmanager
def fake_mesh(shape: dict):
    """A ``cpu`` ``DeviceMesh`` of ``shape`` over a ``fake`` process group
    of its size (opened here, destroyed at exit)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import device_mesh

    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake process group; "
                           "one is already initialised")
    ms = MeshShape.of(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ms.size)
    try:
        yield device_mesh(shape, "cpu")
    finally:
        dist.destroy_process_group()


def _dtensor(t: torch.Tensor, spec: tuple, mesh):
    """A DTensor of ``t``'s global shape laid out by ``spec``, its local
    shard a ``meta`` tensor."""
    from torch.distributed.tensor import DTensor

    loc = torch.empty(R.local_shape(tuple(t.shape), spec, mesh),
                      dtype=t.dtype, device="meta")
    return DTensor.from_local(loc, mesh, R.placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _place(abstract, specs, mesh):
    return R.map_leaves(lambda t, s: _dtensor(t, s, mesh), abstract, specs)


def _qweights(tree):
    """``abstract_quantize``'s ``{codes, lut, qmeta}`` dicts as QWeight."""
    if isinstance(tree, dict):
        if set(tree) == {"codes", "lut", "qmeta"}:
            return QWeight(tree["codes"], tree["lut"], tree["qmeta"])
        return {k: _qweights(v) for k, v in tree.items()}
    return tree


_FAMILY_MODULES = {"decoder": "transformer", "vlm": "transformer",
                   "hybrid": "rglru", "rwkv": "rwkv6", "encdec": "encdec"}


def trace_step(cfg: ModelConfig, shape: RunShape, mesh, quant=None,
               kv_dtype=torch.bfloat16) -> dict:
    """One cell's step on ``mesh`` (a ``DeviceMesh``), traced: returns the
    op counter's figures and the collective counts."""
    import importlib

    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.moe_ep import count_all_to_all

    api = mapi.get_model(cfg)
    mode = "serve" if shape.is_serving else "train"
    pdt = torch.bfloat16 if shape.is_serving else torch.float32
    aparams, axes = api.abstract_params(pdt), api.logical_axes()
    if quant and shape.is_serving:
        aparams, axes = ll.abstract_quantize(aparams, axes, bits=quant)
    p_specs = R.tree_shardings(aparams, axes, mesh, mode)
    params = _place(aparams, p_specs, mesh)
    abatch = mapi.input_specs(cfg, shape)
    batch = _place(abatch, R.tree_shardings(
        abatch, R.batch_logical_axes(abatch), mesh, mode,
        params_rank_gate=False), mesh)
    fam = importlib.import_module(
        f"repro_torch.models.{_FAMILY_MODULES[cfg.family]}")

    def sharded_cache(b, s, dtype, enc_len=None):
        """The cache as DTensors laid out by the cache rules (a prefill's
        encdec cross cache holds its ``enc_len`` frames)."""
        ac = (api.abstract_cache(cfg, b, s, enc_len=enc_len, dtype=dtype)
              if enc_len else _abstract_cache(api, cfg, b, s, dtype))
        cache = _place(ac, R.tree_shardings(
            ac, R.cache_logical_axes(ac), mesh, "serve",
            params_rank_gate=False), mesh)
        cache["pos"] = 0
        return cache

    module = api.module(cfg, _qweights(params), device="meta")
    counter, comm = OpCounter(), CommDebugMode()
    patch = contextlib.nullcontext()
    if shape.kind == "train":
        aopt = adamw.abstract_state(aparams)
        opt = adamw.AdamWState(step=aopt.step,
                               mu=_place(aopt.mu, p_specs, mesh),
                               nu=_place(aopt.nu, p_specs, mesh))
    elif shape.kind == "decode":
        cache = sharded_cache(shape.global_batch, shape.seq_len, kv_dtype)
        cache["pos"] = shape.seq_len - 1
    else:
        patch = mock.patch.object(
            fam, "init_cache", lambda cfg_, b, s, dtype=torch.bfloat16,
            device=None, enc_len=None: sharded_cache(b, s, dtype, enc_len))

    t0 = time.perf_counter()
    with use_mesh(mesh), patch, implicit_replication(), comm, counter, \
            count_all_to_all() as a2a, ll.policy(flash_decode=False):
        if shape.kind == "train":
            leaves = [p.requires_grad_(True) for p in T.leaves(params)]
            total, _ = mapi.loss_fn(api, module, batch)
            grads = torch.autograd.grad(total, leaves)
            # the gradients in the parameters' placements (a reduce-scatter)
            grads = T.unflatten(params, [
                g.redistribute(p.device_mesh, p.placements)
                for g, p in zip(grads, leaves)])
            out = adamw.update(grads, opt, params, lr=3e-4)
            del total, grads, out
        elif shape.kind == "prefill":
            out = api.prefill(module, batch["tokens"], cfg, shape.seq_len,
                              prefix_embeds=batch.get("prefix_embeds"),
                              cache_dtype=torch.bfloat16)
            del out
        else:
            out = api.decode_step(module, cache, batch["tokens"], cfg)
            del out
    coll = dict(counter.coll)
    coll["all-to-all (EP buffers)"] = {"count": a2a["count"],
                                      "result_bytes": a2a["bytes"]}
    coll["total_result_bytes"] = sum(v["result_bytes"] for v in coll.values()
                                     if isinstance(v, dict))
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "coll_bytes": float(coll["total_result_bytes"]),
            "peak_bytes": float(counter.peak), "ops": counter.ops,
            "collectives": coll,
            "comm_counts": {str(k).split("'")[1] if "'" in str(k) else str(k):
                            v for k, v in comm.get_comm_counts().items()},
            "trace_s": time.perf_counter() - t0}


def extrap(m1: dict, m2: dict, key: str, units: float) -> float:
    """The reference's depth extrapolation of ``key`` from 1 and 2 units;
    a negative delta falls back to the 2-unit program's per-unit
    average."""
    d = m2[key] - m1[key]
    if d < 0:
        return m2[key] * (units / 2.0)
    return m1[key] + d * (units - 1.0)


# ------------------------------------------------------------ cell runner

def _mesh_name(multi_pod: bool, mesh_shape: dict | None) -> str:
    if mesh_shape is not None:
        return "mesh" + "x".join(str(n) for n in mesh_shape.values())
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, quant: int | None = None,
             tag: str | None = None, kv_dtype=torch.bfloat16,
             moe_impl: str | None = None, cfg: ModelConfig | None = None,
             shape: RunShape | None = None,
             mesh_shape: dict | None = None) -> dict:
    """One cell's record, written to ``out_dir`` (or read back from it
    unless ``force``).  ``cfg`` / ``shape`` / ``mesh_shape`` replace the
    registry's config, the named shape and the production mesh (a small
    mesh, a cut config)."""
    from repro_torch.models import layers as mlayers

    mesh_name = _mesh_name(multi_pod, mesh_shape)
    suffix = (f"__q{quant}" if quant else "") + (f"__{tag}" if tag else "")
    out_path = (Path(out_dir) / mesh_name
                / f"{arch}__{shape_name}{suffix}.json")
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    out_path.parent.mkdir(parents=True, exist_ok=True)

    cfg = cfg or get_config(arch)
    if moe_impl:
        cfg = cfg.replace(moe_impl=moe_impl)
    shape = shape or SHAPES_BY_NAME[shape_name]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "quant": quant, "moe_impl": moe_impl,
        "status": "skip" if not supports_shape(cfg, shape) else "pending",
    }
    if rec["status"] == "skip":
        rec["reason"] = ("long_500k needs sub-quadratic attention "
                         "(DESIGN.md §4)")
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    shape_axes = mesh_shape or PRODUCTION[multi_pod]
    chips = MeshShape.of(shape_axes).size
    t0 = time.perf_counter()
    try:
        c1, c2, units = cost_pair_cfgs(cfg)
        with fake_mesh(shape_axes) as mesh:
            m1 = trace_step(c1, shape, mesh, quant=quant, kv_dtype=kv_dtype)
            m2 = trace_step(c2, shape, mesh, quant=quant, kv_dtype=kv_dtype)
        # resident bytes at full depth, from the local shard shapes
        full = _resident(cfg, shape, shape_axes, quant, kv_dtype)

        flops_dev = extrap(m1, m2, "flops", units)
        bytes_dev = extrap(m1, m2, "bytes", units)
        coll_dev = extrap(m1, m2, "coll_bytes", units)
        trace_peak = extrap(m1, m2, "peak_bytes", units)
        wkv_adj = wkv_analytic_flops(cfg, shape, units) / chips
        flops_dev += wkv_adj
        p_shard_degree = None
        if shape.is_serving and not R.SERVE_PARAM_FSDP:
            p_shard_degree = shape_axes["model"]
        amem = analytic_hbm_bytes(cfg, shape, chips, quant=quant,
                                  param_shard_degree=p_shard_degree,
                                  kv_dtype=kv_dtype)
        resident = sum(v for k, v in full.items() if k != "grad_bytes")
        mem = {**full, "trace_peak_bytes": trace_peak,
               "peak_per_device_bytes": resident + trace_peak}
        mem["fits_80gb_hbm"] = bool(mem["peak_per_device_bytes"]
                                    < PEAKS["hbm_bytes"])

        mf = model_flops_estimate(cfg, shape)
        terms = {
            "t_compute_s": flops_dev / PEAKS["peak_flops"],
            "t_memory_s": amem["per_chip_bytes"] / PEAKS["hbm_bw"],
            "t_memory_traced_upper_s": bytes_dev / PEAKS["hbm_bw"],
            "t_collective_s": coll_dev / PEAKS["link_bw"],
            "traced_flops_per_chip": flops_dev,
            "traced_bytes_per_chip": bytes_dev,
            "analytic_bytes_per_chip": amem["per_chip_bytes"],
            "param_bytes_total": amem["param_bytes"],
            "coll_bytes_per_chip": coll_dev,
            "model_flops_total": mf,
            "model_flops_per_chip": mf / chips,
            "useful_flops_ratio": ((mf / chips) / flops_dev
                                   if flops_dev else None),
            "wkv_analytic_flops_per_chip": wkv_adj,
        }
        dom = max(("t_compute_s", "t_memory_s", "t_collective_s"),
                  key=lambda k: terms[k])
        terms["dominant"] = dom
        bound = terms[dom]
        terms["roofline_fraction_of_bound"] = (
            (mf / chips / PEAKS["peak_flops"]) / bound if bound else None)
        rec.update({
            "status": "ok",
            "chips": chips,
            "trace_s": round(m1["trace_s"] + m2["trace_s"], 1),
            "total_s": round(time.perf_counter() - t0, 1),
            "memory_analysis": mem,
            "cost_pair": {"unit1": m1, "unit2": m2, "units_full": units},
            "collectives_unit2": m2["collectives"],
            "roofline": terms,
            "traced_ops_unit2": m2["ops"],
            "peaks": PEAKS,
            "notes": [
                "per-device figures from the rank-local ops DTensor runs",
                "memory: resident shard bytes at full depth + the traced "
                "step's peak live bytes extrapolated from the cost pair",
                "collectives on a cpu mesh: an all-to-all between shard "
                "dims runs as an all-gather; the EP all-to-alls are "
                "counted from their buffers",
                "decode attends through the dense branch (the flash-decode "
                "kernel's plain version)"],
        })
    except Exception as e:       # noqa: BLE001 - the record carries it
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def _resident(cfg: ModelConfig, shape: RunShape, shape_axes: dict, quant,
              kv_dtype) -> dict:
    """Per-device bytes of the parameters, the AdamW state (train), the
    inputs and a decode step's cache at full depth: each leaf's local
    shard under the rules, no trace."""
    api = mapi.get_model(cfg)
    mesh = MeshShape.of(shape_axes)
    mode = "serve" if shape.is_serving else "train"
    pdt = torch.bfloat16 if shape.is_serving else torch.float32
    ap, axes = api.abstract_params(pdt), api.logical_axes()
    if quant and shape.is_serving:
        ap, axes = ll.abstract_quantize(ap, axes, bits=quant)

    def local(tree, specs):
        return sum(T.leaves(R.map_leaves(
            lambda t, s: math.prod(R.local_shape(tuple(t.shape), s, mesh))
            * t.element_size(), tree, specs)))

    p_specs = R.tree_shardings(ap, axes, mesh, mode)
    out = {"param_bytes": local(ap, p_specs)}
    ab = mapi.input_specs(cfg, shape)
    out["input_bytes"] = local(ab, R.tree_shardings(
        ab, R.batch_logical_axes(ab), mesh, mode, params_rank_gate=False))
    if shape.kind == "train":
        st = adamw.abstract_state(ap)
        out["opt_bytes"] = local(st.mu, p_specs) + local(st.nu, p_specs)
        out["grad_bytes"] = out["param_bytes"]
    if shape.kind == "decode":
        ac = _abstract_cache(api, cfg, shape.global_batch, shape.seq_len,
                             kv_dtype)
        out["cache_bytes"] = local(ac, R.tree_shardings(
            ac, R.cache_logical_axes(ac), mesh, "serve",
            params_rank_gate=False))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quant", type=int, default=None,
                    help="serve weights as DNA-TEQ codes at this width")
    ap.add_argument("--serve-rules", choices=["v1", "v2"], default="v2",
                    help="v1: head-dim-sharded cache; v2: split-K seq-sharded")
    ap.add_argument("--serve-params", choices=["fsdp", "tp"], default="fsdp",
                    help="serving weight placement: ZeRO-gathered or TP-only")
    ap.add_argument("--kv-dtype", choices=["bf16", "f8"], default="bf16",
                    help="KV-cache dtype (f8 = float8_e4m3fn)")
    ap.add_argument("--train-rules", choices=["tp", "cp"], default="tp",
                    help="training parallelism: FSDP+TP or context-parallel")
    ap.add_argument("--moe", choices=["routed", "dense_mixture", "ep_a2a"],
                    default=None, help="override MoE dispatch implementation")
    ap.add_argument("--tag", default=None,
                    help="artifact filename suffix for perf variants")
    args = ap.parse_args(argv)

    R.set_serve_seq_shard(args.serve_rules == "v2")
    R.set_serve_param_fsdp(args.serve_params == "fsdp")
    if args.train_rules == "cp":
        from repro_torch.models import layers as _ml
        R.set_train_cp(True)
        _ml.set_context_parallel(True)

    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES_BY_NAME)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mp, out_dir, force=args.force,
                               quant=args.quant, tag=args.tag,
                               kv_dtype=_DTYPES[args.kv_dtype],
                               moe_impl=args.moe)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    m = rec["memory_analysis"]
                    extra = (f" dom={r['dominant']}"
                             f" tc={r['t_compute_s']:.3e}"
                             f" tm={r['t_memory_s']:.3e}"
                             f" tx={r['t_collective_s']:.3e}"
                             f" peak={m['peak_per_device_bytes']:.4e}B")
                elif status == "error":
                    extra = " " + rec.get("error", "")[:120]
                print(f"[{time.time()-t0:7.1f}s] {arch:24s} {shape:12s} "
                      f"{'multi' if mp else 'single':6s} {status}{extra}",
                      flush=True)


if __name__ == "__main__":
    main()
