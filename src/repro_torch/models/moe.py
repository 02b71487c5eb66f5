"""Mixture-of-Experts layers (port of the JAX package's ``models/moe.py``;
llama4-scout: 16 experts, top-1; grok-1: 8 experts, top-2).

Two implementations, selected by ``cfg.moe_impl``:

* ``routed``: top-k routing with sort-based, capacity-dropped dispatch
  (the GShard capacity discipline, slots grouped by a stable sort).  The
  expert FFNs run as einsums over the ``experts`` axis, which
  ``dense_general`` runs as one LUT GEMM launch an expert (the
  reference vmaps its kernel over that axis).
* ``dense_mixture``: the oracle, every expert computes every token and
  the router's weights mix them (E/k times the operations).

Everything on the routed path has static shapes and reads nothing on
the host, so a step captures into a CUDA graph: the capacity is a
Python int of the token count, expert loads are counted with a
``scatter_add_`` (``torch.bincount`` reads its max on the host), and
slots past an expert's capacity go to a spare row that is cut off.
Padding positions and idle decode rows are routed like any token and
take capacity, as in the reference.  ``top_k`` breaks ties toward the
lower expert index, as ``jax.lax.top_k`` does, and the sort is stable,
so the same slots are dropped as in the reference.

``moe_impl="ep_a2a"``: the expert-parallel dispatch of
:mod:`repro_torch.models.moe_ep` (token all-to-alls along the mesh's
"model" axis), the routed path when there is no ambient mesh.

On DTensors under an ambient mesh the dispatch buffers carry the
reference's layout constraints (``layers.constrain``): token-indexed
arrays over the FSDP axes, the expert buffer over "model" on E and the
FSDP axes on the capacity.  Plain tensors pass through untouched.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import exponential_quant as eq
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.lut_dequant_matmul.ref import apply_activation
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec

F32 = torch.float32


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), "scaled"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp"), "scaled",
                            fan_in_axis=1),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", "mlp"), "scaled",
                          fan_in_axis=1),
        "w_down": ParamSpec((e, f, d), ("experts", "mlp", "embed"), "scaled",
                            fan_in_axis=1),
    }


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    cap = int(tokens * cfg.experts_per_token * cfg.capacity_factor
              / cfg.num_experts)
    return max(128, -(-cap // 128) * 128)  # pad to a lane-friendly multiple


# ------------------------------------------------------------- router --

def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` on the last axis: the k largest, largest first,
    ties to the lower index (a stable descending sort; ``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, xf: torch.Tensor, cfg: ModelConfig):
    """(probs [T, E], top_w [T, k] renormalised, top_e [T, k], aux): the
    softmax router on a float weight and the Switch/GShard
    load-balancing loss.  Its matmul runs at full float32 (PyTorch's
    default): a TF32 product would move top-k choices, so a caller that
    turned TF32 on for float32 matmuls is refused on the card."""
    if xf.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router needs full float32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")
    logits = ll.dense(xf, p["router"], dtype=F32)
    probs = torch.softmax(logits.to(F32), dim=-1)
    top_w, top_e = top_k(probs, cfg.experts_per_token)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    e = cfg.num_experts
    first = xf.new_zeros(e, dtype=F32).scatter_add_(
        0, top_e[:, 0], xf.new_ones(top_e.shape[0], dtype=F32))
    density = first / top_e.shape[0]
    aux = e * torch.sum(density * probs.mean(0))
    return probs, top_w, top_e, aux


# ------------------------------------------------------------ experts --

def _expert_ffn(p, buf: torch.Tensor, cfg: ModelConfig,
                act_q: dict | None = None) -> torch.Tensor:
    """buf [E, C, D] -> [E, C, D] through each expert's gated MLP: three
    einsums over the experts axis.  With ``act_q`` the buffer is encoded
    once at the mlp_in site, so gate and up read codes (the dual
    kernel); the expert intermediate stays float (no per-expert mlp_mid
    site, as in the reference)."""
    bufq = ll.maybe_encode_act(buf, act_q, "mlp_in")
    g = ll.dense_general(bufq, p["w_gate"], "ecd,edf->ecf", dtype=F32)
    u = ll.dense_general(bufq, p["w_up"], "ecd,edf->ecf", dtype=F32)
    h = (apply_activation(g, cfg.activation) * u).to(buf.dtype)
    return ll.dense_general(h, p["w_down"], "ecf,efd->ecd",
                            dtype=F32).to(buf.dtype)


def apply_moe_routed(p, x: torch.Tensor, cfg: ModelConfig,
                     act_q: dict | None = None,
                     counts: torch.Tensor | None = None):
    """Sort-based capacity-dropped dispatch.  x [B, S, D]; returns (y [B,
    S, D], aux).  ``counts``, an int64 ``[3]`` device tally (the paged
    cache's :attr:`~repro_torch.runtime.paged_cache.PagedKVCache.moe_counts`),
    gains (1 call, the slots routed, the slots dropped past capacity) in
    place, with no host read, so a captured step adds to it on every
    replay."""
    b, s, d = x.shape
    t = b * s
    k = cfg.experts_per_token
    e = cfg.num_experts
    dev = x.device
    xf = L.constrain(x.reshape(t, d), "fsdp", None)

    _, top_w, top_e, aux = _router(p, xf, cfg)

    flat_e = top_e.reshape(t * k)                      # expert of each slot
    flat_w = top_w.reshape(t * k)
    slot = torch.arange(t * k, device=dev)
    slot_tok = slot // k                               # token of each slot

    order = torch.sort(flat_e, stable=True).indices    # group slots by expert
    sorted_e = flat_e[order]
    load = flat_e.new_zeros(e).scatter_add_(0, flat_e,
                                             torch.ones_like(flat_e))
    starts = torch.cumsum(load, 0) - load
    within = slot - starts[sorted_e]

    cap = _capacity(cfg, t)
    keep = within < cap
    dest = torch.where(keep, sorted_e * cap + within, e * cap)  # drop slot
    src_tok = slot_tok[order]
    if counts is not None:
        counts.add_(torch.stack([
            torch.ones((), dtype=torch.int64, device=dev),
            torch.full((), t * k, dtype=torch.int64, device=dev),
            (~keep).sum()]))

    buf = xf.new_zeros(e * cap + 1, d)
    buf.index_put_((dest,), xf[src_tok])
    buf = L.constrain(buf[: e * cap].reshape(e, cap, d),
                     "model", "fsdp", None)
    out_buf = L.constrain(_expert_ffn(p, buf, cfg, act_q=act_q),
                         "model", "fsdp", None)
    out_flat = torch.cat([out_buf.reshape(e * cap, d), xf.new_zeros(1, d)])

    y_slots = out_flat[dest] * flat_w[order][:, None].to(x.dtype)
    # out of place: DTensor's in-place index_add_ may change the
    # placement its output reports
    y = xf.new_zeros(t, d).index_add(0, src_tok, y_slots)
    return L.constrain(y, "fsdp", None).reshape(b, s, d), aux


def _expert(w, i: int):
    """Expert ``i``'s weight: a carrier over its code slab and the
    layer's one table (the decode stays in the kernel), or the float
    slice."""
    if isinstance(w, eq.QWeight):
        return eq.QWeight(w.codes[i], w.lut, w.qmeta)
    return w[i]


def apply_moe_dense(p, x: torch.Tensor, cfg: ModelConfig,
                    act_q: dict | None = None):
    """The oracle: every expert computes every token (a loop over E, the
    reference's scan), through the gated kernel and the down projection
    an expert, mixed by the router's top-k weights.  With ``act_q`` the
    tokens are encoded once at the mlp_in site and every expert's gated
    kernel reads the same codes."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs, top_w, top_e, aux = _router(p, xf, cfg)
    xq = ll.maybe_encode_act(xf, act_q, "mlp_in")
    # sparse mixture weights [T, E] (zeros off the top-k support)
    w = torch.zeros_like(probs).scatter_(1, top_e, top_w)
    y = torch.zeros(t, d, dtype=xf.dtype, device=x.device)
    for i in range(cfg.num_experts):
        h = ll.gated_mlp(xq, _expert(p["w_gate"], i), _expert(p["w_up"], i),
                         cfg.activation, dtype=xf.dtype)
        yi = ll.dense(h, _expert(p["w_down"], i), dtype=xf.dtype)
        y = y + yi * w[:, i, None].to(xf.dtype)
    return y.reshape(b, s, d), aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              act_q: dict | None = None, counts: torch.Tensor | None = None):
    """The layer ``cfg.moe_impl`` names; ``counts`` as in
    :func:`apply_moe_routed` (the dense mixture drops nothing and leaves
    it alone)."""
    if cfg.moe_impl == "ep_a2a":
        from repro_torch.models.moe_ep import apply_moe_ep

        # the EP body manages its own dispatch buffers; activation codes
        # and the capacity tally stop at its boundary, as in the
        # reference
        return apply_moe_ep(p, x, cfg)
    if cfg.moe_impl == "routed":
        return apply_moe_routed(p, x, cfg, act_q=act_q, counts=counts)
    return apply_moe_dense(p, x, cfg, act_q=act_q)
