"""Expert-parallel MoE dispatch with explicit all-to-alls (port of the
JAX package's ``models/moe_ep.py``; ``moe_impl="ep_a2a"``).

Layout (requires ``num_experts % model_axis == 0``; exact for llama4's
16 experts on a 16-way axis, one expert a model rank):

* tokens live on their rank (the caller's ``x`` is this rank's rows);
* expert weights split over the mesh's "model" axis on the expert axis
  (a rank holds experts ``[r * e_loc, (r + 1) * e_loc)``);
* each rank sorts its (token, choice) slots stably by destination rank,
  packs a fixed-capacity ``[ranks, cap, d]`` buffer, and an
  ``all_to_all_single`` on the "model" group moves the tokens (and their
  local expert ids) to their experts;
* the expert FFN runs rank-locally, and a second all-to-all returns the
  results.

Numerically the capacity-dropped routed path up to which slots are
dropped when a capacity binds (both drop by position order; the
capacities differ: ``cap`` here is a destination rank's).  With no
ambient mesh (``launch.mesh.use_mesh``), a mesh without a "model" axis,
or ``num_experts % model != 0``, the routed path runs instead, as in
the reference.

The ambient mesh is a ``DeviceMesh``.  Plain tensors are this rank's:
``x`` its tokens, each expert weight either the full ``[E, ...]`` stack
(this rank's experts are sliced out) or this rank's ``[e_loc, ...]``
slab.  DTensors (the dry run's) are laid out first: ``x`` batch over
the FSDP axes (and the sequence over "model" under context
parallelism), the expert weights ``Shard(0)`` on "model", the router
replicated.  On ``meta`` tensors the all-to-alls move nothing and only
their bytes are counted (:func:`count_all_to_all`): a CPU mesh's DTensor
emulates an all-to-all with an all-gather, so the dry run counts these
from the buffers' shapes.

Slots per destination rank are counted with a ``scatter_add_`` (never
``torch.bincount``, which reads its maximum on the host).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import exponential_quant as eq
from repro_torch.core import lama_layers as ll
from repro_torch.kernels.lut_dequant_matmul.ref import apply_activation

_A2A: list = []


@contextlib.contextmanager
def count_all_to_all():
    """Tally ``{"count", "bytes"}`` of the all-to-alls run inside the
    block (the bytes a rank sends)."""
    tally = {"count": 0, "bytes": 0}
    _A2A.append(tally)
    try:
        yield tally
    finally:
        _A2A.pop()


def _mesh_info():
    from repro_torch.launch.mesh import get_abstract_mesh

    mesh = get_abstract_mesh()
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh if "model" in names else None


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """``send`` [ranks * cap, ...]: chunk i goes to rank i; returns the
    chunks received, chunk i from rank i (differentiable when ``send``
    requires grad).  On ``meta`` it only keeps the shape."""
    for tally in _A2A:
        tally["count"] += 1
        tally["bytes"] += send.numel() * send.element_size()
    if send.is_meta:
        return send.clone()          # the shape; autograd still flows
    if send.requires_grad and torch.is_grad_enabled():
        from torch.distributed._functional_collectives import \
            all_to_all_single_autograd

        return all_to_all_single_autograd(send.contiguous(), None, None,
                                          group)
    import torch.distributed as dist

    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    return recv


def _local_experts(w, rank: int, e_loc: int, e: int):
    """This rank's ``[e_loc, ...]`` slab of an expert stack: a plain
    tensor or ``QWeight`` holding all ``e`` experts is sliced; a slab
    is taken as it is."""
    codes = w.codes if isinstance(w, eq.QWeight) else w
    if codes.shape[0] == e_loc:
        return w
    if codes.shape[0] != e:
        raise ValueError(f"an expert stack of {codes.shape[0]} is neither "
                         f"the {e} experts nor a rank's {e_loc}")
    sl = slice(rank * e_loc, (rank + 1) * e_loc)
    if isinstance(w, eq.QWeight):
        return eq.QWeight(w.codes[sl], w.lut, w.qmeta)
    return w[sl]


def _expert0(w, dtype):
    """The one local expert's weight: a carrier over its code slab (the
    decode stays in the kernel), or the float slice in ``dtype``."""
    if isinstance(w, eq.QWeight):
        return eq.QWeight(w.codes[0], w.lut, w.qmeta)
    return ll.materialize(w, dtype)[0]


def _local_moe(p, x_loc: torch.Tensor, cfg: ModelConfig, ranks: int,
               group):
    """The per-rank body.  ``x_loc`` [b, s, d] this rank's tokens, ``p``
    the router and this rank's expert slabs.  Returns (y [b, s, d], the
    load-balancing loss averaged over the "model" ranks)."""
    from repro_torch.models.moe import _router

    bl, sl, d = x_loc.shape
    t = bl * sl
    k = cfg.experts_per_token
    e_loc = cfg.num_experts // ranks
    dev = x_loc.device
    xf = x_loc.reshape(t, d)

    _, top_w, top_e, aux = _router(p, xf, cfg)
    if not aux.is_meta:
        import torch.distributed as dist

        aux = aux.clone()
        dist.all_reduce(aux, group=group)
        aux = aux / ranks

    flat_e = top_e.reshape(t * k)
    flat_w = top_w.reshape(t * k)
    slot = torch.arange(t * k, device=dev)
    slot_tok = slot // k
    dest_rank = flat_e // e_loc                       # owning model rank

    order = torch.sort(dest_rank, stable=True).indices  # group by rank
    sorted_rank = dest_rank[order]
    counts = torch.zeros(ranks, dtype=torch.int64, device=dev).scatter_add_(
        0, dest_rank, torch.ones_like(dest_rank))
    starts = torch.cumsum(counts, 0) - counts
    within = slot - starts[sorted_rank]

    cap = max(128, -(-int(t * k * cfg.capacity_factor / ranks) // 128) * 128)
    keep = within < cap
    send_slot = torch.where(keep, sorted_rank * cap + within, ranks * cap)
    src_tok = slot_tok[order]

    # pack [ranks * cap (+1 drop row), d], then all-to-all along "model"
    send = torch.zeros(ranks * cap + 1, d, dtype=x_loc.dtype, device=dev)
    send.index_put_((send_slot,), xf[src_tok])
    send_e = torch.zeros(ranks * cap + 1, dtype=torch.int64, device=dev)
    send_e.index_put_((send_slot,), flat_e[order] % e_loc)
    toks = _all_to_all(send[: ranks * cap], group)    # [ranks * cap, d]
    recv_e = _all_to_all(send_e[: ranks * cap], group)

    # the rank-local expert FFN (e_loc == 1 for llama4 on 16 ranks)
    if e_loc == 1:
        # one local expert: the fused (gated) kernels on its codes,
        # nothing materialised
        h = ll.gated_mlp(toks, _expert0(p["w_gate"], toks.dtype),
                         _expert0(p["w_up"], toks.dtype), cfg.activation,
                         dtype=toks.dtype)
        out_toks = ll.dense(h, _expert0(p["w_down"], toks.dtype),
                            dtype=toks.dtype)
    else:
        wg = ll.materialize(p["w_gate"], toks.dtype)   # [e_loc, d, f]
        wu = ll.materialize(p["w_up"], toks.dtype)
        wd = ll.materialize(p["w_down"], toks.dtype)
        onehot = torch.nn.functional.one_hot(recv_e, e_loc).to(toks.dtype)
        # the reference's one-hot einsums ("td,edf,te->tf"), contracted
        # token by expert first: never a [t, e, d, f] intermediate
        xe = toks[:, None, :] * onehot[:, :, None]                 # [t, e, d]
        g = torch.einsum("ted,edf->tf", xe, wg)
        u = torch.einsum("ted,edf->tf", xe, wu)
        he = (apply_activation(g, cfg.activation) * u)[:, None, :] \
            * onehot[:, :, None]                                   # [t, e, f]
        out_toks = torch.einsum("tef,efd->td", he, wd)

    back = _all_to_all(out_toks, group)
    back = torch.cat([back, torch.zeros(1, d, dtype=x_loc.dtype,
                                        device=dev)])
    y_slots = back[send_slot] * flat_w[order][:, None].to(x_loc.dtype)
    y = torch.zeros(t, d, dtype=x_loc.dtype, device=dev).index_add_(
        0, src_tok, y_slots)
    return y.reshape(bl, sl, d), aux


_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _laid_out(p, x, mesh, seq_sharded: bool):
    """DTensor inputs as this rank's local tensors, with the placements
    the output takes."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    fsdp = [a for a in ("pod", "data") if a in names]
    xpl = [Shard(0) if a in fsdp else
           Shard(1) if a == "model" and seq_sharded else Replicate()
           for a in names]
    wpl = [Shard(0) if a == "model" else Replicate() for a in names]

    def local(t, pl):
        if type(t).__name__ != "DTensor":
            return t
        return t.redistribute(mesh, pl).to_local()

    def leaf(name, w):
        pl = wpl if name in _EXPERT_LEAVES else [Replicate()] * len(names)
        if isinstance(w, eq.QWeight):
            return eq.QWeight(local(w.codes, pl), local(w.lut, [Replicate()]
                                                        * len(names)),
                              local(w.qmeta, [Replicate()] * len(names)))
        return local(w, pl)

    return ({k: leaf(k, v) for k, v in p.items()}, local(x, xpl), xpl)


def apply_moe_ep(p, x: torch.Tensor, cfg: ModelConfig):
    """The expert-parallel dispatch on the ambient mesh's "model" group;
    the routed path where the mesh or the expert count does not allow
    it (grok-1's 8 experts on a 16-way axis, or no mesh).  Returns (y,
    aux) as ``apply_moe_routed``."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M

    mesh = _mesh_info()
    if mesh is None:
        return M.apply_moe_routed(p, x, cfg)
    ranks = mesh.size(mesh.mesh_dim_names.index("model"))
    if cfg.num_experts % ranks != 0:
        return M.apply_moe_routed(p, x, cfg)
    rank = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    e_loc = cfg.num_experts // ranks
    is_dt = type(x).__name__ == "DTensor"
    seq_sharded = L.CONTEXT_PARALLEL and x.shape[1] % ranks == 0
    if is_dt:
        p, x, xpl = _laid_out(p, x, mesh, seq_sharded)
    local = {k: (_local_experts(v, rank, e_loc, cfg.num_experts)
                 if k in _EXPERT_LEAVES else v) for k, v in p.items()}
    y, aux = _local_moe(local, x, cfg, ranks, group)
    if is_dt:
        from torch.distributed.tensor import DTensor, Replicate

        y = DTensor.from_local(y, mesh, xpl, run_check=False)
        aux = DTensor.from_local(aux, mesh,
                                 [Replicate()] * len(mesh.mesh_dim_names),
                                 run_check=False)
    return y, aux
