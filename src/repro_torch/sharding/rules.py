"""Logical-axis -> mesh-axis resolution (port of the JAX package's
``sharding/rules.py``, MaxText-style rule lists).

A *ruleset* is an ordered list of (logical_axis, mesh_axes) pairs.  For
each tensor the rules are walked in priority order and mesh axes are
assigned to matching logical axes, subject to (a) each mesh axis used
at most once per tensor and (b) divisibility of the dimension by the
mesh-axis size.  Failed assignments fall through, which implements e.g.
the GQA fallback: ``kv_heads=8`` can't shard over model=16, so the
later ("head", "model") rule claims the head_dim instead.

Modes:
* ``train``: FSDP(+pod) on ``embed``/params + TP on the model axis;
  batch over (pod, data).
* ``serve``: the same TP; params FSDP'd unless ``SERVE_PARAM_FSDP`` is
  off; KV caches sharded over batch and the sequence (or heads /
  head_dim with ``SERVE_SEQ_SHARD`` off).

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry
a dimension: ``None`` or a tuple of mesh-axis names (``()`` below the
rank gate).  :func:`placements` turns one into DTensor placements on a
``DeviceMesh``.  A mesh is a ``DeviceMesh`` or a
:class:`~repro_torch.launch.mesh.MeshShape` (anything with a ``shape``
dict of axis sizes).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.launch.mesh import axis_sizes


def _fsdp_axes(sizes: dict) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in sizes)


# Serving: shard the KV cache's *sequence* over the model axis
# (flash-decoding / split-K); off, kv_heads / head_dim take it.
SERVE_SEQ_SHARD = True

# Serving: ZeRO-style FSDP weights (all-gathered a layer); off, weights
# are TP-only (replicated over the data axes).
SERVE_PARAM_FSDP = True


def set_serve_seq_shard(enable: bool) -> None:
    global SERVE_SEQ_SHARD
    SERVE_SEQ_SHARD = enable


def set_serve_param_fsdp(enable: bool) -> None:
    global SERVE_PARAM_FSDP
    SERVE_PARAM_FSDP = enable


# Context-parallel training: no tensor parallelism; activations shard
# their sequence over "model" (``layers.CONTEXT_PARALLEL``) and params
# FSDP over every mesh axis (2-D ZeRO-3).
TRAIN_CP = False


def set_train_cp(enable: bool) -> None:
    global TRAIN_CP
    TRAIN_CP = enable


def ruleset(mesh, mode: str) -> list[tuple[str, tuple[str, ...]]]:
    fsdp = _fsdp_axes(axis_sizes(mesh))
    serve_seq = mode == "serve" and SERVE_SEQ_SHARD
    if TRAIN_CP:   # context-parallel: same placement for train + prefill
        return [
            ("batch", fsdp),
            ("cache_batch", fsdp),
            ("cache_seq", ("model",)),
            ("vocab", ("model",)),          # keep vocab TP'd (logits/embed)
            ("embed", fsdp + ("model",)),   # 2-D FSDP storage
            ("act_seq", ("model",)),
        ]
    rules = [
        ("batch", fsdp),
        ("cache_batch", fsdp),
        ("expert_capacity", fsdp),
        # split-K cache sharding claims the model axis ahead of heads
        ("cache_seq", ("model",) if serve_seq else
         (fsdp if mode == "serve" else ())),
        ("vocab", ("model",)),
        ("experts", ("model",)),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("heads_mix", ("model",)),
        ("mlp", ("model",)),
        ("head", ("model",)),
        ("rwkv_k", ("model",)),
        # FSDP / ZeRO-3 on params (optionally off at serve)
        ("embed", fsdp if (mode != "serve" or SERVE_PARAM_FSDP) else ()),
        ("act_seq", ()),
    ]
    return [(k, v) for k, v in rules if v]


def spec_for(shape: tuple[int, ...], axes: tuple, mesh, mode: str = "train",
             min_shard_rank: int = 1) -> tuple:
    """Resolve one tensor's logical axes to a spec (a tuple, one entry a
    dimension: ``None`` or the mesh axes sharding it)."""
    if len(shape) < min_shard_rank:
        return ()
    sizes = axis_sizes(mesh)
    assignment: list = [None] * len(shape)
    used: set[str] = set()
    for logical, mesh_axes in ruleset(mesh, mode):
        for dim, ax in enumerate(axes):
            if ax != logical or assignment[dim] is not None:
                continue
            size = 1
            chosen = []
            for m in (m for m in mesh_axes if m not in used):
                if shape[dim] % (size * sizes[m]) == 0:
                    chosen.append(m)
                    size *= sizes[m]
            if chosen:
                assignment[dim] = tuple(chosen)
                used.update(chosen)
    return tuple(assignment)


def map_leaves(fn, tree, other):
    """``fn(leaf, its node of other)`` over ``tree``'s leaves (nested
    dicts and NamedTuples); ``other`` has ``tree``'s structure down to
    them (an axes tuple or a spec a leaf)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v, o)
                            for v, o in zip(tree, other)))
    return fn(tree, other)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def tree_shardings(abstract_tree, axes_tree, mesh, mode: str = "train",
                   params_rank_gate: bool = True):
    """The spec tree of an abstract tree (``meta`` tensors, or anything
    with a ``shape``) and its logical-axes tree: ``()`` where the axes
    are ``None``; rank-0/1 tensors (norm scales, biases) replicated
    under ``params_rank_gate`` instead of many tiny all-gathers."""
    gate = 2 if params_rank_gate else 1

    def leaf(ab, axes):
        if axes is None:
            return ()
        return spec_for(tuple(ab.shape), axes, mesh, mode,
                        min_shard_rank=gate)

    return map_leaves(leaf, abstract_tree, axes_tree)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): one
    a mesh dimension, ``Shard(d)`` on each axis that shards tensor
    dimension ``d`` (a dimension two axes shard takes ``Shard(d)`` on
    each, in order), ``Replicate()`` elsewhere.  An axis of size 1
    shards nothing and is ``Replicate()``: the same layout, which
    DTensor handles on every op."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, ax in enumerate(spec):
        for name in ax or ():
            if sizes[name] > 1:
                out[mesh.mesh_dim_names.index(name)] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor's shards live: a ``DeviceMesh`` and a spec (the
    reference's ``NamedSharding``).  ``mesh=None`` means a plain tensor,
    not a DTensor (the AdamW step counter, kept on every rank)."""
    mesh: Any
    spec: tuple = ()

    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def named_shardings(abstract_tree, spec_tree, mesh):
    """The :class:`NamedSharding` tree of a spec tree on ``mesh``."""
    return map_leaves(lambda _, spec: NamedSharding(mesh, spec),
                      abstract_tree, spec_tree)


def distribute(t, sharding: NamedSharding):
    """A DTensor laid out by ``sharding`` from ``t``, the full tensor
    every rank holds: each rank keeps its own shards, nothing moves.  A
    plain ``t`` for ``mesh=None``."""
    if sharding.mesh is None:
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements(),
                             src_data_rank=None)


def local_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """The per-device shape of a ``shape`` tensor laid out by ``spec``
    (every sharded dimension divides evenly, as ``spec_for`` ensures)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, ax in enumerate(spec):
        for name in ax or ():
            out[d] //= sizes[name]
    return tuple(out)


# ------------------------------------------------------------------------
# Cache logical axes: pattern-matched on leaf path/rank so every model
# family's cache tree gets coherent shardings without per-model tables.
# ------------------------------------------------------------------------

def _cache_leaf_axes(name: str, leaf) -> tuple | None:
    nd = len(leaf.shape)
    if name in ("k", "v", "xk", "xv"):
        if nd == 5:   # [layers, B, S, kv, hd]
            return ("layers", "cache_batch", "cache_seq", "kv_heads", "head")
        if nd == 4:   # window ring [B, W, kv, hd]
            return ("cache_batch", "cache_seq", "kv_heads", "head")
    if name == "kpos":
        return (None,) * nd
    if name == "wkv":      # [layers, B, H, K, V]
        return ("layers", "cache_batch", "rwkv_heads", "rwkv_k", None)
    if name in ("tshift_t", "tshift_c"):   # [layers, B, D]
        return ("layers", "cache_batch", "embed")
    if name == "conv":     # [B, W-1, Dr]
        return ("cache_batch", None, "mlp")
    if name == "h":        # [B, Dr]
        return ("cache_batch", "mlp")
    if name == "pos":
        return ()
    return (None,) * nd


def cache_logical_axes(abstract_cache):
    return _map_with_path(
        lambda path, leaf: _cache_leaf_axes(str(path[-1]), leaf),
        abstract_cache)


def batch_logical_axes(abstract_batch):
    def leaf(path, ab):
        nd = len(ab.shape)
        return ("batch",) + (None,) * (nd - 1) if nd >= 1 else ()
    return _map_with_path(leaf, abstract_batch)
