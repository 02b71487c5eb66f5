"""Int8 gradient compression for the cross-pod reduction (port of the
JAX package's ``optim/compress.py``): a tensor as int8 with one
per-tensor max-abs scale, and the all-reduce that moves such payloads.

Within a pod gradients reduce in full precision; across pods each
tensor is quantized to int8 with the max-abs scale shared by every
rank, summed, and dequantized.  The reference sums inside a
``shard_map`` over the pod axis; here the sums run on a
``torch.distributed`` group (a ``DeviceMesh`` axis's
``mesh.get_group("pod")``, or any group).  Neither launcher has a flag
for it: the reference's ``launch/train.py`` names one only in this
docstring."""

from __future__ import annotations

import torch

F32 = torch.float32


def int8_encode(x: torch.Tensor):
    """(int8 codes, the float32 scale): ``round(x / scale)`` clipped to
    +-127, ``scale = max|x| / 127 + 1e-30`` (rounding half to even, as
    ``jnp.round``)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce ``x`` over ``group`` (default: the world) moving int8
    codes and one scale: the scale ``max|x| / 127 + 1e-30`` reduced by
    MAX, so every rank shares it; ``round(x / scale)`` clipped to +-127;
    a SUM of the codes as int32 (no overflow past 127 ranks); times the
    scale.  The sum of the dequantized terms is then the dequantized sum.
    Returns a new float32 tensor; ``x`` is not written."""
    import torch.distributed as dist

    scale = (torch.max(torch.abs(x)) / 127.0 + 1e-30).reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(F32) * scale.reshape(())


def compressed_tree_psum(tree, group=None):
    """:func:`compressed_psum` of every leaf, each cast to float32."""
    from repro_torch import tree as T

    return T.tree_map(lambda g: compressed_psum(g.to(F32), group), tree)
