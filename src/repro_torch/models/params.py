"""Parameter specs and the module that holds a params tree (port of the
JAX package's ``models/params.py``).

Models declare a nested dict of :class:`ParamSpec` (shape, logical axis
names, initializer).  Per-layer parameters are stacked along a leading
``"layers"`` axis, as in the reference; where the reference scans over
that axis (``scan_blocks``), the port loops over the layer index in
Python.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.core.exponential_quant import QWeight


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones | embed | scaled
    scale: float | None = None    # stddev override (normal/scaled)
    fan_in_axis: int | None = None  # for 'scaled': 1/sqrt(fan_in)
    dtype: Any = None             # override model param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _map(fn, specs):
    if isinstance(specs, dict):
        return {k: _map(fn, v) for k, v in specs.items()}
    return fn(specs)


def stacked(spec: ParamSpec, num_layers: int) -> ParamSpec:
    """Add the leading layers axis."""
    return dataclasses.replace(spec, shape=(num_layers, *spec.shape),
                               axes=("layers", *spec.axes))


def stack_specs(specs, num_layers: int):
    return _map(lambda s: stacked(s, num_layers), specs)


def logical_axes(specs):
    """Nested dict of logical-axis tuples, the same structure as params."""
    return _map(lambda s: s.axes, specs)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device,
               dtype) -> torch.Tensor:
    dtype = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed"):
        std = spec.scale if spec.scale is not None else 0.02
    elif spec.init == "scaled":
        fan_axis = spec.fan_in_axis if spec.fan_in_axis is not None else -2
        fan_in = spec.shape[fan_axis] if len(spec.shape) > 1 else spec.shape[0]
        std = (spec.scale or 1.0) / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(specs, gen: torch.Generator, device, dtype=torch.float32):
    """Materialize the spec tree on ``device``, drawing every leaf from
    ``gen`` in tree order (the generator must live on ``device``)."""
    return _map(lambda s: _init_leaf(s, gen, device, dtype), specs)


class ParamTree(nn.Module):
    """A nested dict of tensors and :class:`QWeight` leaves as a module:
    dict nodes become submodules, tensors become buffers, so
    ``named_buffers()`` mirrors the reference's params tree path for
    path (``blocks.attn.wq.codes`` for a quantized ``wq``).  ``p["wq"]``
    indexes like the dict it came from."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, QWeight):
                self.add_module(k, v)
            else:
                self.register_buffer(k, v)

    def __getitem__(self, key: str):
        return getattr(self, key)

    def tree(self) -> dict:
        """The nested dict view (the leaves themselves, not copies)."""
        out = {}
        for k, v in self._buffers.items():
            out[k] = v
        for k, v in self._modules.items():
            out[k] = v if isinstance(v, QWeight) else v.tree()
        return out


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked subtree (views, no copies)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = layer_slice(v, i)
        elif isinstance(v, QWeight):
            out[k] = v.layer(i)
        else:
            out[k] = v[i]
    return out
