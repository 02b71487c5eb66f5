"""Int8 gradient compression (port of the JAX package's
``optim/compress.py``): a tensor as int8 with one per-tensor max-abs
scale.  The reference sums such payloads across pods inside a
``shard_map`` (``compressed_psum``); the port has no process group yet,
so only the encoding is here (ROADMAP Queue 1 item 13, the sharding
bullet)."""

from __future__ import annotations

import torch


def int8_encode(x: torch.Tensor):
    """(int8 codes, the float32 scale): ``round(x / scale)`` clipped to
    +-127, ``scale = max|x| / 127 + 1e-30`` (rounding half to even, as
    ``jnp.round``)."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
