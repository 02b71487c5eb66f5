"""LR schedules (port of the JAX package's ``optim/schedule.py``): cosine
(the default) and WSD (warmup-stable-decay), the MiniCPM schedule
[arXiv:2404.06395] the launcher selects for minicpm-2b.  Both compute
in float32, as the reference's, on the step's device; ``step`` is an
int or a 0-d tensor (the optimizer's step on the card)."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(F32)
    return torch.tensor(step, dtype=F32)


def cosine(step, base_lr: float, warmup: int, total: int,
           min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then a cosine decay to ``min_frac``
    of it at ``total``."""
    step = _step(step)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, base_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, min_frac: float = 0.01) -> torch.Tensor:
    """Warmup, then a stable plateau at ``base_lr``, then an exponential
    decay to ``min_frac`` of it over the last ``decay_frac`` of the
    steps."""
    step = _step(step)
    decay_steps = torch.tensor(max(total * decay_frac, 1.0), dtype=F32,
                               device=step.device)
    decay_start = total - decay_steps
    warm = base_lr * step / max(warmup, 1)
    tail_prog = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
    tail = base_lr * torch.pow(min_frac, tail_prog)
    plateau = torch.full_like(step, base_lr)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, plateau, tail))


def get_schedule(name: str):
    return {"cosine": cosine, "wsd": wsd}[name]
