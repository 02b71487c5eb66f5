"""AdamW with global-norm clipping (port of the JAX package's
``optim/adamw.py``): a function over trees of tensors, the optimizer
state shaped like the parameters.

Written as the reference's function, not through ``torch.optim.AdamW``
and ``clip_grad_norm_``: their clip epsilon (1e-6, against 1e-9 here)
and their rounding differ.  The moments are float32; each update is
computed in float32 and cast to its parameter's dtype; weight decay
applies to tensors of ``ndim >= 2`` only (norm scales and biases are
exempt).  Trees flatten in the reference's order
(:mod:`repro_torch.tree`), so the global norm sums its leaves in the
same order."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, the updates taken
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Zero moments in float32 beside each parameter, step 0, on the
    parameters' device."""
    ps = T.leaves(params)
    dev = ps[0].device if ps else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=T.tree_map(lambda p: torch.zeros_like(p, dtype=F32), params),
        nu=T.tree_map(lambda p: torch.zeros_like(p, dtype=F32), params))


def abstract_state(abstract_params) -> AdamWState:
    """The state's shapes and dtypes as ``meta`` tensors (the moments
    float32, ``step`` a 0-d int32)."""
    def f32(p):
        return torch.empty(p.shape, dtype=F32, device="meta")

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=T.tree_map(f32, abstract_params),
                      nu=T.tree_map(f32, abstract_params))


def global_norm(tree) -> torch.Tensor:
    """The float32 2-norm of every leaf together, the leaves' squared
    sums added in tree order."""
    total = 0
    for leaf in T.leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(F32)))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(grads, max_norm: float):
    """(``grads`` scaled so their global norm is at most ``max_norm``,
    the norm before the clip)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return T.tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def update(grads, state: AdamWState, params, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           max_grad_norm: float = 1.0):
    """One step.  Returns (new params, new state, ``{"grad_norm"}``),
    new tensors in the trees' structure; nothing given is written."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)

    def upd(g, m, v, p):
        g = g.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if p.ndim >= 2:  # decay matrices only (norm/bias exempt)
            delta = delta + weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        T.leaves(grads), T.leaves(state.mu), T.leaves(state.nu),
        T.leaves(params))]
    new_p = T.unflatten(params, [o[0] for o in out])
    new_m = T.unflatten(params, [o[1] for o in out])
    new_v = T.unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
