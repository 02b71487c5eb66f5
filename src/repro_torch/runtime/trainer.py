"""Training loop (port of the JAX package's ``runtime/trainer.py``), on
one device: the LR schedule, AdamW, restart-stable data, atomic
checkpoints and resume, the straggler watchdog and preemption.

A step is the reference's: the loss of ``models.api.loss_fn``, its
gradient (autograd, where the reference takes ``jax.grad``), then
``optim.adamw.update`` at the learning rate of the optimizer's step
*before* it advances (so step 0 runs at lr 0 under warmup).  Where
``cfg.remat == "block"`` (the full configs' default) each block's
activations are recomputed in the backward pass
(``layers.remat``, the reference's ``jax.checkpoint(blk)``).  No
Pallas kernel runs: the parameters are float, and ``lama_layers``
reaches the LUT GEMMs only for quantized weights.

The parameters are float tensors that require grad, held by the
family's params module (its buffers are those very tensors), so every
family's ``forward`` differentiates as it serves.  There is no mesh:
the reference's sharding trees are ROADMAP Queue 1 item 13's sharding
bullet.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import tree as T
from repro_torch._device import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import api as mapi
from repro_torch.optim import adamw, schedule as sched
from repro_torch.runtime.fault_tolerance import (PreemptionSignal,
                                                 StragglerWatchdog)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup: int = 10
    schedule: str = "cosine"          # cosine | wsd (minicpm)
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep: int = 3
    seed: int = 0
    log_every: int = 10
    preempt_flag: str | None = None


class Trainer:
    """``Trainer(cfg, tcfg).run()`` on the card unless ``device="cpu"``.
    ``params``: the initial parameters (a nested dict of float tensors or
    a params module, e.g. the reference's carried across by
    ``convert.params_from_jax``); by default they are drawn from
    ``tcfg.seed`` by the family's module.  A checkpoint under
    ``tcfg.ckpt_dir`` wins over either."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device=None,
                 params=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.api = mapi.get_model(cfg)
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, global_batch=tcfg.global_batch,
            seq_len=tcfg.seq_len, seed=tcfg.seed))
        self.watchdog = StragglerWatchdog()
        self.preempt = PreemptionSignal(tcfg.preempt_flag)
        self.initial = params

    # ------------------------------------------------------------------
    def _lr(self, step):
        fn = sched.get_schedule(self.tcfg.schedule)
        return fn(step, self.tcfg.lr, self.tcfg.warmup, self.tcfg.steps)

    def _module(self, tree: dict):
        """The family's module over ``tree``'s own tensors."""
        return self.api.module(self.cfg, tree, device=self.device)

    def step(self, params: dict, opt: adamw.AdamWState, batch: dict):
        """One training step on ``params`` (a nested dict of tensors that
        require grad), written in place.  Returns (the new optimizer
        state, the metrics: the loss's, ``grad_norm`` and ``lr``)."""
        grads, metrics = self.loss_and_grads(params, batch)
        return self.apply(params, opt, grads, metrics)

    def loss_and_grads(self, params: dict, batch: dict):
        """(the gradient tree of ``params``, the loss's metrics)."""
        total, metrics = mapi.loss_fn(self.api, self._module(params), batch)
        grads = torch.autograd.grad(total, T.leaves(params))
        return (T.unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def apply(self, params: dict, opt: adamw.AdamWState, grads,
              metrics: dict):
        """AdamW on ``params`` in place at the lr of ``opt``'s step; the
        step's half after the gradients.  Returns (the new optimizer
        state, ``metrics`` with ``grad_norm`` and ``lr``)."""
        tcfg = self.tcfg
        lr = self._lr(opt.step)
        new_p, new_o, om = adamw.update(
            grads, opt, params, lr=lr, weight_decay=tcfg.weight_decay,
            max_grad_norm=tcfg.max_grad_norm)
        with torch.no_grad():
            for p, q in zip(T.leaves(params), T.leaves(new_p)):
                p.copy_(q)
        return new_o, {**metrics, **om, "lr": lr}

    # ------------------------------------------------------------------
    def init_or_restore(self):
        """(params: a nested dict of float32 tensors that require grad,
        the optimizer state, the step to start from)."""
        init = self.initial
        if init is None:
            init = self.api.init(self.device, seed=self.tcfg.seed)
        params = T.tree_map(
            lambda t: t.detach().to(self.device, torch.float32, copy=True)
            .requires_grad_(True), init)
        opt = adamw.init(params)
        start = 0
        if (self.tcfg.ckpt_dir
                and ckpt.latest_step(self.tcfg.ckpt_dir) is not None):
            state, meta = ckpt.restore(self.tcfg.ckpt_dir,
                                       {"params": params, "opt": opt},
                                       device=self.device)
            params = T.tree_map(lambda t: t.requires_grad_(True),
                                state["params"])
            opt, start = state["opt"], meta["step"]
        return params, opt, start

    def run(self) -> dict:
        """Train from ``init_or_restore`` to ``tcfg.steps`` or a
        preemption.  Returns ``params`` (the family's module over the
        trained tensors, detached: ready to serve), ``opt``,
        ``history`` (``{"step", "loss", "dt"}`` a step, as the
        reference's, and the step's ``grad_norm``), ``stopped_at`` and
        ``stragglers``."""
        params, opt, start = self.init_or_restore()
        history = []
        t_last = time.time()
        step = start
        for step in range(start, self.tcfg.steps):
            if self.preempt.should_stop():
                break
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.data.batch(step).items()}
            opt, metrics = self.step(params, opt, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t_last
            t_last = time.time()
            self.watchdog.observe(step, dt)
            history.append({"step": step, "loss": loss, "dt": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                ckpt.save(self.tcfg.ckpt_dir, step + 1,
                          {"params": params, "opt": opt},
                          metadata={"arch": self.cfg.name},
                          keep=self.tcfg.keep)
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"step {step+1:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms",
                      flush=True)
        # final checkpoint on clean exit or preemption (the reference's
        # tag: step + 1 of the last loop index)
        if self.tcfg.ckpt_dir:
            ckpt.save(self.tcfg.ckpt_dir, step + 1,
                      {"params": params, "opt": opt},
                      metadata={"arch": self.cfg.name}, keep=self.tcfg.keep)
        served = self._module(T.tree_map(lambda t: t.detach(), params))
        return {"params": served, "opt": opt, "history": history,
                "stopped_at": step + 1,
                "stragglers": self.watchdog.flagged_steps}
