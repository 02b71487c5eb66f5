"""Training loop (port of the JAX package's ``runtime/trainer.py``): the
LR schedule, AdamW, restart-stable data, atomic checkpoints and resume,
the straggler watchdog and preemption, on one device or a mesh.

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
family's ``forward`` differentiates as it serves.

With ``mesh`` (a ``DeviceMesh`` with the reference's axis names over
an initialised process group) the parameters and both AdamW moments are
DTensors laid out by ``sharding.rules.tree_shardings(..., "train")``
with the rank gate on (the reference's ``p_shard`` / ``o_shard``).
Each rank trains on its rows of the global batch over the FSDP axes;
rank 0's draw is broadcast first, since ``SyntheticLM`` seeds a batch
with the per-process salted ``hash``.  The forward gathers the full
parameters (FSDP-style; no tensor-parallel compute), and each rank's
gradients land in the parameters' placements as partial sums over the
FSDP axes (a reduce-scatter, the reference's
``with_sharding_constraint(grads, p_shard)``).  The clip uses the
global norm; checkpoints hold the full tensors (rank 0 writes them) and
restore onto this mesh's placements (``ckpt.restore(shardings=)``),
whatever mesh wrote them.
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
from repro_torch.sharding import rules as R


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
    ``tcfg.ckpt_dir`` wins over either.  ``mesh``: train sharded on it
    (the module docstring)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device=None,
                 params=None, mesh=None):
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
        self.mesh = mesh
        if mesh is not None:
            aparams = self.api.abstract_params(torch.float32)
            specs = R.tree_shardings(aparams, self.api.logical_axes(), mesh,
                                     "train")
            self.p_shard = R.named_shardings(aparams, specs, mesh)
            self.o_shard = adamw.AdamWState(
                step=R.NamedSharding(None), mu=self.p_shard, nu=self.p_shard)
            self._fsdp = [a for a in mesh.mesh_dim_names
                          if a in ("pod", "data")]

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
        """(the gradient tree of ``params``, the loss's metrics).  On a
        mesh ``batch`` holds this rank's rows: the full parameters are
        gathered for the forward, and the gradients and metrics are the
        means over the FSDP ranks, the gradients in the parameters'
        placements."""
        if self.mesh is None:
            total, metrics = mapi.loss_fn(self.api, self._module(params),
                                          batch)
            grads = torch.autograd.grad(total, T.leaves(params))
            return (T.unflatten(params, grads),
                    {k: v.detach() for k, v in metrics.items()})
        leaves = T.leaves(params)
        full = [p.full_tensor().detach().requires_grad_(True)
                for p in leaves]
        total, metrics = mapi.loss_fn(
            self.api, self._module(T.unflatten(params, full)), batch)
        grads = torch.autograd.grad(total, full)
        grads = [self._dp_mean(g).redistribute(self.mesh, p.placements)
                 for g, p in zip(grads, leaves)]
        return (T.unflatten(params, grads),
                {k: self._dp_mean(v.detach()).full_tensor()
                 for k, v in metrics.items()})

    def _dp_mean(self, t: torch.Tensor):
        """A DTensor: the mean over the FSDP ranks of each rank's ``t``
        (pending: partial sums), replicated over "model"."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        n = 1
        for a in self._fsdp:
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        pl = [Partial() if a in self._fsdp else Replicate()
              for a in self.mesh.mesh_dim_names]
        return DTensor.from_local(t / n, self.mesh, pl, run_check=False)

    def _rows(self, step: int) -> dict:
        """Step ``step``'s batch on the device: the global batch, or on a
        mesh this rank's rows of rank 0's draw."""
        batch = {k: torch.as_tensor(v, device=self.device).contiguous()
                 for k, v in self.data.batch(step).items()}
        if self.mesh is None:
            return batch
        import torch.distributed as dist

        from repro_torch.data import host_batch_slice

        for v in batch.values():
            dist.broadcast(v, src=0)
        rank, size = 0, 1
        for a in self._fsdp:
            n = self.mesh.size(self.mesh.mesh_dim_names.index(a))
            rank, size = rank * n + self.mesh.get_local_rank(a), size * n
        rows = host_batch_slice(self.tcfg.global_batch, rank, size)
        return {k: v[rows] for k, v in batch.items()}

    def apply(self, params: dict, opt: adamw.AdamWState, grads,
              metrics: dict):
        """AdamW on ``params`` in place at the lr of ``opt``'s step; the
        step's half after the gradients.  Returns (the new optimizer
        state, ``metrics`` with ``grad_norm`` and ``lr``)."""
        tcfg = self.tcfg
        lr = self._lr(opt.step)
        with self._mixed():
            new_p, new_o, om = adamw.update(
                grads, opt, params, lr=lr, weight_decay=tcfg.weight_decay,
                max_grad_norm=tcfg.max_grad_norm)
            with torch.no_grad():
                for p, q in zip(T.leaves(params), T.leaves(new_p)):
                    p.copy_(q)
        if self.mesh is not None:
            om = {k: v.full_tensor() for k, v in om.items()}
        return new_o, {**metrics, **om, "lr": lr}

    def _mixed(self):
        """On a mesh, plain tensors (the step counter, the learning
        rate) enter DTensor arithmetic as replicated."""
        import contextlib

        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()

    def _save(self, step: int, params, opt) -> None:
        """A checkpoint of the full tensors (on a mesh: gathered by every
        rank, written by rank 0)."""
        state = {"params": params, "opt": opt}
        if self.mesh is not None:
            import torch.distributed as dist

            state = T.tree_map(
                lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                else t, state)
            if dist.get_rank() != 0:
                dist.barrier()
                return
        ckpt.save(self.tcfg.ckpt_dir, step, state,
                  metadata={"arch": self.cfg.name}, keep=self.tcfg.keep)
        if self.mesh is not None:
            dist.barrier()

    # ------------------------------------------------------------------
    def init_or_restore(self):
        """(params: a nested dict of float32 tensors that require grad,
        the optimizer state, the step to start from)."""
        init = self.initial
        if init is None:
            init = self.api.init(self.device, seed=self.tcfg.seed)
        params = T.tree_map(
            lambda t: t.detach().to(self.device, torch.float32, copy=True),
            init)
        if self.mesh is not None:
            params = T.tree_map(R.distribute, params, self.p_shard)
        params = T.tree_map(lambda t: t.requires_grad_(True), params)
        opt = adamw.init(params)
        start = 0
        if (self.tcfg.ckpt_dir
                and ckpt.latest_step(self.tcfg.ckpt_dir) is not None):
            shardings = None if self.mesh is None else {
                "params": self.p_shard, "opt": self.o_shard}
            state, meta = ckpt.restore(self.tcfg.ckpt_dir,
                                       {"params": params, "opt": opt},
                                       device=self.device,
                                       shardings=shardings)
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
            opt, metrics = self.step(params, opt, self._rows(step))
            loss = float(metrics["loss"])
            dt = time.time() - t_last
            t_last = time.time()
            self.watchdog.observe(step, dt)
            history.append({"step": step, "loss": loss, "dt": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1, params, opt)
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"step {step+1:5d}  loss {loss:.4f}  "
                      f"lr {float(metrics['lr']):.2e}  {dt*1e3:.0f} ms",
                      flush=True)
        # final checkpoint on clean exit or preemption (the reference's
        # tag: step + 1 of the last loop index)
        if self.tcfg.ckpt_dir:
            self._save(step + 1, params, opt)
        served = self._module(T.tree_map(
            lambda t: (t.full_tensor() if self.mesh is not None else t)
            .detach(), params))
        return {"params": served, "opt": opt, "history": history,
                "stopped_at": step + 1,
                "stragglers": self.watchdog.flagged_steps}
