"""Fault-tolerant checkpoints of trees of tensors (port of the JAX
package's ``checkpoint/manager.py``, with its layout, so each package
restores a checkpoint the other wrote).

* **atomicity**: written to ``<dir>/tmp.<step>.<pid>``, then
  ``os.replace``\\ d to ``step_<k:010d>``; a crash mid-write never
  corrupts the latest checkpoint, and ``tmp.*`` is never listed;
* **keep-k retention** over the step tags;
* **layout**: ``leaves.npz`` holds the leaves as ``leaf_XXXXX`` in the
  reference's flatten order (:mod:`repro_torch.tree`: dict keys sorted,
  an ``AdamWState``'s fields in order, ``{"opt", "params"}`` sorted at
  the top), with their logical shapes; ``metadata.json`` holds the step,
  the leaf count and the caller's metadata;
* **placement**: ``restore`` puts the leaves on a given device, or
  with ``shardings=`` lays them out as DTensors on a mesh (the
  reference's elastic path: a checkpoint holds the full logical tensors,
  so it restores onto any mesh's placements, whatever mesh wrote it);
  ``save`` writes DTensors as their full tensors.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T


def _numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "full_tensor"):        # a DTensor: every rank gathers
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str | Path, step: int, tree: Any,
         metadata: dict | None = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}.{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    leaves = T.leaves(tree)
    arrs = {f"leaf_{i:05d}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    np.savez(tmp / "leaves.npz", **arrs)
    meta = {
        "step": int(step),
        "num_leaves": len(leaves),
        "treedef": None,    # the reference's JAX PyTreeDef; nothing reads it
        "time": time.time(),
        "user": metadata or {},
    }
    (tmp / "metadata.json").write_text(json.dumps(meta, indent=1))

    final = ckpt_dir / f"step_{step:010d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    # retention
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:010d}", ignore_errors=True)
    return final


def all_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
            if p.is_dir()]


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, like: Any, step: int | None = None,
            device=None, shardings: Any = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (the latest step unless
    ``step``): each leaf a tensor of the matching ``like`` leaf's dtype
    (the saved one for a leaf that is not a tensor), on ``device``
    (default: that leaf's device, else the CPU).  ``shardings``: a tree
    of ``like``'s structure whose leaves are
    :class:`~repro_torch.sharding.rules.NamedSharding`; each leaf then
    becomes a DTensor laid out by its sharding (every rank reads the
    file and keeps its own shards; ``mesh=None`` keeps a plain tensor).
    Raises ``ValueError`` on another leaf count or shape."""
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:010d}"
    meta = json.loads((d / "metadata.json").read_text())
    data = np.load(d / "leaves.npz")
    leaves = T.leaves(like)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['num_leaves']} leaves, target structure "
            f"has {len(leaves)} — config mismatch?")
    new_leaves = []
    for i, leaf in enumerate(leaves):
        arr = data[f"leaf_{i:05d}"]
        want_shape = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"leaf {i}: saved {arr.shape} != {want_shape}")
        t = torch.from_numpy(np.array(arr))
        if isinstance(leaf, torch.Tensor):
            t = t.to(device or _device_of(leaf), leaf.dtype)
        else:
            t = t.to(device or "cpu")
        new_leaves.append(t)
    if shardings is not None:
        from repro_torch.sharding.rules import distribute

        new_leaves = [distribute(t, sh) for t, sh in
                      zip(new_leaves, T.leaves(shardings), strict=True)]
    return T.unflatten(like, new_leaves), meta


def _device_of(leaf: torch.Tensor):
    """A tensor's device; a DTensor's local shard's."""
    return getattr(leaf, "_local_tensor", leaf).device
