"""Meshes (port of the JAX package's ``launch/mesh.py``).

The reference's ``Mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``
here, with the reference's axis names: ``("data", "model")``, or
``("pod", "data", "model")`` across pods.  A :class:`MeshShape` is the
plain description of one (its axis sizes, no process group), which is
all the sharding rules and the dry run's arithmetic read, so they run
in a process that has no group.

The ambient mesh is the port's ``jax.set_mesh``: :func:`use_mesh` sets
it for a ``with`` block and :func:`get_abstract_mesh` reads it (``None``
outside one).  The activation constraints (``layers.constrain_act``) and
the expert-parallel MoE (``models/moe_ep.py``) read it.

Nothing here touches a process group at import.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

from repro_torch._device import resolve_device

PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and their sizes, in order, without devices."""
    axes: tuple[tuple[str, int], ...]

    @classmethod
    def of(cls, shape: dict) -> "MeshShape":
        return cls(tuple(shape.items()))

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`
    (or any object with a ``shape`` dict, as the reference's tests'
    ``FakeMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


_AMBIENT: list = []


def get_abstract_mesh():
    """The ambient mesh (the innermost :func:`use_mesh`), or ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh for the ``with`` block."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def device_mesh(shape: dict, device=None):
    """A ``DeviceMesh`` of ``shape``'s axes over the initialised process
    group (whose world size must be the mesh's size), on ``device``'s
    type: the card unless ``device="cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    ms = MeshShape.of(shape)
    if dist.get_world_size() != ms.size:
        raise ValueError(f"a {ms.shape} mesh needs {ms.size} ranks, the "
                         f"group has {dist.get_world_size()}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(ms.shape.values()),
                            mesh_dim_names=ms.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         plain: bool = False):
    """The reference's production mesh: 16 x 16 ``("data", "model")``,
    or 2 x 16 x 16 ``("pod", "data", "model")``.  ``plain``: its
    :class:`MeshShape` (no group needed); else a ``DeviceMesh`` over
    the initialised group of 256 / 512 ranks on ``device``."""
    shape = PRODUCTION[multi_pod]
    if plain:
        return MeshShape.of(shape)
    return device_mesh(shape, device)


def make_host_mesh(model: int = 1, device=None):
    """A ``(world // model, model)`` ``("data", "model")`` mesh over the
    initialised process group, on ``device`` (the card unless
    ``device="cpu"``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide {n} ranks")
    return device_mesh({"data": n // model, "model": model}, device)
