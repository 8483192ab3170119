"""Meshes: the production meshes the dry run plans for, and the host
mesh a run on one card uses.

Port of ``repro.launch.mesh``.  The reference builds its production
meshes from 256 or 512 (forced) devices; no process in the port ever
holds that many ranks, so :func:`make_production_mesh` returns an
abstract mesh -- axis names and sizes, no process group and no device
behind it -- which is all the sharding rules and the dry run read.
:func:`make_host_mesh` is a real ``DeviceMesh`` over a one-rank process
group: the card (NCCL) unless the caller asks for the CPU (gloo).  It
issues no collective.

The roofline constants are one H100 SXM's data-sheet figures, where the
reference declares TPU v5e's.  Nothing in this file is measured.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# Roofline constants of one NVIDIA H100 SXM, from NVIDIA's H100 data
# sheet (dense rates, no sparsity), not measured:
PEAK_FLOPS_BF16 = 989e12      # FLOP/s a card, bf16 on the tensor cores
HBM_BW = 3.35e12              # B/s a card, HBM3
# NVLink 4: 900 GB/s a card over its 18 links, both directions together;
# one direction, what a collective's operand bytes cross, is half of it
ICI_BW = 450e9                # B/s a card


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with nothing behind them: what the
    sharding rules and the dry run read of a mesh."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (``jax``'s ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 ``("data", "model")``; multi-pod: 2 x 16 x 16 with a
    leading ``"pod"`` axis (data parallel across pods)."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


#: the host meshes made in this process, by (device type, model width)
_HOST_MESHES: dict = {}
#: whether this module started the default process group
_OWN_GROUP: list = []


def make_host_mesh(model: int = 1,
                   device: str | torch.device | None = None):
    """A ``DeviceMesh`` of shape ``(ranks // model, model)``
    ``("data", "model")`` over the process's one-rank default group, on
    ``device`` (``None``: the card, NCCL; ``"cpu"``: gloo).  The group
    is started here (an in-process ``HashStore``, rank 0 of 1: no
    network) unless one exists; a larger one raises.  Made once a
    process for each device type and width."""
    dev = resolve_device(device)
    key = (dev.type, model)
    if key in _HOST_MESHES:
        return _HOST_MESHES[key]
    if dev.type == "cuda":      # the rank's card, before the group
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        _OWN_GROUP.append(True)
    n = dist.get_world_size()
    if n != 1:
        raise ValueError(f"the host mesh is one rank; the default process "
                         f"group has {n}")
    if n % model:
        raise ValueError(f"model width {model} does not divide {n} rank(s)")
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))
    _HOST_MESHES[key] = mesh
    return mesh


def release_host_mesh() -> None:
    """Forget the host meshes and end the default process group if
    :func:`make_host_mesh` started it."""
    _HOST_MESHES.clear()
    if _OWN_GROUP and dist.is_initialized():
        dist.destroy_process_group()
    _OWN_GROUP.clear()


def axis_sizes(mesh) -> dict:
    """Axis name -> size, in axis order, of an :class:`AbstractMesh` or
    a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> tuple:
    """Mesh axes that carry the global batch."""
    return tuple(axis_sizes(mesh))[:-1]     # all but the trailing "model"


def model_axis(mesh) -> str:
    return tuple(axis_sizes(mesh))[-1]


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))
