"""Meshes: the production meshes the dry run plans for, the host mesh
over the ranks a run has, and the ranks themselves.

Port of ``repro.launch.mesh``.  The reference builds its production
meshes from 256 or 512 (forced) devices; no process in the port ever
holds that many ranks, so :func:`make_production_mesh` returns an
abstract mesh -- axis names and sizes, no process group and no device
behind it -- which is all the sharding rules and the dry run read.
:func:`make_host_mesh` is a real ``DeviceMesh`` over the default process
group, as the reference's spans every device there is: one rank a card
(NCCL) unless the caller asks for the CPU (gloo).  It issues no
collective.

A rank is one process.  :func:`spawn` starts N of them over a
``FileStore`` in a temporary directory: rank ``r`` of a card run takes
``cuda:r`` (a rank without a card of its own raises, it never goes on
on the CPU), a CPU run uses gloo, and each rank runs torch on one
intra-op thread.  The collectives the ranks agree through
(:func:`all_to_all`, :func:`all_gather`, :func:`all_reduce`,
:func:`broadcast`) count the bytes this rank sends to the others in
``COLLECTIVES.sent_bytes`` (a captured step adds its share on every
replay, as it does the kernels' launches).

The roofline constants are one H100 SXM's data-sheet figures, where the
reference declares TPU v5e's.  Nothing in this file is measured.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import tempfile
from types import SimpleNamespace

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


#: the backend of each device type's process groups
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
#: the host meshes made in this process, by (device type, model width)
_HOST_MESHES: dict = {}
#: whether this module started the default process group
_OWN_GROUP: list = []


def make_host_mesh(model: int = 1,
                   device: str | torch.device | None = None):
    """A ``DeviceMesh`` of shape ``(ranks // model, model)``
    ``("data", "model")`` over the default process group, on ``device``
    (``None``: the card, NCCL; ``"cpu"``: gloo).  With no group yet, a
    one-rank group is started here (an in-process ``HashStore``, rank 0
    of 1: no network); a group of N ranks (:func:`spawn`) gives the
    mesh its N ranks, as the reference's spans every device.  A group
    on the other backend raises.  Made once a process for each device
    type and width."""
    dev = resolve_device(device)
    key = (dev.type, model)
    if key in _HOST_MESHES:
        return _HOST_MESHES[key]
    if dev.type == "cuda" and not dist.is_initialized():
        # the rank's card, before the group
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        _OWN_GROUP.append(True)
    backend = dist.get_backend()
    if backend != _BACKEND[dev.type]:
        raise ValueError(f"the default process group is {backend}; a "
                         f"{dev.type} mesh needs {_BACKEND[dev.type]}")
    n = dist.get_world_size()
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


# -- ranks --------------------------------------------------------------------

#: seconds a collective may wait for its peers before the group raises
RANK_TIMEOUT_S = 600


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` for a card run (raising
    when the machine has no card of that index: a rank never goes on
    on the CPU), else the CPU."""
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if rank >= n:
            raise RuntimeError(f"rank {rank} has no card of its own: the "
                               f"machine has {n} CUDA card(s)")
        return torch.device("cuda", rank)
    if device_type != "cpu":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    return torch.device("cpu")


def _rank_main(rank: int, ranks: int, device_type: str, tmp: str, fn,
               args: tuple) -> None:
    """One rank of :func:`spawn`: its device and thread count, the
    process group over the ``FileStore``, one collective that proves
    the group works, then ``fn``; its return value is pickled next to
    the store for the parent."""
    torch.set_num_threads(1)
    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        _BACKEND[dev.type], store=dist.FileStore(os.path.join(tmp, "store"),
                                                 ranks),
        rank=rank, world_size=ranks,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
        device_id=dev if dev.type == "cuda" else None)
    try:
        # a group that cannot communicate (an NCCL init that failed)
        # raises here, not at the caller's first step
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        if int(probe.item()) != ranks:
            raise RuntimeError(f"rank {rank}: the group's first all-reduce "
                               f"gave {probe.item()}, want {ranks}")
        out = fn(rank, dev, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        release_host_mesh()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, ranks: int, device: str | torch.device, *args) -> list:
    """Run ``fn(rank, device, *args)`` on ``ranks`` new processes, one
    rank each, and return each rank's return value, in rank order.

    ``device`` names the device type: ``"cuda"`` (rank ``r`` takes
    ``cuda:r``, NCCL) or ``"cpu"`` (gloo).  The ranks meet over a
    ``dist.FileStore`` in a temporary directory; the default process
    group spans them all (:func:`make_host_mesh` then gives its N
    ranks).  ``fn`` must be a module-level function and its value
    picklable (the processes are spawned, not forked).  Each rank runs
    torch on one intra-op thread.  A rank that raises fails the call:
    the others are ended and the rank's error is raised here."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    if ranks < 1:
        raise ValueError(f"need >= 1 rank, got {ranks}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(_rank_main,
                           args=(ranks, device_type, tmp, fn, args),
                           nprocs=ranks, join=True, start_method="spawn")
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


# -- collectives --------------------------------------------------------------

#: bytes this rank sent to other ranks through the collectives below: an
#: all-to-all's chunks for its peers, an all-gather's and an
#: all-reduce's input once a peer, a broadcast's tensor once a peer from
#: its source
COLLECTIVES = SimpleNamespace(sent_bytes=0)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """NCCL takes no ``bool``: masks travel as ``uint8``."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk ``i`` of ``x [G, ...]`` goes to the group's rank ``i``;
    returns ``[G, ...]`` whose chunk ``j`` came from rank ``j`` (one
    ``all_to_all_single``)."""
    g = dist.get_world_size(group)
    if x.shape[0] != g:
        raise ValueError(f"all_to_all of {x.shape[0]} chunks over {g} ranks")
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    COLLECTIVES.sent_bytes += _nbytes(w) * (g - 1) // g
    return out.to(x.dtype)


_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x``, stacked in group rank order: ``[G, *x.shape]``."""
    g = dist.get_world_size(group)
    w = _wire(x).reshape((1,) + tuple(x.shape) if x.ndim == 0 else x.shape)
    out = w.new_empty((g * w.shape[0],) + tuple(w.shape[1:]))
    _GATHER(out, w, group=group)
    COLLECTIVES.sent_bytes += _nbytes(w) * (g - 1)
    return out.reshape((g,) + tuple(x.shape)).to(x.dtype)


def all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced over the group (``dist.ReduceOp``), in a new tensor."""
    out = _wire(x).clone()
    dist.all_reduce(out, op=op, group=group)
    COLLECTIVES.sent_bytes += _nbytes(out) * (dist.get_world_size(group) - 1)
    return out.to(x.dtype)


def broadcast(x: torch.Tensor, group) -> torch.Tensor:
    """The group's rank 0's ``x`` on every rank, in a new tensor."""
    out = _wire(x).clone()
    dist.broadcast(out, src=dist.get_global_rank(group, 0), group=group)
    if dist.get_rank(group) == 0:
        COLLECTIVES.sent_bytes += _nbytes(out) * (
            dist.get_world_size(group) - 1)
    return out.to(x.dtype)
