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
(:func:`all_to_all`, :func:`all_gather`, :func:`all_reduce` and
:func:`broadcast`, their in-place forms :func:`all_reduce_` and
:func:`broadcast_`, :func:`broadcast_ints`, and the point-to-point
:func:`move_rows`) count the
bytes this rank sends to the others in ``COLLECTIVES.sent_bytes`` (a
captured step adds its share on every replay, as it does the kernels'
launches).  :func:`new_group` and :class:`RankMesh` lay a mesh over
some of the world's ranks; every world rank makes them, member or not.

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
from typing import NamedTuple

import numpy as np
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
    """Forget the host meshes and the groups :func:`new_group` made, and
    end the default process group if :func:`make_host_mesh` started
    it."""
    _HOST_MESHES.clear()
    _GROUPS.clear()
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


def data_group(mesh):
    """The process group over a ``DeviceMesh``'s data axis, whose ranks
    each take a share of the batch, or ``None`` where there is none to
    reduce over: no mesh, an :class:`AbstractMesh` (no process group
    behind it), or one data rank."""
    if mesh is None or isinstance(mesh, AbstractMesh) or dp_size(mesh) == 1:
        return None
    dp = dp_axes(mesh)
    if len(dp) != 1:
        raise NotImplementedError(f"data parallelism over {len(dp)} data "
                                  f"axes {dp}; the host mesh has one")
    return mesh.get_group(dp[0])


def data_rank(mesh) -> int:
    """This rank's index along the mesh's data axis (0 where
    :func:`data_group` is ``None``)."""
    if data_group(mesh) is None:
        return 0
    return mesh.get_local_rank(dp_axes(mesh)[0])


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


# -- groups over some of the ranks ----------------------------------------------

#: the groups :func:`new_group` made in this process, by their ranks
_GROUPS: dict = {}


def new_group(ranks) -> object:
    """The process group over ``ranks`` (world ranks, ascending), or
    ``None`` on a rank outside it.

    **Every world rank must call this, member or not, with the same
    ranks in the same order.**  ``dist.new_group`` is a call over the
    whole world (NCCL splits the world's communicator among the ranks
    that ask): a rank that skips a call, or makes them in another
    order, hangs the others.  The whole world is the default group; any
    other rank set is made once a process and kept (a second call
    returns it, on every rank alike, so the rule above still holds), so
    a fleet that shrinks and grows back reuses its groups and no group
    is destroyed while a captured graph may still hold it."""
    ranks = tuple(int(r) for r in ranks)
    n = dist.get_world_size()
    if not ranks or list(ranks) != sorted(set(ranks)) or ranks[0] < 0 \
            or ranks[-1] >= n:
        raise ValueError(f"a group needs distinct ascending ranks of the "
                         f"world's {n}, got {list(ranks)}")
    if ranks == tuple(range(n)):
        group = dist.group.WORLD
    elif ranks in _GROUPS:
        group = _GROUPS[ranks]
    else:
        group = _GROUPS[ranks] = dist.new_group(list(ranks))
    return group if dist.get_rank() in ranks else None


class RankMesh:
    """A 2-D mesh of world ranks (row-major over ``ranks``, ascending)
    and its process groups: the whole mesh's (:attr:`group`) and, for
    each dim, the group of the ranks that differ only along it -- the
    parts of a ``DeviceMesh`` the fleet reads (``mesh``,
    ``mesh_dim_names``, ``device_type``, :meth:`get_group`,
    :meth:`get_local_rank`).  Unlike ``init_device_mesh`` it may leave
    ranks of the world out.  Every world rank makes it, member or not
    (:func:`new_group`: the groups are made in one order on every rank);
    on a rank outside it :attr:`member` is False and it has no groups."""

    def __init__(self, device_type: str, ranks, shape: tuple,
                 dim_names: tuple):
        ranks = tuple(int(r) for r in ranks)
        if len(shape) != 2 or math.prod(shape) != len(ranks) \
                or len(dim_names) != 2:
            raise ValueError(f"a {shape} mesh {dim_names} cannot hold ranks "
                             f"{list(ranks)}")
        self.device_type = device_type
        self.ranks = ranks
        self.mesh = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
        self.mesh_dim_names = tuple(dim_names)
        self.group = new_group(ranks)
        me = dist.get_rank()
        self.member = me in ranks
        self._groups, self._coords = [], []
        for d in range(2):
            lines = self.mesh.movedim(d, -1).reshape(-1, shape[d]).tolist()
            mine = None
            for line in lines:          # every line, on every rank
                g = new_group(line)
                if me in line:
                    mine = (g, line.index(me))
            self._groups.append(None if mine is None else mine[0])
            self._coords.append(None if mine is None else mine[1])

    def _dim(self, name: str) -> int:
        if name not in self.mesh_dim_names:
            raise KeyError(f"no dim {name!r} in {self.mesh_dim_names}")
        return self.mesh_dim_names.index(name)

    def get_group(self, name: str):
        """The group of this rank's line along dim ``name``."""
        return self._groups[self._dim(name)]

    def get_local_rank(self, name: str):
        """This rank's coordinate along dim ``name`` (None outside)."""
        return self._coords[self._dim(name)]


class RowLayout(NamedTuple):
    """Rows of a tensor laid over ranks: ``ranks[p]`` holds ``per_rank``
    consecutive rows from ``p * per_rank`` on; a rank not in ``ranks``
    holds none."""
    ranks: tuple
    per_rank: int

    def where(self, row: int) -> tuple[int, int]:
        """(world rank, local index) of global row ``row``."""
        return self.ranks[row // self.per_rank], row % self.per_rank


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
    return all_reduce_(_wire(x).clone(), op, group).to(x.dtype)


def all_reduce_(x: torch.Tensor, op, group) -> torch.Tensor:
    """``x`` reduced over the group in place, and returned: no copy is
    made, so a model's gradients are summed without a second set.  ``x``
    must be contiguous and not ``bool``."""
    if x.dtype == torch.bool or not x.is_contiguous():
        raise ValueError(f"all_reduce_ in place needs a contiguous non-bool "
                         f"tensor, got {x.dtype}, strides {x.stride()}")
    dist.all_reduce(x, op=op, group=group)
    COLLECTIVES.sent_bytes += _nbytes(x) * (dist.get_world_size(group) - 1)
    return x


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """The group's rank ``src``'s ``x`` on every rank, in a new tensor
    (every rank passes a tensor of the same shape and dtype)."""
    return broadcast_(_wire(x).clone(), group, src).to(x.dtype)


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """The group's rank ``src``'s ``x`` written into every rank's ``x``
    in place, and returned (contiguous, not ``bool``; a parameter's
    ``detach()`` shares its storage)."""
    if x.dtype == torch.bool or not x.is_contiguous():
        raise ValueError(f"broadcast_ in place needs a contiguous non-bool "
                         f"tensor, got {x.dtype}, strides {x.stride()}")
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    if dist.get_rank(group) == src:
        COLLECTIVES.sent_bytes += _nbytes(x) * (dist.get_world_size(group) - 1)
    return x


def broadcast_params(model: torch.nn.Module, group) -> None:
    """The group's rank 0's parameters into every rank's ``model``, in
    place, one tensor at a time in ``named_parameters()`` order (every
    rank passes a model of the same shapes)."""
    with torch.no_grad():
        for p in model.parameters():
            broadcast_(p.detach(), group)


def broadcast_ints(parts: list, group, device) -> list:
    """The group's rank 0's int arrays ``parts`` on every rank, as int64
    numpy arrays: one broadcast of them packed in one int32 tensor on
    ``device``, split back by their lengths.  Every rank passes arrays
    of the same lengths (only rank 0's values are read: the others may
    pass zeros).  An int32 tensor and no pickling: a decision costs one
    small transfer and no host round trip of Python objects."""
    flat = [np.asarray(p, np.int64).reshape(-1) for p in parts]
    got = broadcast(torch.as_tensor(np.concatenate(flat).astype(np.int32),
                                    device=device), group).cpu().numpy()
    return np.split(got.astype(np.int64),
                    np.cumsum([len(p) for p in flat])[:-1])


def move_rows(xs: list, moves, src: RowLayout, dst: RowLayout,
              outs: list) -> list:
    """Move rows between ranks: for each ``(i, j)`` of ``moves``, row
    ``i`` of every tensor in ``xs`` (laid out by ``src``; ``xs`` holds
    this rank's rows) lands as row ``j`` of the matching tensor of
    ``outs`` (laid out by ``dst``: this rank's rows, written in place
    and returned).

    A row that stays on its rank is an index copy and costs no
    communication; the rest go in one ``batch_isend_irecv`` over the
    world group, one send of the stacked rows of each tensor from each
    source rank to each destination rank (gloo and NCCL alike).  A rank
    with no row to send or take calls nothing, so only the ranks a move
    touches need call this (with the same ``moves`` and layouts).  The
    bytes this rank sends count in ``COLLECTIVES.sent_bytes``."""
    me = dist.get_rank()
    sends: dict = {}
    recvs: dict = {}
    local = []
    for i, j in moves:
        (a, ai), (b, bj) = src.where(i), dst.where(j)
        if a == me and b == me:
            local.append((ai, bj))
        elif a == me:
            sends.setdefault(b, []).append(ai)
        elif b == me:
            recvs.setdefault(a, []).append(bj)
    for ai, bj in local:
        for x, o in zip(xs, outs):
            o[bj] = x[ai]
    ops, landed = [], []
    for peer in sorted(sends):
        idx = sends[peer]
        for x in xs:
            w = _wire(x[idx])
            ops.append(dist.P2POp(dist.isend, w, peer))
            COLLECTIVES.sent_bytes += _nbytes(w)
    for peer in sorted(recvs):
        idx = recvs[peer]
        for o in outs:
            buf = _wire(o[idx]).new_empty((len(idx),) + tuple(o.shape[1:]))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            landed.append((o, idx, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for o, idx, buf in landed:
        o[idx] = buf.to(o.dtype)
    return outs
