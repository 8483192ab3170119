"""Sharding-constraint context: lets model code place activation
constraints (sequence parallelism etc.) without threading the mesh
through every call.

Port of ``repro.launch.shardctx``.  Outside a context, and on a plain
tensor, :func:`constrain` returns its input as it is: it reads one
context variable and allocates nothing, so the graphed decode step and
tick are what they were without it.  On a ``DTensor`` inside a context
it redistributes to the placements the template resolves to on the
context's ``DeviceMesh``; while a ``launch.partition`` pass runs (the
dry run's, on ``meta``) it moves the tensor's placement there.

:func:`batch_split` is the one piece with no counterpart there: where
a step hands each data rank its share of a batch (one process a rank),
it tells the layers that plan over the whole batch -- the MoE dispatch
-- which share this rank holds, as XLA's partitioning keeps the
reference's whole-batch semantics on any mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

from repro_torch.launch.mesh import (axis_sizes, data_group, data_rank,
                                     dp_size)

_CTX = contextvars.ContextVar("repro_torch_shard_ctx", default=None)


class BatchSplit(NamedTuple):
    """A batch split over the data ranks: rank ``rank`` of ``ranks``
    (over the process group ``group``) holds the ``rank``-th of
    ``ranks`` equal contiguous parts of every microbatch or decode step
    (``sharding.batch_share``, ``serve.request_rows``)."""
    group: object
    rank: int
    ranks: int


def mesh_split(mesh) -> BatchSplit | None:
    """The split of a batch over ``mesh``'s data ranks, ``None`` where
    there is one data rank (or no process group behind the mesh)."""
    group = data_group(mesh)
    if group is None:
        return None
    return BatchSplit(group, data_rank(mesh), dp_size(mesh))


#: the split in force (:func:`batch_split`).  Process-wide, not a context
#: variable: the autograd engine recomputes a rematerialized layer on its
#: own device thread, which sees no context variable of the caller's
_SPLIT: list = [None]


@contextlib.contextmanager
def batch_split(split: BatchSplit | None):
    """Within the block, the batch a layer sees is this rank's share of
    ``split`` (``None``: the whole batch, as outside any block).  The
    block must hold the backward pass too: a rematerialized layer plans
    again there."""
    prev, _SPLIT[0] = _SPLIT[0], split
    try:
        yield
    finally:
        _SPLIT[0] = prev


def split() -> BatchSplit | None:
    """The :class:`BatchSplit` in force, or ``None``."""
    return _SPLIT[0]


@contextlib.contextmanager
def activation_sharding(mesh, dp_axes: tuple, *, sequence_axis: str | None,
                        moe_axes: tuple | None = None):
    """dp_axes: mesh axes carrying the batch (e.g. ("pod", "data")).
    sequence_axis: axis to shard the residual-stream T dim over
    (Megatron-style sequence parallelism) or None.
    moe_axes: (expert_axes, capacity_axes) for expert-parallel
    activations ("ep" / "cap" template entries in :func:`constrain`)."""
    tok = _CTX.set({"mesh": mesh, "dp": dp_axes, "seq": sequence_axis,
                    "moe": moe_axes})
    try:
        yield
    finally:
        _CTX.reset(tok)


def entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a tuple of one axis
    is that axis' name."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def constrain_residual(x):
    """Apply the context's residual-stream sharding to [B, T, D] acts."""
    return constrain(x, ("dp", "seq", None))


def resolve(spec_template: tuple, shape: tuple) -> tuple | None:
    """The spec the context gives ``spec_template`` for a tensor of
    ``shape`` (``None`` outside a context).  Template entries: "dp" ->
    the context's batch axes, "seq" -> the sequence axis (may be None),
    "ep"/"cap" -> the MoE axes, None/axis-name -> literal; an entry
    whose mesh-axes product does not divide its dim is replicated."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    sizes = axis_sizes(ctx["mesh"])
    entries = []
    for dim, e in enumerate(spec_template[: len(shape)]):
        if e == "dp":
            e = ctx["dp"]
        elif e == "seq":
            e = ctx["seq"]
        elif e == "ep":
            e = ctx["moe"][0] if ctx.get("moe") else None
        elif e == "cap":
            e = ctx["moe"][1] if ctx.get("moe") else None
        if e is None:
            entries.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        size = 1
        for a in axes:
            size *= sizes[a]
        entries.append(entry(e) if shape[dim] % size == 0 else None)
    return tuple(entries)


def constrain(x, spec_template: tuple):
    """Generic activation constraint (see :func:`resolve`): a ``DTensor``
    is redistributed to the resolved spec's placements, and under a
    partition pass a tensor's placement moves to it; anything else, and
    anything outside a context, is returned unchanged."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    from repro_torch.launch import partition
    part = partition.active()
    if part is not None:
        return part.constrain(x, resolve(spec_template, tuple(x.shape)))
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import placements
    spec = resolve(spec_template, tuple(x.shape))
    return x.redistribute(ctx["mesh"], placements(spec, ctx["mesh"]))


def scan_carry(x, leaving: bool = False):
    """The reference runs the layers as a scan, whose carry enters with
    the sharding the body gives it on the way out.  Under a partition
    pass, ``x`` entering the layers moves to the placement an earlier
    pass of the same step saw it leave with (``leaving``: record it);
    anything else returns ``x`` as it is."""
    from repro_torch.launch import partition
    part = partition.active()
    return x if part is None else part.carry(x, leaving)


def dp_axes() -> tuple | None:
    ctx = _CTX.get()
    return None if ctx is None else ctx["dp"]
