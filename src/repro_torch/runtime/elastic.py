"""Elastic scaling of the fleet's shard layout.

Port of ``repro.runtime.elastic``.  The reference rebuilds a device
mesh over the surviving devices and re-places a state on it.  One card
has no device list: the fleet's ``(region, edge)`` shards are the
leading dims of its tensors, so :func:`remesh` computes the new
``(regions, edges)`` from a shard count, with the reference's resize
rule for the fleet (one of the two a call), and :func:`reshard_state`
reslices the leading shard dim; across ranks it moves the rows rank to
rank.
:class:`ElasticBudget` (host-side numpy) is copied as it is.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.overlay import Overlay
from repro_torch.launch import mesh as M


def remesh(regions: int, edges: int, num_shards: int,
           fix_regions: bool = True) -> tuple[int, int]:
    """The fleet's new ``(regions, edges)`` shape over ``num_shards``
    shards, resizing one of the two sizes: ``fix_regions`` keeps the
    region count and the edge width absorbs the change (an edge
    resize); otherwise the edge width is kept and the region count
    absorbs it (a region resize).  ``num_shards`` must be a positive
    multiple of the kept size -- the reference's ``fixed_axis`` rule on
    its ``("region", "edge")`` mesh."""
    n = int(num_shards)
    if n < 1:
        raise ValueError("no devices to re-mesh over")
    keep = regions if fix_regions else edges
    other = n // keep
    if other == 0 or other * keep != n:
        raise ValueError(
            f"{n} devices cannot keep "
            f"{'region' if fix_regions else 'edge'}={keep} "
            f"(need a positive multiple of {keep})")
    return (keep, other) if fix_regions else (other, keep)


def reshard_state(state, keep: list, fresh, *, src=None, dst=None):
    """Reslice a state's leading shard dim: new row ``j`` is old row
    ``keep[j]``, or row ``j`` of ``fresh`` (a state of the new width)
    where ``keep[j]`` is None.  ``state`` and ``fresh`` are NamedTuples
    (nested) of tensors with the same structure.

    Across ranks (``src`` and ``dst``, the old and the new
    ``launch.mesh.RowLayout``): ``state`` and ``fresh`` (a tuple of such
    trees too) hold this rank's rows of the old and the new layout, and
    new row ``j`` moves from the rank holding old row ``keep[j]`` to the
    rank holding row ``j`` (``launch.mesh.move_rows``: every leaf in one
    batch, nothing sent for a row that stays on its rank), written into
    ``fresh``'s tensors, which are returned."""
    if src is not None:
        M.move_rows(_leaves(state),
                    [(k, j) for j, k in enumerate(keep) if k is not None],
                    src, dst, _leaves(fresh))
        return fresh
    if isinstance(state, tuple):
        return type(state)(*(reshard_state(o, keep, f)
                             for o, f in zip(state, fresh)))
    return torch.stack([state[k] if k is not None else fresh[j]
                        for j, k in enumerate(keep)])


def _leaves(tree) -> list:
    """The tensors of a tree of (named) tuples, depth first."""
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@dataclasses.dataclass
class ElasticBudget:
    """Hysteresis grow/shrink policy for an elastic per-tick work budget.

    Feed it the observed demand (fleet escalations this tick) and the
    current budget; it proposes a new budget.  Growth fires after
    ``patience`` consecutive ticks at utilization >= ``grow_at``;
    shrink after ``patience`` consecutive ticks at <= ``shrink_at``.
    """
    min_budget: int
    max_budget: int
    grow_at: float = 0.9          # utilization that counts as pressure
    shrink_at: float = 0.25       # utilization that counts as idle
    grow_factor: float = 2.0      # multiplicative grow / shrink step
    patience: int = 2             # consecutive ticks before resizing
    _hot: int = 0
    _cold: int = 0

    def __post_init__(self):
        if not (0 < self.min_budget <= self.max_budget):
            raise ValueError(f"bad budget range: {self}")
        if not (0.0 <= self.shrink_at < self.grow_at):
            raise ValueError(f"need 0 <= shrink_at < grow_at, got {self}")
        if self.grow_factor <= 1.0 or self.patience < 1:
            raise ValueError(f"need grow_factor > 1, patience >= 1: {self}")

    def propose(self, demand: int, budget: int) -> int:
        """One control tick: observed demand -> proposed budget.  Only a
        proposal that moves the budget consumes patience: at a saturated
        ceiling or floor the counters keep accruing."""
        util = demand / max(budget, 1)
        if util >= self.grow_at:
            self._hot, self._cold = self._hot + 1, 0
        elif util <= self.shrink_at:
            self._hot, self._cold = 0, self._cold + 1
        else:
            self._hot = self._cold = 0
        if self._hot >= self.patience:
            proposed = min(self.max_budget,
                           max(budget + 1, int(budget * self.grow_factor)))
            if proposed != budget:
                self._hot = 0
                return proposed
        if self._cold >= self.patience:
            proposed = max(self.min_budget, int(budget / self.grow_factor))
            if proposed != budget:
                self._cold = 0
                return proposed
        return budget


def rebuild_overlay(shape: tuple, **kw) -> Overlay:
    """Overlay over the grid of a (possibly new) shard shape, such as
    the ``(regions, edges)`` that :func:`remesh` returns: the leading
    sizes' product as rows, the last size as columns."""
    rows = 1
    for v in shape[:-1]:
        rows *= int(v)
    return Overlay.from_mesh_shape(rows, int(shape[-1]), **kw)
