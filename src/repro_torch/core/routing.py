"""Dispatch plans: the capacity-bounded core tier and the content-
routing data plane (paper §IV-B).

Port of ``repro.core.routing``: first-come-first-kept bucketing
(:func:`make_plan`), the scatter/gather between a batch and its
buckets, :func:`compact_apply` (the pipeline's core stage), and the
single-rank half of the AR data plane, :func:`route_local` and
:func:`rank_of_message` (sfc index -> owner rank -> buckets).  The
exchange between ranks (``all_to_all_route``, ``route_and_deliver``)
and the fleet's escalation helpers (``escalation_plan``,
``escalation_recv_slots``) belong to the fleet slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import sfc


class DispatchPlan(NamedTuple):
    """Scatter plan for a batch of items to ``num_dest`` buckets."""
    dest: torch.Tensor       # [N] int32 destination bucket per item
    position: torch.Tensor   # [N] int32 slot within the bucket
    keep: torch.Tensor       # [N] bool  item fit under capacity
    overflow: torch.Tensor   # [num_dest] int32 items dropped per bucket
    counts: torch.Tensor     # [num_dest] int32 items kept per bucket


def make_plan(dest: torch.Tensor, num_dest: int,
              capacity: int) -> DispatchPlan:
    """Deterministic first-come-first-kept bucketing (cumsum positions)."""
    dest = dest.to(torch.int32)
    onehot = torch.nn.functional.one_hot(dest.long(), num_dest) \
        .to(torch.int32)                                     # [N, D]
    position = torch.cumsum(onehot, 0, dtype=torch.int32) * onehot
    pos = position.sum(-1, dtype=torch.int32) - 1           # [N] 0-based
    keep = pos < capacity
    total = onehot.sum(0, dtype=torch.int32)                 # [D]
    counts = torch.clamp(total, max=capacity)
    return DispatchPlan(dest, pos, keep, total - counts, counts)


def _slots(plan: DispatchPlan, capacity: int) -> torch.Tensor:
    return (plan.dest * capacity
            + torch.clamp(plan.position, 0, capacity - 1)).long()


def scatter_to_buckets(items: torch.Tensor, plan: DispatchPlan,
                       num_dest: int, capacity: int) -> torch.Tensor:
    """[N, ...] items -> [num_dest, capacity, ...] buckets (zero padding).

    An add, as in the reference: kept items own distinct slots and every
    other item adds an exact zero, so the result does not depend on the
    order the adds land in (atomics on the card)."""
    n = items.shape[0]
    keep = plan.keep.reshape((n,) + (1,) * (items.ndim - 1))
    src = torch.where(keep, items, 0)
    buckets = items.new_zeros((num_dest * capacity,) + items.shape[1:])
    buckets.index_add_(0, _slots(plan, capacity), src)
    return buckets.reshape((num_dest, capacity) + items.shape[1:])


def gather_from_buckets(buckets: torch.Tensor,
                        plan: DispatchPlan) -> torch.Tensor:
    """Inverse of :func:`scatter_to_buckets` (zeros for overflow)."""
    num_dest, capacity = buckets.shape[:2]
    flat = buckets.reshape((num_dest * capacity,) + buckets.shape[2:])
    out = flat[_slots(plan, capacity)]
    keep = plan.keep.reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(keep, out, 0)


def compact_apply(fn, items: torch.Tensor, keep: torch.Tensor,
                  capacity: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``fn`` on the ``keep`` subset of a fixed-shape batch,
    compacted to ``capacity`` slots (first-come-first-kept).
    fn: [C, ...] -> ([C, ...], [C, F]).  Returns (outputs, features,
    processed) at full batch shape; shed items return zeros."""
    keep = keep.to(torch.bool)
    dest = torch.where(keep, 0, 1).to(torch.int32)     # bucket 0 = compute
    plan = make_plan(dest, 2, capacity)
    compact = scatter_to_buckets(items, plan, 2, capacity)[0]   # [C, ...]
    out_c, feats_c = fn(compact)
    pad_out = out_c.new_zeros((2, capacity) + out_c.shape[1:])
    pad_out[0] = out_c
    pad_feats = feats_c.new_zeros((2, capacity) + feats_c.shape[1:])
    pad_feats[0] = feats_c
    return (gather_from_buckets(pad_out, plan),
            gather_from_buckets(pad_feats, plan), plan.keep & keep)


# ---------------------------------------------------------------------------
# AR data plane, one rank's side
# ---------------------------------------------------------------------------

def _owner(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Curve indices (int32 bit patterns of 32-bit ids) -> owner ranks:
    the top ``log2(len(table))`` bits pick the table cell."""
    g2 = table.shape[0].bit_length() - 1       # = 2*granularity bits
    if table.shape[0] != 1 << g2:
        raise ValueError(f"routing table of {table.shape[0]} cells is not "
                         "a power of two")
    cell = sfc._u32(idx) >> (32 - g2)
    return table[cell]


def route_local(payload: torch.Tensor, idx: torch.Tensor,
                table: torch.Tensor, num_ranks: int, capacity: int
                ) -> tuple[torch.Tensor, DispatchPlan]:
    """Bucket a local batch of messages by owner rank.

    payload: [N, D] message payloads; idx: [N] SFC curve indices (int32
    bit patterns, 2*order bits); table: [4^granularity] cell->rank.
    Returns ([num_ranks, capacity, D] send buffer, plan).
    """
    plan = make_plan(_owner(idx, table), num_ranks, capacity)
    return scatter_to_buckets(payload, plan, num_ranks, capacity), plan


def rank_of_message(profile_batch: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Convenience: encoded profiles [N, 128] -> owner ranks [N]."""
    return _owner(sfc.profile_index(profile_batch), table)
