"""Dispatch plans: the capacity-bounded core tier and the content-
routing data plane (paper §IV-B).

Port of ``repro.core.routing``: first-come-first-kept bucketing
(:func:`make_plan`), the scatter/gather between a batch and its
buckets, :func:`compact_apply` (the pipeline's core stage), the AR data
plane (:func:`route_local`, :func:`rank_of_message`, and the exchange
between ranks, :func:`all_to_all_route` and :func:`route_and_deliver`)
and the fleet's escalation slot arithmetic (:func:`escalation_plan`,
:func:`escalation_recv_slots`).

The reference runs one rank's side under ``shard_map`` and exchanges
buffers with ``all_to_all``.  On one card every rank's buffer is a row
of one tensor: the plans and the scatter/gather take leading batch dims
(a rank or shard dim; a 1-D plan is the reference's single rank), and
the all-to-all is a transpose of the ``[src, dst, ...]`` send buffer.
Given a process ``group`` (one rank a process, ``launch.mesh.spawn``),
:func:`all_to_all_route` and :func:`route_and_deliver` take one rank's
side, as the reference's do, and exchange through
``dist.all_to_all_single``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import sfc
from repro_torch.launch import mesh as M


class DispatchPlan(NamedTuple):
    """Scatter plan for a batch of items to ``num_dest`` buckets."""
    dest: torch.Tensor       # [N] int32 destination bucket per item
    position: torch.Tensor   # [N] int32 slot within the bucket
    keep: torch.Tensor       # [N] bool  item fit under capacity
    overflow: torch.Tensor   # [num_dest] int32 items dropped per bucket
    counts: torch.Tensor     # [num_dest] int32 items kept per bucket


def make_plan(dest: torch.Tensor, num_dest: int,
              capacity: int) -> DispatchPlan:
    """Deterministic first-come-first-kept bucketing (cumsum positions)
    of ``dest [..., N]``: each leading index is planned on its own."""
    dest = dest.to(torch.int32)
    onehot = torch.nn.functional.one_hot(dest.long(), num_dest) \
        .to(torch.int32)                                     # [..., N, D]
    position = torch.cumsum(onehot, -2, dtype=torch.int32) * onehot
    pos = position.sum(-1, dtype=torch.int32) - 1           # [..., N]
    keep = pos < capacity
    total = onehot.sum(-2, dtype=torch.int32)                # [..., D]
    counts = torch.clamp(total, max=capacity)
    return DispatchPlan(dest, pos, keep, total - counts, counts)


def _slots(plan: DispatchPlan, num_dest: int,
           capacity: int) -> torch.Tensor:
    """Flat bucket slots of a plan's items, ``[prod(lead) * N]``: a
    leading index ``b`` owns slots ``b * num_dest * capacity`` on.  A
    destination past ``num_dest`` (a plan's shed bucket, sliced off the
    buffer before a gather) is clamped into range, as the reference's
    gather clamps its index: such items are never kept."""
    slot = (torch.clamp(plan.dest, max=num_dest - 1) * capacity
            + torch.clamp(plan.position, 0, capacity - 1)).long()
    lead = plan.dest.shape[:-1]
    if lead:
        base = torch.arange(slot.numel() // slot.shape[-1],
                            device=slot.device) * (num_dest * capacity)
        slot = slot + base.reshape(lead + (1,))
    return slot.reshape(-1)


def scatter_to_buckets(items: torch.Tensor, plan: DispatchPlan,
                       num_dest: int, capacity: int) -> torch.Tensor:
    """``[..., N, *F]`` items -> ``[..., num_dest, capacity, *F]``
    buckets (zero padding); the leading dims are the plan's.

    An add, as in the reference: kept items own distinct slots and every
    other item adds an exact zero, so the result does not depend on the
    order the adds land in (atomics on the card)."""
    lead = plan.dest.shape[:-1]
    feat = items.shape[len(lead) + 1:]
    keep = plan.keep.reshape(plan.keep.shape + (1,) * len(feat))
    src = torch.where(keep, items, 0).reshape((-1,) + feat)
    buckets = items.new_zeros((src.shape[0] // plan.dest.shape[-1]
                               * num_dest * capacity,) + feat)
    buckets.index_add_(0, _slots(plan, num_dest, capacity), src)
    return buckets.reshape(lead + (num_dest, capacity) + feat)


def gather_from_buckets(buckets: torch.Tensor,
                        plan: DispatchPlan) -> torch.Tensor:
    """Inverse of :func:`scatter_to_buckets` (zeros for overflow)."""
    lead = plan.dest.shape[:-1]
    num_dest, capacity = buckets.shape[len(lead):len(lead) + 2]
    feat = buckets.shape[len(lead) + 2:]
    flat = buckets.reshape((-1,) + feat)
    out = flat[_slots(plan, num_dest, capacity)].reshape(
        plan.dest.shape + feat)
    keep = plan.keep.reshape(plan.keep.shape + (1,) * len(feat))
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
# AR data plane
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
    Returns ([num_ranks, capacity, D] send buffer, plan).  With a
    leading rank dim (``payload [E, N, D]``, ``idx [E, N]``) each rank's
    batch is bucketed on its own: ``[E, num_ranks, capacity, D]``.
    """
    plan = make_plan(_owner(idx, table), num_ranks, capacity)
    return scatter_to_buckets(payload, plan, num_ranks, capacity), plan


def all_to_all_route(send: torch.Tensor, src_dim: int = 0,
                     dst_dim: int = 1, *, group=None) -> torch.Tensor:
    """Exchange every rank's ``[num_ranks, capacity, ...]`` buffer, chunk
    ``i`` going to rank ``i``: with the ranks' buffers stacked as
    ``send[src, dst, ...]`` that is ``recv[dst, src, ...]``, a transpose
    of the two dims (the reference's one ``all_to_all`` on a mesh axis;
    after it, dim ``dst_dim`` indexes the *source* rank).

    ``group``: a process group of ``num_ranks`` ranks; ``send`` is then
    this rank's ``[num_ranks, capacity, ...]`` buffer, exchanged by one
    ``all_to_all_single``, and dim 0 of the result indexes the source
    rank, as the reference's per-rank form."""
    if group is not None:
        return M.all_to_all(send, group)
    return send.transpose(src_dim, dst_dim)


def route_and_deliver(payload: torch.Tensor, idx: torch.Tensor,
                      table: torch.Tensor, num_ranks: int, capacity: int,
                      *, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The full data-plane step for all ``E == num_ranks`` ranks at
    once: bucket each rank's ``payload [E, N, D]`` by owner, exchange.

    Returns (``[E, num_ranks, capacity, D]`` received payloads -- dim 1
    is the *source* rank after the exchange -- and ``[E, num_ranks]``
    receive counts).

    ``group``: a process group of ``num_ranks`` ranks, in the order the
    table names them.  Each rank then passes its own ``payload [N, D]``
    and ``idx [N]``, as under the reference's ``shard_map``: one
    ``all_to_all_single`` exchanges the ``[num_ranks, capacity, D]``
    buffer and a second the counts; it returns the received
    ``[num_ranks, capacity, D]`` (dim 0 the source rank) and the
    ``[num_ranks]`` counts."""
    if group is not None:
        send, plan = route_local(payload, idx, table, num_ranks, capacity)
        recv = all_to_all_route(send, group=group)
        counts = all_to_all_route(plan.counts.reshape(num_ranks, 1),
                                  group=group)
        return recv, counts.reshape(num_ranks)
    if payload.shape[0] != num_ranks:
        raise ValueError(f"route_and_deliver takes one batch a rank: "
                         f"{payload.shape[0]} batches for {num_ranks}")
    send, plan = route_local(payload, idx, table, num_ranks, capacity)
    return all_to_all_route(send), all_to_all_route(plan.counts)


def rank_of_message(profile_batch: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Convenience: encoded profiles [N, 128] -> owner ranks [N]."""
    return _owner(sfc.profile_index(profile_batch), table)


# ---------------------------------------------------------------------------
# Fleet escalation routing (variable per-shard counts under a fixed cap)
# ---------------------------------------------------------------------------

def escalation_plan(escalate: torch.Tensor, offset, num_ranks: int,
                    num_core: int, capacity: int
                    ) -> tuple[DispatchPlan, torch.Tensor]:
    """Route-plan for rule-escalated items from a shard to a core
    sub-mesh (ranks ``0 .. num_core-1`` of a ``num_ranks``-wide axis).

    Every escalated item gets a *global slot* ``g = offset + (index
    among this shard's escalated items)`` -- ``offset`` is the exclusive
    prefix of escalation counts over lower-ranked shards -- and goes to
    core rank ``g % num_core``, so one source never sends more than
    ``ceil(N / num_core)`` items to one destination.

    escalate: ``[..., N]`` bool; offset: ``[...]`` int (one shard's, or
    every shard's with a leading shard dim).  Returns (plan over
    ``num_ranks + 1`` buckets -- the last is the shed bucket of the
    non-escalated items, none kept -- and ``[..., N]`` int32 global
    slots, meaningless where ``~escalate``)."""
    esc = escalate.to(torch.bool)
    e32 = esc.to(torch.int32)
    local = torch.cumsum(e32, -1, dtype=torch.int32) - e32   # exclusive
    off = torch.as_tensor(offset, dtype=torch.int32, device=esc.device)
    g = off[..., None] + local                               # global slot
    dest = torch.where(esc, g % num_core, num_ranks).to(torch.int32)
    plan = make_plan(dest, num_ranks + 1, capacity)
    return plan._replace(keep=plan.keep & esc,
                         overflow=plan.overflow[..., :num_ranks],
                         counts=plan.counts[..., :num_ranks]), g


def escalation_recv_slots(counts: torch.Tensor, rank, num_core: int,
                          capacity: int, budget
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Receive-side dual of :func:`escalation_plan`: which slots of the
    post-exchange ``[num_ranks, capacity]`` buffer hold real records,
    and which fall under the fleet core budget.

    Validity is derived from the per-shard escalation counts: source
    ``s`` holds global slots ``[offset_s, offset_s + counts_s)``, and the
    ones destined to ``rank`` are ``offset_s + ((rank - offset_s) mod
    num_core) + k * num_core``.  The budget is fleet-level: the first
    ``budget`` global slots are processed, wherever they land.

    counts: ``[num_ranks]`` int32; rank: ``[]`` or ``[...]`` (every
    receiving rank at once); budget: an int or a 0-dim tensor.  Returns
    (``[..., num_ranks, capacity]`` bool occupancy under budget, bool
    raw occupancy, int32 global slots)."""
    dev = counts.device
    offsets = torch.cumsum(counts, -1, dtype=torch.int32) - counts
    rank = torch.as_tensor(rank, dtype=torch.int32, device=dev)
    first = (rank[..., None] - offsets) % num_core           # [..., ranks]
    sent = torch.clamp(-(-(counts - first) // num_core), min=0)   # ceil
    k = torch.arange(capacity, dtype=torch.int32, device=dev)
    g = (offsets + first)[..., None] + k * num_core
    occupied = (k < sent[..., None]) & (rank < num_core)[..., None, None]
    return occupied & (g < budget), occupied, g
