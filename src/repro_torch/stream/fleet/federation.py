"""Cross-shard federation of the edge fleet, all shards at once.

Port of ``repro.stream.fleet.federation``.  The reference runs each
function on one shard's block under ``shard_map`` and agrees with the
other shards through collectives.  On one card every shard is a row of
the same tensors, so each function here takes and returns the whole
fleet's tensors (a leading shard dim, region-major) and the collectives
become tensor ops over that dim:

===========================  =========================================
reference (per shard)        port (all shards at once)
===========================  =========================================
``all_gather`` of counts     the ``[E]`` or ``[R, E]`` count tensor
``axis_index``               ``arange``
``pmin``                     ``amin`` over the edge dim, then regions
``psum``                     ``sum`` over the shard dim
``all_to_all``               a transpose of the ``[src, dst, ...]``
                             send buffer (``core.routing``)
===========================  =========================================

Three fleet-wide agreements turn the shards into one system: the
watermark (the minimum of the per-shard maxima, layered over health and
membership), the escalation routing (deterministic global slots, then
the exchange to the core ranks), and the core budget (the first
``core_budget`` global slots get core compute; the rest keep their edge
results).  Nothing here reads a device value on the host.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import routing as RT
from repro_torch.stream.fleet.routing import (fog_recv_occupancy,
                                              region_survivor_counts)

_F32_MAX = torch.finfo(torch.float32).max


def _layered(max_ts: torch.Tensor, healthy, active
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked candidates ``[healthy&active min, active min, plain
    min, 0-iff-any-healthy&active, 0-iff-any-active]`` over the last dim,
    as the reference's one stacked ``pmin`` builds them, and the layered
    choice among them."""
    ones = torch.ones((), dtype=torch.bool, device=max_ts.device)
    h = ones if healthy is None else healthy.to(torch.bool)
    a = ones if active is None else active.to(torch.bool)
    ha = h & a
    big = torch.full((), _F32_MAX, dtype=max_ts.dtype, device=max_ts.device)
    f = max_ts.dtype
    vec = torch.stack(torch.broadcast_tensors(
        torch.where(ha, max_ts, big), torch.where(a, max_ts, big), max_ts,
        1.0 - ha.to(f), 1.0 - a.to(f)))
    m = vec.amin(-1)
    return m, torch.where(m[3] < 0.5, m[0],
                          torch.where(m[4] < 0.5, m[1], m[2]))


def fleet_watermark(max_ts: torch.Tensor, healthy=None,
                    active=None) -> torch.Tensor:
    """Fleet watermark of a flat fleet: the min over shards (``max_ts
    [E]``) of the per-shard max event time, layered healthy & active ->
    active -> plain, as the reference's.  Flagged (unhealthy) shards are
    left out of the min; a departed (inactive) shard contributes
    nothing; a fully inactive fleet falls back to the plain min.
    Returns the 0-dim value every shard shares."""
    if healthy is None and active is None:
        return max_ts.amin(-1)
    return _layered(max_ts, healthy, active)[1]


def tiered_watermark(max_ts: torch.Tensor, healthy=None, active=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Layered fleet watermark over ``max_ts [R, E]`` (region, edge):
    returns ``(fleet_wm [], region_wm [R])``, the values the reference
    replicates over the fleet and within each region.

    The region watermark applies :func:`fleet_watermark`'s layered
    fallback over the edge dim; the fleet watermark layers it again over
    the regions: regions with any healthy & active member first, then
    regions with any active member, then the plain min.  With one
    region this is :func:`fleet_watermark`; with every shard healthy
    and active both tiers are the plain min."""
    m, region_wm = _layered(max_ts, healthy, active)
    big = torch.full((), _F32_MAX, dtype=max_ts.dtype, device=max_ts.device)
    fvec = torch.stack([torch.where(m[3] < 0.5, region_wm, big),
                        torch.where(m[4] < 0.5, region_wm, big),
                        region_wm, m[3], m[4]])
    fm = fvec.amin(-1)
    fleet_wm = torch.where(fm[3] < 0.5, fm[0],
                           torch.where(fm[4] < 0.5, fm[1], fm[2]))
    return fleet_wm, region_wm


def layered_min_ref(max_ts, healthy=None, active=None) -> float:
    """Host-side numpy reference of one layered watermark level (the
    healthy&active -> active -> plain fallback)."""
    max_ts = np.asarray(max_ts, np.float64)
    h = np.ones(max_ts.shape, bool) if healthy is None \
        else np.asarray(healthy, bool)
    a = np.ones(max_ts.shape, bool) if active is None \
        else np.asarray(active, bool)
    ha = h & a
    if ha.any():
        return float(max_ts[ha].min())
    if a.any():
        return float(max_ts[a].min())
    return float(max_ts.min())


def tiered_watermark_ref(max_ts, healthy=None, active=None
                         ) -> tuple[float, np.ndarray]:
    """Host-side numpy reference of :func:`tiered_watermark`:
    ``max_ts``/masks are [R, E]; returns ``(fleet_wm, [R] region_wms)``."""
    max_ts = np.asarray(max_ts, np.float64)
    r, _ = max_ts.shape
    h = np.ones(max_ts.shape, bool) if healthy is None \
        else np.asarray(healthy, bool)
    a = np.ones(max_ts.shape, bool) if active is None \
        else np.asarray(active, bool)
    region = np.asarray([layered_min_ref(max_ts[i], h[i], a[i])
                         for i in range(r)])
    has_ha = (h & a).any(axis=1)
    has_a = a.any(axis=1)
    if has_ha.any():
        fleet = region[has_ha].min()
    elif has_a.any():
        fleet = region[has_a].min()
    else:
        fleet = region.min()
    return float(fleet), region


class FederationStats(NamedTuple):
    """Per-step counters of the flat exchange, ``[E]`` int32 each."""
    escalations_sent: torch.Tensor   # each shard's records routed out
    core_received: torch.Tensor      # records landing on each core rank
    core_processed: torch.Tensor     # of those, under the fleet budget
    fleet_escalations: torch.Tensor  # fleet total this step (replicated)
    fleet_overflow: torch.Tensor     # fleet total beyond budget (replicated)


class LineageTaps(NamedTuple):
    """Per-hop lineage measurement points of the tiered exchange, one
    row a shard: the ingest stamps in each hop's receive buffer and
    their occupancy.  ``hop1`` populates only on fog columns, ``hop2``
    only on region 0's core ranks."""
    hop1_birth: torch.Tensor       # [S, E * edge_capacity] f32 stamps
    hop1_mask: torch.Tensor        # [S, E * edge_capacity] bool occupancy
    hop2_birth: torch.Tensor       # [S, R * cross_capacity] f32 stamps
    hop2_mask: torch.Tensor        # [S, R * cross_capacity] bool occupancy


class TieredStats(NamedTuple):
    """Per-step counters of the two-hop exchange, ``[S]`` int32 each."""
    escalations_sent: torch.Tensor    # each shard's fog-budget survivors
    fog_shed: torch.Tensor            # each shard's candidates shed by
    #                                   its region's fog budget
    core_received: torch.Tensor       # records landing on each core rank
    core_processed: torch.Tensor      # of those, under the fleet budget
    region_escalations: torch.Tensor  # region candidate total (replicated
    #                                   within the region)
    fleet_escalations: torch.Tensor   # fleet survivor total (replicated)
    fleet_overflow: torch.Tensor      # fleet survivors beyond the core
    #                                   budget (replicated)


def _i32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(v, np.int32), device=device)


def _run_core_ranks(core_fn: Callable, recv: torch.Tensor,
                    under: torch.Tensor, num_core: int, c_core: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The core stage: each core rank ``0..num_core-1`` (the leading dim
    of ``recv [ranks, M, row]`` and ``under [ranks, M]``) compacts its
    under-budget records into ``c_core`` rows and runs ``core_fn`` on
    them, one rank after another.  Other ranks receive nothing, so
    their results are zeros.  Returns the ``[ranks, M, R + F + 1]``
    response payload (outputs, features, a 1.0 where processed) and the
    ``[ranks]`` processed counts."""
    ranks, m = under.shape
    parts, done = [], []
    for e in range(num_core):
        out, feats, d = RT.compact_apply(core_fn, recv[e], under[e], c_core)
        parts.append(torch.cat([out, feats, d.to(out.dtype)[:, None]], 1))
        done.append(d.sum(dtype=torch.int32))
    payload = parts[0].new_zeros((ranks, m, parts[0].shape[1]))
    payload[:num_core] = torch.stack(parts)
    processed = torch.zeros((ranks,), dtype=torch.int32, device=recv.device)
    processed[:num_core] = torch.stack(done)
    return payload, processed


def _at_region0(x: torch.Tensor, num_regions: int) -> torch.Tensor:
    """Region 0's ``[E, ...]`` values, then zeros for the other regions'
    shards (which hold no core rank): ``[R * E, ...]``."""
    pad = [0, 0] * (x.ndim - 1) + [0, (num_regions - 1) * x.shape[0]]
    return torch.nn.functional.pad(x, pad)


def federate_escalations(records: torch.Tensor, escalate: torch.Tensor,
                         run_core: Callable, *, num_shards: int,
                         num_core: int, core_budget, capacity: int,
                         core_slots: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, FederationStats]:
    """Route every shard's escalated records to the core ranks, process
    under the fleet budget, scatter the results back: one exchange each
    way.

    records: ``[E, N, R]`` window records (edge-stage outputs);
    escalate: ``[E, N]`` bool; run_core: compact ``[C, R] -> ([C, R],
    [C, F])``.  ``capacity`` is the per-(src, dest) slot count
    (``>= ceil(N / num_core)`` sheds nothing on the send side).
    ``core_budget`` may be a 0-dim tensor; ``core_slots`` (defaults to
    ``core_budget``, then a Python int) sizes each core rank's compact
    batch, ``ceil(core_slots / num_core)`` rows.

    Returns (``[E, N, R]`` core outputs, ``[E, N, F]`` core features,
    ``[E, N]`` bool processed, stats)."""
    if core_slots is None:
        core_slots = int(core_budget)
    e, _, r = records.shape
    dev = records.device
    if e != num_shards:
        raise ValueError(f"records hold {e} shards, want {num_shards}")
    core_budget = _i32(core_budget, dev)
    esc = escalate.to(torch.bool)
    counts = esc.sum(-1, dtype=torch.int32)                      # [E]
    offset = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    plan, _ = RT.escalation_plan(esc, offset, e, num_core, capacity)
    send = RT.scatter_to_buckets(records, plan, e + 1, capacity)[:, :e]
    recv = RT.all_to_all_route(send)                  # [E, E_src, cap, R]
    ranks = torch.arange(e, dtype=torch.int32, device=dev)
    under, occupied, _ = RT.escalation_recv_slots(
        counts, ranks, num_core, capacity, core_budget)
    c_core = max(1, -(-core_slots // num_core))
    payload, processed_n = _run_core_ranks(
        run_core, recv.reshape(e, e * capacity, r),
        under.reshape(e, e * capacity), num_core, c_core)
    w = payload.shape[-1]
    back = RT.all_to_all_route(payload.reshape(e, e, capacity, w))
    resp = RT.gather_from_buckets(back, plan)                    # [E, N, w]
    total = counts.sum(dtype=torch.int32)
    stats = FederationStats(
        escalations_sent=counts,
        core_received=occupied.sum((-2, -1), dtype=torch.int32),
        core_processed=processed_n,
        fleet_escalations=total.expand(e),
        fleet_overflow=torch.clamp(total - core_budget, min=0).expand(e))
    return (resp[..., :r], resp[..., r:w - 1],
            (resp[..., -1] > 0.5) & plan.keep, stats)


def federate_escalations_tiered(
        records: torch.Tensor, escalate: torch.Tensor, run_core: Callable,
        *, num_regions: int, edges_per_region: int, num_core: int,
        region_budget, core_budget, edge_capacity: int, cross_capacity: int,
        core_slots: int, birth: torch.Tensor | None = None):
    """Two-hop escalation exchange over the ``(region, edge)`` shards:
    fog pre-aggregation within each region, then only region survivors
    cross to the core ranks (region 0, edge columns ``0..num_core-1``).

    records: ``[S, N, R]`` (S = regions x edges, region-major);
    escalate: ``[S, N]`` bool; region_budget: each region's fog budget
    (an int or ``[R]``); core_budget: an int or a 0-dim tensor;
    ``edge_capacity``, ``cross_capacity`` and ``core_slots`` are the
    shape ceilings.  The slot discipline is the reference's:

    1. candidates get region-local slots (edge-major); the first
       ``region_budget`` survive, the rest are shed and keep their edge
       results (``fog_shed``);
    2. survivor totals turn region-local slots into global slots
       (region-major; with a non-binding fog budget these are the flat
       fleet's slots);
    3. hop 1: survivors go to fog column ``g % num_core`` of their
       region, buffer ``[E, edge_capacity, row]`` a shard;
    4. each fog column compacts what it received (in ascending global
       slot) into ``[cross_capacity, row]``;
    5. hop 2 delivers every region's compact batch to region 0, where
       receive validity and the core budget come from the survivor
       totals alone; the results retrace both hops.

    ``birth``: optional ``[S, N]`` f32 ingest stamps, carried as one
    more wire column (stripped before ``run_core``); the return then
    grows a fifth element, :class:`LineageTaps`.

    Returns (``[S, N, R]`` core outputs, ``[S, N, F]`` core features,
    ``[S, N]`` bool processed, :class:`TieredStats`[, taps])."""
    rr, ee = num_regions, edges_per_region
    s, n, r = records.shape
    dev = records.device
    if s != rr * ee:
        raise ValueError(f"records hold {s} shards, want {rr} x {ee}")
    if birth is not None:
        # the stamp is wire metadata, not a record column: the core fn
        # gets the records without it
        records = torch.cat([records, birth.to(records.dtype)[..., None]],
                            dim=-1)

        def core_fn(b):
            return run_core(b[:, :r].contiguous())
    else:
        core_fn = run_core
    rw = records.shape[-1]                              # wire row width
    rec = records.reshape(rr, ee, n, rw)
    rbud = _i32(region_budget, dev).expand(rr)
    core_budget = _i32(core_budget, dev)
    esc = escalate.to(torch.bool).reshape(rr, ee, n)
    e32 = esc.to(torch.int32)
    counts = e32.sum(-1, dtype=torch.int32)                      # [R, E]
    off_e = torch.cumsum(counts, -1, dtype=torch.int32) - counts

    # fog budget: the first region_budget region-local slots survive;
    # a shard's shed candidates are always a suffix of its own
    q = off_e[..., None] + torch.cumsum(e32, -1, dtype=torch.int32) - e32
    surv = esc & (q < rbud[:, None, None])
    surv_counts = region_survivor_counts(counts, rbud[:, None])  # [R, E]
    my_surv = surv.sum(-1, dtype=torch.int32)
    rs_all = surv_counts.sum(-1, dtype=torch.int32)              # [R]
    roff = torch.cumsum(rs_all, 0, dtype=torch.int32) - rs_all

    # hop 1, within each region, to fog column g % num_core
    plan1, _ = RT.escalation_plan(surv, roff[:, None] + off_e, ee, num_core,
                                  edge_capacity)
    send1 = RT.scatter_to_buckets(rec, plan1, ee + 1, edge_capacity)[:, :, :ee]
    recv1 = RT.all_to_all_route(send1, 1, 2)       # [R, E, E_src, cap1, RW]
    cols = torch.arange(ee, dtype=torch.int32, device=dev)
    occ1 = fog_recv_occupancy(surv_counts[:, None, :], cols[:, None],
                              roff[:, None, None], num_core, edge_capacity)
    occ1 = occ1.reshape(rr, ee, ee * edge_capacity)

    # each fog column compacts its survivors (ascending global slot)
    plan2 = RT.make_plan(torch.where(occ1, 0, 1).to(torch.int32), 2,
                         cross_capacity)
    compact = RT.scatter_to_buckets(
        recv1.reshape(rr, ee, ee * edge_capacity, rw), plan2, 2,
        cross_capacity)[:, :, 0]                        # [R, E, cap2, RW]

    # hop 2, across regions: every region's compact batch goes to
    # region 0, whose fog columns are the core ranks
    core_in = compact.transpose(0, 1).reshape(ee, rr * cross_capacity, rw)

    # the cloud side: validity and the core budget from the survivor
    # totals, at region 0 only
    under2, occ2, _ = RT.escalation_recv_slots(rs_all, cols, num_core,
                                               cross_capacity, core_budget)
    c_core = max(1, -(-core_slots // num_core))
    payload, processed_n = _run_core_ranks(
        core_fn, core_in, under2.reshape(ee, rr * cross_capacity),
        num_core, c_core)
    w = payload.shape[-1]

    # the way back: cloud -> fog column -> origin shard, un-compacting
    # with the same plans (bucket 0 of plan2 holds the occupied slots)
    resp_region = payload.reshape(ee, rr, cross_capacity, w) \
        .transpose(0, 1)                                 # [R, E, cap2, w]
    flat_back = torch.where(
        occ1[..., None],
        RT.gather_from_buckets(resp_region[:, :, None], plan2),
        0)                                               # [R, E, E*cap1, w]
    back1 = RT.all_to_all_route(
        flat_back.reshape(rr, ee, ee, edge_capacity, w), 1, 2)
    resp = RT.gather_from_buckets(back1, plan1).reshape(s, n, w)
    processed = (resp[..., -1] > 0.5) & plan1.keep.reshape(s, n)

    fleet_surv = rs_all.sum(dtype=torch.int32)
    stats = TieredStats(
        escalations_sent=my_surv.reshape(s),
        fog_shed=(counts - my_surv).reshape(s),
        core_received=_at_region0(occ2.sum((-2, -1), dtype=torch.int32),
                                  rr),
        core_processed=_at_region0(processed_n, rr),
        region_escalations=counts.sum(-1, dtype=torch.int32)[:, None]
        .expand(rr, ee).reshape(s),
        fleet_escalations=fleet_surv.expand(s),
        fleet_overflow=torch.clamp(fleet_surv - core_budget,
                                   min=0).expand(s))
    out = (resp[..., :r], resp[..., r:w - 1], processed, stats)
    if birth is None:
        return out
    taps = LineageTaps(
        hop1_birth=recv1.reshape(s, ee * edge_capacity, rw)[..., -1],
        hop1_mask=occ1.reshape(s, ee * edge_capacity),
        hop2_birth=_at_region0(core_in[..., -1], rr).reshape(
            s, rr * cross_capacity),
        hop2_mask=_at_region0(occ2, rr).reshape(s, rr * cross_capacity))
    return out + (taps,)


def allreduce_metrics(metrics):
    """Sum a NamedTuple of ``[S]`` (or ``[S, D]``) counters over the
    shard dim, replicated back to every shard, as the reference's
    ``psum`` leaves them.  The scalar counters ride one stacked sum."""
    leaves = list(metrics)
    scalar = [i for i, v in enumerate(leaves) if v.ndim == 1]
    out = list(leaves)
    if scalar:
        stack = torch.stack([leaves[i] for i in scalar])         # [L, S]
        tot = stack.sum(1, dtype=stack.dtype)[:, None].expand_as(stack)
        for j, i in enumerate(scalar):
            out[i] = tot[j]
    for i, v in enumerate(leaves):
        if i not in scalar:
            out[i] = v.sum(0, dtype=v.dtype).expand_as(v)
    return type(metrics)(*out)
