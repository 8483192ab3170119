"""Unified ingest admission lane: dedupe window, data contracts, drift
counters, and ingest modes (live | replay | backfill).

Port of ``repro.stream.ingest``.  Between the wire and the ring buffer
every row passes, as fixed-shape masked tensor ops:

1. **stamp** -- the admission identity is ``hash(event_ts ++
   features)``, *excluding* the local ingest wall stamp, so a
   re-delivery with a fresh stamp still hashes identically;
2. **idempotent dedupe** -- FNV-1a event ids over a bounded window of
   the last ``K`` accepted rows (``kernels.dedupe_window``);
3. **contract validation** -- static per-field bounds and finiteness,
   with per-field ``drift`` counts;
4. **mode** -- ``MODE_LIVE`` | ``MODE_REPLAY`` | ``MODE_BACKFILL`` as
   a 0-dim int32 tensor: replay and backfill rows are lateness-exempt
   and never advance the local event-time clock.

Accounting is conservation-exact per tick::

    items_offered == items_accepted + items_rejected + items_deduped
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import device_constant, resolve_device
from repro_torch.kernels.dedupe_window import (dedupe_window, row_hash,
                                               seen_record)

MODE_LIVE = 0
MODE_REPLAY = 1
MODE_BACKFILL = 2

MODE_NAMES = {MODE_LIVE: "live", MODE_REPLAY: "replay",
              MODE_BACKFILL: "backfill"}


@dataclasses.dataclass(frozen=True)
class DataContract:
    """Static per-field admission bounds.

    ``lo`` / ``hi``: optional per-field closed bounds, one entry per
    feature column.  ``require_finite`` rejects NaN/Inf payloads.  A
    row violating ANY field is rejected whole; every violated field
    increments that field's drift counter.
    """
    lo: tuple | None = None
    hi: tuple | None = None
    require_finite: bool = True

    def __post_init__(self):
        if self.lo is not None and self.hi is not None \
                and len(self.lo) != len(self.hi):
            raise ValueError(f"lo/hi length mismatch: {len(self.lo)} "
                             f"vs {len(self.hi)}")

    def violations(self, feats: torch.Tensor) -> torch.Tensor:
        """[N, D] features -> [N, D] bool per-field violation matrix."""
        viol = torch.zeros(feats.shape, dtype=torch.bool, device=feats.device)
        if self.require_finite:
            viol |= ~torch.isfinite(feats)
        if self.lo is not None:
            viol |= feats < device_constant(self.lo, feats.dtype,
                                            feats.device)
        if self.hi is not None:
            viol |= feats > device_constant(self.hi, feats.dtype,
                                            feats.device)
        return viol


@dataclasses.dataclass(frozen=True)
class AdmissionPlan:
    """Static admission policy, carried on ``StreamConfig``.

    ``dedupe_window``: K, the number of most-recently-accepted event
    ids remembered (0 disables dedupe).  ``contract``: optional
    :class:`DataContract`.
    """
    dedupe_window: int = 0
    contract: DataContract | None = None

    def __post_init__(self):
        if self.dedupe_window < 0:
            raise ValueError(
                f"dedupe_window must be >= 0, got {self.dedupe_window}")

    @property
    def inert(self) -> bool:
        """No dedupe, no contract: the executors skip the lane."""
        return self.dedupe_window == 0 and self.contract is None


class AdmissionState(NamedTuple):
    """Dedupe-window state carried in ``StreamState``."""
    seen: torch.Tensor         # [K] int64 accepted-hash ring, [0, 2^32)
    seen_pos: torch.Tensor     # [] int32 next write slot


class AdmissionGate(NamedTuple):
    """One tick's admission verdict, computed before the ring sees the
    batch."""
    admit: torch.Tensor        # [N] bool -- offer these rows to the ring
    hashes: torch.Tensor       # [N] int64 event ids
    n_deduped: torch.Tensor    # [] int32 offered rows dropped as dups
    n_contract: torch.Tensor   # [] int32 offered rows failing contract
    drift: torch.Tensor        # [D] int32 per-field violation counts


def admission_init(plan: AdmissionPlan,
                   device: str | torch.device | None = None
                   ) -> AdmissionState:
    """Fresh (empty) dedupe window for ``plan`` on ``device``
    (``None``: the CUDA card)."""
    device = resolve_device(device)
    return AdmissionState(
        seen=torch.zeros((plan.dedupe_window,), dtype=torch.int64,
                         device=device),
        seen_pos=torch.zeros((), dtype=torch.int32, device=device))


def admission_gate(plan: AdmissionPlan, adm: AdmissionState,
                   ts: torch.Tensor, items: torch.Tensor,
                   offer_mask: torch.Tensor | None) -> AdmissionGate:
    """stamp -> dedupe -> contract.  Dedupe runs first; contract-
    rejected rows are never recorded in the window, so every delivery
    of a violating row is judged fresh and counted as drift again."""
    n = items.shape[0]
    dev = items.device
    offered = torch.ones((n,), dtype=torch.bool, device=dev) \
        if offer_mask is None else offer_mask.to(torch.bool)
    items32 = items.to(torch.float32)
    wire = torch.cat([ts.to(torch.float32)[:, None], items32], dim=1)
    hashes = row_hash(wire)
    fresh, dup = dedupe_window(hashes, offered, adm.seen)
    if plan.contract is None:
        viol = torch.zeros(items.shape, dtype=torch.bool, device=dev)
    else:
        viol = plan.contract.violations(items32)
    ok = ~viol.any(dim=1)
    return AdmissionGate(
        admit=fresh & ok, hashes=hashes,
        n_deduped=dup.sum(dtype=torch.int32),
        n_contract=(fresh & ~ok).sum(dtype=torch.int32),
        drift=(viol & fresh[:, None]).sum(0, dtype=torch.int32))


def admission_record(plan: AdmissionPlan, adm: AdmissionState,
                     gate: AdmissionGate, n_acc: torch.Tensor
                     ) -> AdmissionState:
    """Fold the rows the ring actually accepted into the dedupe window.
    Acceptance is a prefix of the admitted rows in offer order (the
    ring's stable-compaction contract), so rows bounced by backpressure
    stay unrecorded and a later re-send of them admits."""
    if plan.inert:
        return adm
    rank = torch.cumsum(gate.admit.to(torch.int32), 0, dtype=torch.int32) - 1
    accepted = gate.admit & (rank < n_acc)
    seen, pos = seen_record(adm.seen, adm.seen_pos, gate.hashes, accepted)
    return AdmissionState(seen=seen, seen_pos=pos)
