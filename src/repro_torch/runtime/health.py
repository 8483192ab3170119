"""Failure detection + deterministic master election (paper §IV-A).

Port of ``repro.runtime.health``, host-side numpy: a copy, over the
port's ``core.overlay.Overlay``.

The paper uses keep-alive messages and the Hirschberg–Sinclair ring
election.  In a fail-stop SPMD pod, liveness is observed by the
launcher (a chip that misses a heartbeat window is declared dead) and
election needs no messages: every survivor computes the same
``min(live ranks in region)`` — the same guarantee (unique master,
agreement among survivors) at zero message cost (DESIGN.md §2).

This module is host-side bookkeeping used by the launcher and the
elastic/restart paths; it drives ``Overlay.on_failure`` rebuilds.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.overlay import Overlay


@dataclasses.dataclass
class HealthMonitor:
    num_ranks: int
    timeout_s: float = 10.0
    _last_seen: np.ndarray = None
    _alive: np.ndarray = None

    def __post_init__(self):
        now = time.monotonic()
        if self._last_seen is None:
            self._last_seen = np.full(self.num_ranks, now)
        if self._alive is None:
            self._alive = np.ones(self.num_ranks, bool)

    def heartbeat(self, rank: int, t: float | None = None):
        self._last_seen[rank] = time.monotonic() if t is None else t

    def sweep(self, now: float | None = None) -> list[int]:
        """Mark ranks dead whose heartbeat lapsed; returns newly dead."""
        now = time.monotonic() if now is None else now
        lapsed = (now - self._last_seen) > self.timeout_s
        newly = np.nonzero(lapsed & self._alive)[0]
        self._alive[newly] = False
        return [int(r) for r in newly]

    @property
    def alive(self) -> np.ndarray:
        return self._alive.copy()

    def apply_to_overlay(self, ov: Overlay) -> Overlay:
        """Rebuild the overlay against current liveness (masters re-elected
        deterministically inside Overlay)."""
        out = ov
        for r in np.nonzero(~self._alive & ov.alive)[0]:
            out = out.on_failure(int(r))
        return out
