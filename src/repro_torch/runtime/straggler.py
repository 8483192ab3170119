"""Straggler mitigation: deadline-based backup re-execution bookkeeping.

Port of ``repro.runtime.straggler``, host-side numpy: a copy.

In a synchronous SPMD pod a slow chip stalls the whole step (every
collective is a barrier).  Production mitigation is (a) detect the
persistent straggler from per-step, per-rank timing, (b) re-slot the
physical chip out (elastic re-mesh) or re-execute its *input shard* on
a healthy backup rank (for data-parallel work, the microbatch is
re-dispatchable — the paper's "function profiles can run at any
matching RP" applied to gradient shards).

The detector is host-side and framework-agnostic: feed it wall-times,
it yields (straggler ranks, reassignment plan).  The stream fleet's
control plane (``stream.fleet.control``) reuses it for two
signals: per-shard step wall-times and per-shard event-time *lag*
(how far a shard's watermark trails the fleet max) — the ``floor``
field supports the second use, where the healthy baseline is ~0 and a
purely relative threshold would never fire.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerDetector:
    num_ranks: int
    window: int = 20           # steps of history
    threshold: float = 1.5     # x median = straggler
    patience: int = 3          # consecutive flags before acting
    floor: float = 0.0         # absolute cut when the median carries no signal
    _hist: list = dataclasses.field(default_factory=list)
    _flags: np.ndarray = None

    def __post_init__(self):
        if self._flags is None:
            self._flags = np.zeros(self.num_ranks, np.int32)

    def observe(self, step_times: np.ndarray) -> list[int]:
        """step_times: [num_ranks] seconds for the last step.  Returns
        ranks that crossed the patience threshold this step.

        Non-positive times are treated as *missing measurements* (a
        dead rank reports nothing, warm-up steps report zeros): they
        are excluded from the per-rank medians, so an all-zero warm-up
        cannot dilute the baseline into ``global_med == 0`` and turn
        the threshold comparison degenerate.  When the fleet median
        carries no signal at all, the absolute ``floor`` (if set) is
        the cut; with no floor either, nothing is flagged — garbage
        timings never manufacture stragglers.
        """
        st = np.asarray(step_times, np.float64)
        if st.shape != (self.num_ranks,):
            raise ValueError(
                f"step_times must be one measurement per rank, shape "
                f"({self.num_ranks},), got {st.shape} — a misaligned "
                f"telemetry feed would silently flag the wrong ranks")
        self._hist.append(st)
        if len(self._hist) > self.window:
            self._hist.pop(0)
        med, has_signal = self._medians()
        global_med = float(np.median(med[has_signal])) \
            if has_signal.any() else 0.0
        cut = max(self.threshold * global_med, self.floor)
        if cut > 0.0:
            slow = (med > cut) & has_signal
        else:
            slow = np.zeros(self.num_ranks, bool)
        self._flags = np.where(slow, self._flags + 1, 0)
        return [int(r) for r in np.nonzero(self._flags == self.patience)[0]]

    def _medians(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-rank median over the *present* (positive) history
        samples, plus the has-any-signal mask.  Zeros are missing
        measurements and never dilute the median."""
        if not self._hist:
            # no observations yet (a leave at tick 0, or right after a
            # re-mesh rebuilt the detector): every rank is signal-less,
            # so reassignment falls back to deterministic index order
            return (np.zeros(self.num_ranks),
                    np.zeros(self.num_ranks, bool))
        stack = np.stack(self._hist)                       # [h, R]
        seen = stack > 0.0
        has_signal = seen.any(axis=0)
        med = np.where(
            has_signal,
            np.ma.median(np.ma.masked_array(stack, ~seen), axis=0)
            .filled(0.0), 0.0)
        return med, has_signal

    def stragglers(self) -> list[int]:
        """Ranks currently past the patience threshold (flag state, not
        just the step they crossed — the control plane polls this)."""
        return [int(r) for r in np.nonzero(self._flags >= self.patience)[0]]

    def reassignment(self, stragglers: list[int]) -> dict[int, int]:
        """Backup plan: straggler's shard re-executes on the least-loaded
        healthy rank (deterministic: lowest *present-sample* median —
        a rank that stopped reporting is not "fast", it goes to the
        back of the line).  With no healthy rank left there is nowhere
        to re-execute: empty plan."""
        if not stragglers:
            return {}
        med, has_signal = self._medians()
        healthy = [r for r in range(self.num_ranks) if r not in stragglers]
        if not healthy:
            return {}
        order = sorted(healthy, key=lambda r: (not has_signal[r], med[r]))
        return {s: order[i % len(order)] for i, s in enumerate(stragglers)}
