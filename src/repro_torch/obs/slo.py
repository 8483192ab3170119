"""SLO lane: declared latency/drop targets + multi-window burn-rate
evaluation over the lineage histograms.

Port of ``repro.obs.slo``, host-side numpy: a copy.

An :class:`SLO` declares an objective over one lineage stage ("99% of
end-to-end latencies under 50 ms") or over the drop counters.  The
:class:`SloEvaluator` turns the executors' *cumulative* telemetry into
per-tick good/bad deltas and evaluates the **multi-window burn rate**
(the Google SRE alerting recipe): the burn rate is the error rate
normalized by the error budget,

    burn = bad/(good+bad) / (1 - objective)

so burn 1.0 exactly spends the budget over the SLO period, and burn
``burn_threshold`` (say 14.4) spends it that many times faster.  An
alert fires only when BOTH a **fast** window (recent ticks — is it
happening *now*?) and a **slow** window (a longer tail — is it real,
not a blip?) exceed the threshold: the fast window gates alert reset
time, the slow window suppresses one-tick noise.  Breach/recover are
*transitions* — the evaluator reports each edge exactly once, which is
what ``FleetController`` forwards into the ``EventLog`` as
``slo_breach``/``slo_recover`` and exposes to policies as a signal.

Latency goodness is read straight off the on-device lineage banks
(:mod:`repro_torch.obs.latency`): a sample is *good* when its bucket's upper
edge is at or under the target — the bucket straddling the target
counts **bad** (conservative: a breach is never under-reported because
of bucket resolution).  Windows are measured in ticks, not wall time:
the evaluator sees exactly one observation per control-plane tick, so
a tick is the natural alerting quantum.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.obs.latency import DEFAULT_EDGES, LINEAGE_STAGES

#: Stages an SLO may target: the lineage stages plus the drop lane
#: (windows_dropped / windows_emitted from the fleet counters).
SLO_STAGES = LINEAGE_STAGES + ("drops",)


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective.  ``objective`` is the good fraction
    (0.99 = "99% good"); ``target_seconds`` bounds the stage latency
    (ignored for ``stage="drops"``, where any dropped window is bad).
    ``fast_window``/``slow_window`` are tick counts; ``burn_threshold``
    is the multi-window alerting threshold in budget-burn multiples."""
    name: str
    target_seconds: float = 0.0
    stage: str = "e2e"
    objective: float = 0.99
    fast_window: int = 5
    slow_window: int = 30
    burn_threshold: float = 2.0

    def __post_init__(self):
        if self.stage not in SLO_STAGES:
            raise ValueError(f"stage must be one of {SLO_STAGES}, "
                             f"got {self.stage!r}")
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{self.objective}")
        if self.stage != "drops" and self.target_seconds <= 0.0:
            raise ValueError(f"latency SLO needs target_seconds > 0, "
                             f"got {self.target_seconds}")
        if not (1 <= self.fast_window <= self.slow_window):
            raise ValueError(f"need 1 <= fast_window <= slow_window, got "
                             f"{self.fast_window}/{self.slow_window}")
        if self.burn_threshold <= 0.0:
            raise ValueError(f"burn_threshold must be > 0, got "
                             f"{self.burn_threshold}")


class SloStatus(NamedTuple):
    """One SLO's state after a tick.  ``breached``/``recovered`` mark
    the *transition* on this tick (at most one of them True);
    ``breaching`` is the level."""
    slo: SLO
    fast_burn: float
    slow_burn: float
    breaching: bool
    breached: bool       # False -> True transition happened this tick
    recovered: bool      # True -> False transition happened this tick


def _good_bucket_count(target_seconds: float, edges=DEFAULT_EDGES) -> int:
    """Buckets whose whole range is <= target: a bucket's value is its
    upper edge, so the straddling bucket counts bad (conservative)."""
    return int(np.searchsorted(np.asarray(edges, np.float64),
                               target_seconds, side="right"))


class SloEvaluator:
    """Tracks per-SLO good/bad deltas over sliding tick windows and
    evaluates the multi-window burn rate.

    Call :meth:`observe` once per tick with the *cumulative* pooled
    lineage bank (``[n_stages, buckets]`` host ints — e.g.
    ``FleetExecutor.lineage_counts()``) and, for drop SLOs, the
    cumulative ``(dropped, emitted)`` counters.  The evaluator
    differences consecutive observations internally, so callers hand
    over raw telemetry, not deltas.  Ticks with zero new samples for a
    stage leave that SLO's burn rates unchanged (no data is not an
    error *or* a recovery)."""

    def __init__(self, slos, edges=DEFAULT_EDGES):
        self.slos = tuple(slos)
        names = [s.name for s in self.slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._edges = np.asarray(edges, np.float64)
        self._prev_bank = None
        self._prev_drops = None
        # per-slo ring of (good, bad) per-tick deltas, slow_window long
        self._hist = {s.name: [] for s in self.slos}
        self._breaching = {s.name: False for s in self.slos}

    def _stage_delta(self, slo, bank, drops):
        if slo.stage == "drops":
            if drops is None:
                return 0, 0
            dropped, emitted = (int(x) for x in drops)
            pd, pe = (0, 0) if self._prev_drops is None else self._prev_drops
            bad = dropped - pd
            good = (emitted - pe) - bad
            return max(good, 0), max(bad, 0)
        if bank is None:
            return 0, 0
        i = LINEAGE_STAGES.index(slo.stage)
        row = np.asarray(bank, np.int64)[i]
        prev = np.zeros_like(row) if self._prev_bank is None \
            else np.asarray(self._prev_bank, np.int64)[i]
        d = np.maximum(row - prev, 0)
        k = _good_bucket_count(slo.target_seconds, self._edges)
        return int(d[:k].sum()), int(d[k:].sum())

    @staticmethod
    def _burn(window, objective):
        good = sum(g for g, _ in window)
        bad = sum(b for _, b in window)
        if good + bad == 0:
            return 0.0
        return (bad / (good + bad)) / (1.0 - objective)

    def observe(self, bank=None, drops=None) -> list[SloStatus]:
        """Ingest one tick of cumulative telemetry; return every SLO's
        status (transitions marked)."""
        out = []
        for slo in self.slos:
            good, bad = self._stage_delta(slo, bank, drops)
            hist = self._hist[slo.name]
            # a tick with zero new samples holds the burn rates (no
            # data is not an error *or* a recovery): the windows slide
            # over ticks-with-data, not raw ticks
            if good or bad or not hist:
                hist.append((good, bad))
                del hist[:-slo.slow_window]
            fast = self._burn(hist[-slo.fast_window:], slo.objective)
            slow = self._burn(hist, slo.objective)
            level = fast >= slo.burn_threshold and \
                slow >= slo.burn_threshold
            was = self._breaching[slo.name]
            self._breaching[slo.name] = level
            out.append(SloStatus(slo=slo, fast_burn=fast, slow_burn=slow,
                                 breaching=level,
                                 breached=level and not was,
                                 recovered=was and not level))
        if bank is not None:
            self._prev_bank = np.array(np.asarray(bank, np.int64))
        if drops is not None:
            self._prev_drops = tuple(int(x) for x in drops)
        return out

    @property
    def breaching(self) -> tuple:
        """Names of SLOs currently in breach (level, not transition)."""
        return tuple(n for n, b in self._breaching.items() if b)
