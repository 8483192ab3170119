"""Adaptive fleet control plane: elastic core budget + straggler-aware
watermark, as one host-side loop between device ticks.

Port of ``repro.stream.fleet.control`` over the port's
``FleetExecutor``.  The fault and churn scripts (``Fault``, ``Churn``,
``FaultSchedule``, ``FaultInjector``) are host numpy, copied.  What
differs from the reference, where the reference reads or writes the
device:

* :meth:`FleetController.tick` reads everything it needs in ONE
  device-to-host transfer a tick (the reference's one
  ``jax.device_get``): the float32 leaves ride as their int32 bits in
  one concatenated int32 tensor.  The SLO lane's drop counters ride the
  same transfer; the lineage bank is read only when a latency SLO
  needs it.
* :meth:`~FleetController.begin_replay_carry` and
  :meth:`~FleetController.end_replay_carry` return a new state whose
  ``carry`` and ``carry_valid`` are clones, written there, never the
  caller's tensors (the reference's ``.at[].set``); the stash stays on
  the device.
* :meth:`~FleetController.remesh` takes a shard count where the
  reference takes a device list (``FleetExecutor.remesh``).
* :attr:`~FleetController.max_trace_count` is ``1 + retraces +
  remeshes``, host counting as in the reference, and it bounds the
  executor's own ``trace_count`` (the tick signatures its compile-once
  step built): ``trace_count <= max_trace_count``, and before any
  remesh ``max_trace_count <= 1 + resizes``.

The paper's edge tier is Raspberry-Pi-class hardware that slows down,
stalls, and churns; the data plane alone assumes a healthy fleet (a
static ``core_budget``, a plain fleet-min watermark that one dead shard
freezes fleet-wide).  ``FleetController`` closes both gaps with a
per-tick observe -> decide -> actuate loop that never touches the
data path's *shapes*:

            ┌────────────────────── host ──────────────────────┐
            │   FleetController.tick()                         │
            │   wall-time ──> StragglerDetector ─┐             │
            │   event-lag ──> StragglerDetector ─┼─> health    │
            │   escalations ─> ElasticBudget ────┼─> budget    │
            └──────────────┬─────────────────────┼─────────────┘
                  operands │ (same shapes)       │
            ┌──────────────▼─────────────────────▼── device ───┐
            │  FleetExecutor.step(state, items, ts, offered)   │
            │  wm = pmin over HEALTHY shards; excluded shards  │
            │  fall back to their own watermark (catch-up) and │
            │  count late-vs-fleet records in late_excluded    │
            └──────────────────────────────────────────────────┘

* **Elastic core budget** — per-shard escalation counts (already in
  ``FleetMetrics``) feed an ``runtime.elastic.ElasticBudget`` policy;
  sustained pressure grows the budget, idle ticks shrink it.  The
  budget is an operand of the tick, so resizes within the slot ceiling
  change no shape; growing past the ceiling grows the core batch once,
  and the executor builds the tick anew for it: ``trace_count <= 1 +
  resizes``.
* **Straggler-aware watermark** — per-shard step wall-times and
  per-shard max event times feed two ``runtime.straggler``
  detectors (wall-clock slowness; event-time lag behind the fleet
  max).  Flagged shards are excluded from the watermark ``pmin`` via
  a health mask, so a stalled shard no longer blocks window close for
  healthy shards.  The excluded shard keeps processing against its
  *own* watermark — the catch-up path — and every record it admits
  past the fleet reference lands in the ``late_excluded`` counter,
  never a silent drop.  The published fleet reference is *monotone*
  (the executor clamps it against the previous tick), and re-admission
  waits until the shard's lag is inside the stream's lateness bound —
  so rejoining never rolls the watermark back and never converts the
  catch-up backlog into silent late-drops.  When its timings/lag
  normalize the shard rejoins the ``pmin`` automatically.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs.events import EventLog
from repro_torch.obs.slo import SloEvaluator
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.elastic import ElasticBudget
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.stream.fleet.executor import FleetExecutor, FleetState


class ControlDecision(NamedTuple):
    """What one control tick observed and actuated."""
    budget: int                   # budget in force for the next tick
    resized: bool                 # did the budget change this tick
    retraced: bool                # did a resize grow a slot ceiling
    healthy: np.ndarray           # [S] bool mask installed for next tick
    stragglers: list              # ranks currently flagged (wall | lag)
    escalated: np.ndarray         # [S] int, this tick's escalations
    watermark: float              # fleet reference used by the last tick
    region_budgets: np.ndarray | None = None  # [R] fog budgets in force
    fog_resized: bool = False     # did any fog budget change this tick
    slo_breached: tuple = ()      # names of SLOs in breach after this tick
    #                               (level, not transition — the policy
    #                               signal; transitions land in the log)
    items_rejected: int = 0       # admission drops this tick (fleet sum)
    items_deduped: int = 0        # re-deliveries dropped this tick
    drift: np.ndarray | None = None  # [D] per-field violations this tick


@dataclasses.dataclass
class FleetController:
    """Host-side per-tick control plane for a :class:`FleetExecutor`.

    Call :meth:`tick` once after every ``executor.step``.  It pulls a
    small host snapshot (per-shard escalation counters, per-shard max
    event times, the watermark actually used), runs the detectors and
    the budget policy, and installs the results on the executor for
    the next tick.  Everything it actuates is a host-side knob the next
    tick reads as an operand: the tick's shapes never depend on it.

    ``step_times``: callers with real per-device telemetry pass it to
    :meth:`tick`; otherwise the executor's own host wall time is
    replicated fleet-wide (a uniform signal never flags anyone — the
    detectors are relative).

    ``lag_tolerance`` is in *event-time units*: how far a shard's max
    event time may trail the fleet max before it counts as lagging
    (default: two micro-batches of samples at one time-unit spacing,
    matching the repo's examples; set it to your stream's real
    cadence).
    """
    executor: FleetExecutor
    budget_policy: ElasticBudget | None = None
    region_policies: list | None = None
    wall_detector: StragglerDetector | None = None
    lag_detector: StragglerDetector | None = None
    lag_tolerance: float | None = None
    event_log: EventLog | None = None
    tracer: object = NULL_TRACER
    slos: tuple = ()
    _prev_escalated: np.ndarray = None
    _prev_healthy: np.ndarray = None
    _prev_rejected: np.ndarray = None
    _prev_deduped: np.ndarray = None
    _prev_drift: np.ndarray = None   # [S, D], lazily sized on first tick
    _slo_eval: SloEvaluator | None = None
    _slo_bank: bool = False          # does a latency SLO read the bank
    _carry_stash: dict = None
    _resizes: int = 0
    _retraces: int = 0
    _ticks: int = 0

    def _default_region_policies(self) -> list:
        cfg = self.executor.cfg
        return [ElasticBudget(min_budget=1,
                              max_budget=max(1, 2 * cfg.fog_slots))
                for _ in range(cfg.num_regions)]

    def __post_init__(self):
        cfg = self.executor.cfg
        e = cfg.num_shards
        if self.budget_policy is None:
            self.budget_policy = ElasticBudget(
                min_budget=1, max_budget=max(1, 2 * cfg.core_slots))
        # per-region fog budgets are elastic only when fog budgeting is
        # opted into (cfg.fog_budget set, or explicit policies): a
        # config without a fog budget keeps the non-binding default —
        # elastically shrinking it would change flat-fleet semantics
        if self.region_policies is None and cfg.fog_budget is not None:
            self.region_policies = self._default_region_policies()
        if self.region_policies is not None \
                and len(self.region_policies) != cfg.num_regions:
            raise ValueError(
                f"need one region policy per region "
                f"({cfg.num_regions}), got {len(self.region_policies)}")
        if self.lag_tolerance is None:
            self.lag_tolerance = 2.0 * cfg.stream.micro_batch
        if self.wall_detector is None:
            self.wall_detector = StragglerDetector(
                e, window=8, threshold=3.0, patience=2)
        if self.lag_detector is None:
            self.lag_detector = StragglerDetector(
                e, window=4, threshold=4.0, patience=2,
                floor=float(self.lag_tolerance))
        if self._prev_escalated is None:
            self._prev_escalated = np.zeros(e, np.int64)
        if self._prev_healthy is None:
            self._prev_healthy = np.ones(e, bool)
        if self._prev_rejected is None:
            self._prev_rejected = np.zeros(e, np.int64)
        if self._prev_deduped is None:
            self._prev_deduped = np.zeros(e, np.int64)
        if self._carry_stash is None:
            self._carry_stash = {}
        self.slos = tuple(self.slos)
        if self.slos and self._slo_eval is None:
            self._slo_eval = SloEvaluator(self.slos)
        self._slo_bank = any(s.stage != "drops" for s in self.slos)

    @property
    def resizes(self) -> int:
        """Budget resizes actuated so far: one a tick for the core
        budget and one a tick for the fog budgets, however many regions
        moved (for trace-bound asserts)."""
        return self._resizes

    def _emit(self, kind: str, **kw) -> None:
        """Record one control-plane decision in the event log (no-op
        without one).  ``tick`` defaults to the controller's own tick
        counter, so leave/join/remesh between ticks land causally
        ordered next to the surrounding tick records."""
        if self.event_log is not None:
            kw.setdefault("tick", self._ticks)
            self.event_log.emit(kind, **kw)

    # -- membership churn (leave/join within the mesh width) ---------------
    def _unavailable(self) -> set:
        """Ranks that cannot serve as a replay backup right now:
        departed members plus currently-flagged stragglers."""
        ex = self.executor
        return (set(int(i) for i in np.nonzero(~ex.active)[0])
                | set(self.wall_detector.stragglers())
                | set(self.lag_detector.stragglers()))

    def leave(self, shard: int) -> int | None:
        """A member left the fleet *within* the current mesh width:
        flip its ``active`` flag (an operand of the next tick) and
        pick the backup rank that should re-run its buffered
        micro-batches (``StragglerDetector.reassignment`` over the
        wall-time history: the least-loaded healthy, present rank).

        **Backup locality**: the pick prefers a rank in the leaver's
        own *region* — replay traffic then rides the leaver's uplink to
        an intra-region peer and its escalations stay under the same
        fog budget, instead of shipping a whole stream across the
        region axis.  Only when no in-region rank is available does the
        pick fall back to the fleet-wide least-loaded rank.  Returns
        the backup rank, or ``None`` when no healthy rank is left
        anywhere (the records then wait for a joiner)."""
        ex = self.executor
        active = ex.active
        if not active[shard]:
            raise ValueError(f"shard {shard} already left")
        active[shard] = False
        ex.set_active(active)
        eper = ex.cfg.edges_per_region
        region = int(shard) // eper
        outside = {i for i in range(ex.cfg.num_shards)
                   if i // eper != region}
        plan = self.wall_detector.reassignment(
            sorted(self._unavailable() | {int(shard)} | outside))
        backup = plan.get(int(shard))
        locality = "intra-region"
        if backup is None:
            plan = self.wall_detector.reassignment(
                sorted(self._unavailable() | {int(shard)}))
            backup = plan.get(int(shard))
            locality = "cross-region fallback"
        self._emit("leave", shard=int(shard), cause="member left fleet",
                   active=[bool(x) for x in active])
        self._emit("backup_assign", shard=int(shard),
                   cause=f"reassignment over wall-time history "
                         f"({locality})",
                   backup=None if backup is None else int(backup))
        return backup

    def join(self, shard: int) -> None:
        """A device joined (or rejoined) at slot ``shard`` within the
        current mesh width: flip its ``active`` flag back on.  The
        joiner starts *excluded* from the watermark ``pmin`` — its
        slot's event-time state is frozen at leave time, so any backlog
        it drains must run against its own watermark (the catch-up
        path, counted in ``late_excluded``) — and is re-admitted by
        :meth:`tick`'s ordinary hysteresis once its lag fits the
        lateness bound.  Waiting for the lag *detector* to flag it
        instead would silently late-drop the backlog of any departure
        shorter than the detector's ramp (window median + patience)."""
        ex = self.executor
        active = ex.active
        if active[shard]:
            raise ValueError(f"shard {shard} is already a member")
        active[shard] = True
        ex.set_active(active)
        healthy = ex.health
        healthy[shard] = False
        ex.set_health(healthy)
        self._prev_healthy[shard] = False    # re-admit only once caught up
        self._emit("join", shard=int(shard),
                   cause="replacement joined; excluded until caught up",
                   active=[bool(x) for x in active])

    # -- mid-ring carry handoff (sliding-window replay) --------------------
    def begin_replay_carry(self, state: FleetState, stream: int,
                           backup: int) -> FleetState:
        """Migrate a departed ``stream``'s window carry onto its
        ``backup``'s slot so batch-granular replay is exact for
        *sliding* configs too (``stride < window``).

        Tumbling replay needs no handoff — each tick's batch IS the
        window.  A sliding config carries the last ``window - stride``
        rows across ticks, so replaying the departed stream's batches
        on the backup's slot would otherwise frame them against the
        backup's OWN carry: silent window smear (which ``step`` used to
        refuse outright).  This stashes the backup's carry host-side,
        installs the departed stream's carry (and validity) in its
        place, and blanks the departed slot's carry validity (the carry
        *moves* — leaving it would emit the same partial windows twice).
        At rejoin :meth:`end_replay_carry` moves the evolved carry back.
        The stash is a copy on the device; the returned state's
        ``carry`` and ``carry_valid`` are new tensors (the caller's are
        not written).

        Call between ticks: after :meth:`leave` picked the backup,
        before the first replay delivery.  Returns the updated state."""
        key = (int(stream), int(backup))
        if key[0] == key[1]:
            raise ValueError(f"stream and backup must differ, got {key}")
        if key in self._carry_stash:
            raise ValueError(f"carry handoff already live for {key}")
        stream, backup = key
        carry, valid = state.shard.carry, state.shard.carry_valid
        self._carry_stash[key] = (carry[backup].clone(),
                                  valid[backup].clone())
        new_carry, new_valid = carry.clone(), valid.clone()
        new_carry[backup] = carry[stream]
        new_valid[backup] = valid[stream]
        new_valid[stream] = False
        self._emit("backup_assign", shard=int(stream),
                   cause="sliding carry handoff: departed stream's "
                         "window carry installed on backup",
                   backup=int(backup))
        return state._replace(shard=state.shard._replace(
            carry=new_carry, carry_valid=new_valid))

    def end_replay_carry(self, state: FleetState, stream: int,
                         backup: int) -> FleetState:
        """Finish a :meth:`begin_replay_carry` handoff at rejoin: the
        carry as evolved by the replayed batches moves from the backup
        back to the stream's slot (the rejoined member continues the
        stream's window sequence seamlessly — no dropped or doubled
        sliding windows) and the backup's stashed own carry is
        restored, so its paused stream resumes where it left off.

        Call between ticks: after the last replay delivery, before the
        rejoined slot's first fresh or drain tick.  Returns the updated
        state."""
        key = (int(stream), int(backup))
        if key not in self._carry_stash:
            raise ValueError(f"no live carry handoff for {key}; live: "
                             f"{sorted(self._carry_stash)}")
        stream, backup = key
        own_carry, own_valid = self._carry_stash.pop(key)
        carry, valid = state.shard.carry, state.shard.carry_valid
        new_carry, new_valid = carry.clone(), valid.clone()
        new_carry[stream] = carry[backup]
        new_carry[backup] = own_carry
        new_valid[stream] = valid[backup]
        new_valid[backup] = own_valid
        self._emit("backup_assign", shard=int(stream),
                   cause="sliding carry handoff: evolved carry returned "
                         "to rejoined slot, backup's own carry restored",
                   backup=int(backup))
        return state._replace(shard=state.shard._replace(
            carry=new_carry, carry_valid=new_valid))

    def remesh(self, state, num_shards: int, *, keep: list | None = None,
               num_core: int | None = None,
               num_regions: int | None = None):
        """The device set actually changed: re-lay the fleet over
        ``num_shards`` shards and migrate the state -- see
        :meth:`FleetExecutor.remesh` (the reference takes the surviving
        devices; one card takes their count).  Departed shards' counters fold
        into their ``reassignment``-chosen backups, and their
        unconsumed ring rows come back as the replay payload.  The
        controller's own per-rank state (detectors, escalation
        baselines, re-admission memory) is re-built for the new width;
        detector history does not survive a re-mesh.  Per-region fog
        *policies* (and their hysteresis counters) DO survive an
        edge-width resize — region identity is preserved there (see
        :meth:`FleetExecutor.remesh`) — and restart only when the
        region count changes.  Slots are *renumbered* (old shard
        ``keep[j]`` -> new slot ``j``): translate a live
        ``FaultInjector`` with ``FaultInjector.translate(keep, tick)``
        (loud error on unmappable pending work, never silent loss) and
        re-derive any ``backups`` plan in the new numbering.  A live
        sliding-carry handoff must be closed first
        (:meth:`end_replay_carry`) — its stash is addressed in the old
        numbering, so remeshing through it raises."""
        if self._carry_stash:
            raise ValueError(
                "re-mesh during a live replay carry handoff: call "
                f"end_replay_carry for {sorted(self._carry_stash)} first "
                "(slots renumber; the stashed carries are addressed in "
                "the old numbering)")
        ex = self.executor
        old_e = ex.cfg.num_shards
        old_r = ex.cfg.num_regions
        if keep is None:
            keep = [i if i < old_e else None for i in range(int(num_shards))]
        kept = [k for k in keep if k is not None]
        departed = sorted(set(range(old_e)) - set(kept))
        plan = self.wall_detector.reassignment(
            sorted(set(departed) | self._unavailable()))
        fold = {s: b for s, b in plan.items() if s in departed and b in kept}
        # monotone counters must land on SOME surviving row even when
        # reassignment has no healthy pick (every survivor flagged):
        # losing them would regress fleet totals with no error
        for s in departed:
            if s not in fold and kept:
                fold[s] = kept[0]
        new_state, payload = ex.remesh(state, num_shards, keep=keep,
                                       num_core=num_core,
                                       num_regions=num_regions,
                                       fold_counters=fold)
        self._emit("remesh", cause="device set changed",
                   old_shards=old_e, new_shards=ex.cfg.num_shards,
                   num_regions=ex.cfg.num_regions,
                   keep=[None if k is None else int(k) for k in keep],
                   fold={str(s): int(b) for s, b in fold.items()},
                   payload_rows={str(s): int(len(r))
                                 for s, r in payload.items()})

        def _remap(arr, fill):
            return np.asarray([arr[k] if k is not None else fill
                               for k in keep], arr.dtype)

        # the executor folded the departed shard's cumulative counters
        # into its backup row; the differencing baselines must fold the
        # same way, or the first post-shrink tick reads the departed
        # shard's whole history as one tick of phantom demand (or one
        # tick of phantom rejects/drift)
        for src, dst in fold.items():
            self._prev_escalated[dst] += self._prev_escalated[src]
            self._prev_rejected[dst] += self._prev_rejected[src]
            self._prev_deduped[dst] += self._prev_deduped[src]
            if self._prev_drift is not None:
                self._prev_drift[dst] += self._prev_drift[src]
        self._prev_escalated = _remap(self._prev_escalated, 0)
        self._prev_rejected = _remap(self._prev_rejected, 0)
        self._prev_deduped = _remap(self._prev_deduped, 0)
        if self._prev_drift is not None:
            self._prev_drift = np.asarray(
                [self._prev_drift[k] if k is not None
                 else np.zeros_like(self._prev_drift[0])
                 for k in keep], self._prev_drift.dtype)
        self._prev_healthy = _remap(self._prev_healthy, True)
        # per-region fog policies carry their hysteresis state through
        # an edge-width resize (region identity is preserved: region i
        # is still region i) — restarting them here used to re-ramp the
        # grow/shrink counters and fire spurious fog_budget_resize
        # events right after every resize.  Only a region-COUNT change
        # re-forms regions and restarts the policies.
        if self.region_policies is not None \
                and ex.cfg.num_regions != old_r:
            self.region_policies = self._default_region_policies()
        for name in ("wall_detector", "lag_detector"):
            d = getattr(self, name)
            setattr(self, name, StragglerDetector(
                ex.cfg.num_shards, window=d.window, threshold=d.threshold,
                patience=d.patience, floor=d.floor))
        return new_state, payload

    def tick(self, state: FleetState,
             step_times: np.ndarray | None = None) -> ControlDecision:
        """One control tick: observe ``state``, actuate health mask +
        budget on the executor for the next data tick.  With an
        ``event_log`` installed, every actuation (health-mask change,
        budget resize) lands as a typed JSONL record; with a ``tracer``
        the whole tick is one host span."""
        with self.tracer.span("control.tick", tick=self._ticks):
            decision = self._tick(state, step_times)
        self._ticks += 1
        return decision

    def _tick(self, state: FleetState,
              step_times: np.ndarray | None = None) -> ControlDecision:
        ex = self.executor
        e = ex.cfg.num_shards
        max_ts, esc_total, wm, rej_total, ded_total, drift_total, \
            dropped, emitted = _pull(state)
        max_ts = np.asarray(max_ts, np.float64)
        esc_total = np.asarray(esc_total, np.int64)
        escalated = esc_total - self._prev_escalated
        self._prev_escalated = esc_total

        # -- admission-lane telemetry: rejects, dedupes, drift ---------
        # monotone counters differenced against the previous tick; a
        # moving reject counter means the lane dropped offered rows
        # (contract violation or ring backpressure) and a moving drift
        # counter means some field is violating its contract — both
        # land as typed events so a post-hoc reconstruction can place
        # data-quality incidents next to churn/budget decisions
        rej_total = np.asarray(rej_total, np.int64)
        ded_total = np.asarray(ded_total, np.int64)
        drift_total = np.asarray(drift_total, np.int64)
        if self._prev_drift is None:
            self._prev_drift = np.zeros_like(drift_total)
        rejected = rej_total - self._prev_rejected
        deduped = ded_total - self._prev_deduped
        drift = drift_total - self._prev_drift
        self._prev_rejected = rej_total
        self._prev_deduped = ded_total
        self._prev_drift = drift_total
        if int(rejected.sum()) > 0:
            self._emit(
                "ingest_reject",
                cause="admission lane dropped offered rows (contract "
                      "violation or ring backpressure)",
                rejected=int(rejected.sum()),
                deduped=int(deduped.sum()),
                per_shard=[int(x) for x in rejected])
        drift_fleet = drift.sum(axis=0) if drift.ndim > 1 else drift
        if int(drift_fleet.sum()) > 0:
            self._emit(
                "drift_detected",
                cause="per-field contract violations advanced",
                total=int(drift_fleet.sum()),
                per_field=[int(x) for x in np.atleast_1d(drift_fleet)])

        # -- straggler detection: wall-clock + event-time lag ----------
        if step_times is None:
            step_times = np.full(e, max(ex.last_step_seconds, 1e-9))
        self.wall_detector.observe(np.asarray(step_times, np.float64))
        # lag is measured against the fleet max; the epsilon floor only
        # turns a zero lag into a *present* measurement (not a missing
        # sample) — it must never nudge a shard sitting exactly at
        # lag_tolerance over the detector floor, so max(), not add
        lag = np.maximum(max_ts.max() - max_ts, 1e-9)
        self.lag_detector.observe(lag)
        flagged = sorted(set(self.wall_detector.stragglers())
                         | set(self.lag_detector.stragglers()))
        healthy = np.ones(e, bool)
        healthy[list(flagged)] = False
        # re-admission hysteresis: the fleet reference is monotone (the
        # executor clamps it), so an excluded shard only rejoins the
        # pmin once its records would *survive* that reference — i.e.
        # its lag is within the stream's lateness bound.  Rejoining
        # earlier would silently late-drop its catch-up backlog.
        lateness = ex.cfg.stream.lateness
        caught_up = (max_ts.max() - max_ts) <= lateness
        healthy &= self._prev_healthy | caught_up
        prev_mask = ex.health
        self._prev_healthy = healthy
        ex.set_health(healthy)
        flagged = [int(r) for r in np.nonzero(~healthy)[0]]
        if not np.array_equal(prev_mask, healthy):
            newly = np.nonzero(prev_mask & ~healthy)[0]
            self._emit(
                "health_change",
                cause="straggler flagged" if newly.size
                else "re-admitted after catch-up",
                healthy=[bool(x) for x in healthy], stragglers=flagged)

        # -- elastic budget ---------------------------------------------
        old_budget, old_slots = ex.core_budget, ex.core_slots
        proposed = self.budget_policy.propose(int(escalated.sum()),
                                              old_budget)
        resized = proposed != old_budget
        if resized:
            ex.set_core_budget(proposed)
            self._resizes += 1
        retraced = ex.core_slots != old_slots
        if retraced:
            self._retraces += 1
        if resized:
            self._emit(
                "budget_resize",
                cause="escalation pressure" if proposed > old_budget
                else "idle shrink",
                budget_from=int(old_budget), budget_to=int(proposed),
                escalated=int(escalated.sum()), retraced=bool(retraced))

        # -- elastic per-region fog budgets ----------------------------
        # one ElasticBudget instance per region, fed the region's own
        # candidate demand; only active when fog budgeting is opted in
        fog_resized = False
        region_budgets = None
        if self.region_policies is not None:
            rr = ex.cfg.num_regions
            demand = escalated.reshape(rr, ex.cfg.edges_per_region).sum(1)
            old_rb = ex.region_budget
            old_fog_slots = ex.fog_slots
            new_rb = np.asarray(
                [self.region_policies[i].propose(int(demand[i]),
                                                 int(old_rb[i]))
                 for i in range(rr)], np.int32)
            if not np.array_equal(new_rb, old_rb):
                ex.set_region_budget(new_rb)
                fog_resized = True
                self._resizes += 1
                fog_retraced = ex.fog_slots != old_fog_slots
                if fog_retraced:
                    self._retraces += 1
                    retraced = True
                for i in np.nonzero(new_rb != old_rb)[0]:
                    self._emit(
                        "fog_budget_resize", shard=None,
                        cause="region escalation pressure"
                        if new_rb[i] > old_rb[i] else "region idle shrink",
                        region=int(i), budget_from=int(old_rb[i]),
                        budget_to=int(new_rb[i]),
                        escalated=int(demand[i]),
                        retraced=bool(fog_retraced))
            region_budgets = ex.region_budget

        # -- SLO burn-rate lane ----------------------------------------
        # feed the evaluator cumulative telemetry (it differences
        # internally): the pooled lineage bank for latency SLOs, the
        # fleet drop/emit counters for drop SLOs.  Breach/recover
        # *transitions* land in the event log with both burn rates; the
        # breach *level* rides the decision as a policy signal (the
        # autoscaling ROADMAP item's input)
        slo_breached = ()
        if self._slo_eval is not None:
            bank = ex.lineage_counts() if self._slo_bank else None
            for st in self._slo_eval.observe(bank=bank,
                                             drops=(dropped, emitted)):
                if st.breached or st.recovered:
                    self._emit(
                        "slo_breach" if st.breached else "slo_recover",
                        cause=f"{st.slo.stage} burn rate "
                              f"{'over' if st.breached else 'back under'} "
                              f"{st.slo.burn_threshold}x in both windows",
                        slo=st.slo.name, stage=st.slo.stage,
                        target_seconds=float(st.slo.target_seconds),
                        objective=float(st.slo.objective),
                        fast_burn=round(float(st.fast_burn), 4),
                        slow_burn=round(float(st.slow_burn), 4))
            slo_breached = self._slo_eval.breaching
        return ControlDecision(
            budget=ex.core_budget, resized=resized, retraced=retraced,
            healthy=healthy, stragglers=flagged, escalated=escalated,
            watermark=float(wm),
            region_budgets=region_budgets, fog_resized=fog_resized,
            slo_breached=slo_breached,
            items_rejected=int(rejected.sum()),
            items_deduped=int(deduped.sum()),
            drift=np.atleast_1d(drift_fleet))

    @property
    def max_trace_count(self) -> int:
        """Upper bound the executor's ``trace_count`` respects:
        ``1 + (#resizes that grew the slot ceiling) + (#re-meshes)``.
        Membership flips (leave/join within the mesh width), health
        masks and budgets within the ceilings are operands of the
        compile-once tick and contribute nothing."""
        return 1 + self._retraces + self.executor.remeshes


def _pull(state: FleetState) -> tuple:
    """Everything one control tick reads, in one device-to-host
    transfer: per-shard max event times, escalation, reject and dedupe
    counters and drift counts, the fleet watermark and the fleet drop
    and emit counters.  The float32 leaves travel as their int32 bits,
    so one int32 tensor carries them all exactly."""
    sh, m = state.shard, state.shard.metrics
    s = sh.max_ts.shape[0]
    parts = (sh.max_ts.view(torch.int32), m.windows_escalated,
             state.watermark[:1].view(torch.int32), m.items_rejected,
             m.items_deduped, m.drift_counts.reshape(-1),
             state.fleet.windows_dropped[:1], state.fleet.windows_emitted[:1])
    host = torch.cat([p.to(torch.int32) for p in parts]).cpu().numpy()
    at = 0
    out = []
    for p in parts:
        out.append(host[at:at + p.numel()])
        at += p.numel()
    max_ts, esc, wm, rej, ded, drift, dropped, emitted = out
    return (max_ts.view(np.float32), esc, wm.view(np.float32)[0], rej, ded,
            drift.reshape(s, -1), int(dropped[0]), int(emitted[0]))


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected degradation: ``shard`` stalls at tick ``start`` and
    recovers at tick ``end`` (exclusive) — during the stall its
    producer batches buffer upstream (offered mask False) and its
    step wall-time balloons."""
    shard: int
    start: int
    end: int

    def __post_init__(self):
        if self.start >= self.end or self.shard < 0:
            raise ValueError(f"bad fault window: {self}")


@dataclasses.dataclass(frozen=True)
class Churn:
    """One membership churn event: the device at slot ``shard`` leaves
    the fleet at tick ``leave`` and a replacement joins the same slot
    at tick ``join`` (``None`` = never).  While departed, the stream's
    batches queue in a replay queue; a ``reassignment``-chosen backup
    re-runs them (the ``replay`` uplink path) until the joiner takes
    the slot back."""
    shard: int
    leave: int
    join: int | None = None

    def __post_init__(self):
        if self.shard < 0 or (self.join is not None
                              and self.join <= self.leave):
            raise ValueError(f"bad churn event: {self}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Deterministic degradation script for tests, the example, and the
    ``--faults``/``--churn`` benchmark modes: which shards are stalled
    or departed at each tick.  Purely declarative —
    :class:`FaultInjector` turns it into offered-masks, buffered
    backlogs, and backup-replay deliveries, and :meth:`stall_time` into
    synthetic per-shard telemetry."""
    faults: tuple = ()
    churn: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))
        object.__setattr__(self, "churn", tuple(self.churn))

    def stalled(self, tick: int) -> set:
        """Shards stalled at ``tick``."""
        return {f.shard for f in self.faults if f.start <= tick < f.end}

    def departed(self, tick: int) -> set:
        """Shards whose slot has no member device at ``tick``."""
        return {c.shard for c in self.churn
                if c.leave <= tick and (c.join is None or tick < c.join)}

    def stall_time(self, tick: int, num_shards: int, base: float = 0.1,
                   stalled_factor: float = 50.0) -> np.ndarray:
        """Synthetic per-shard wall times for ``tick``: ``base`` for
        healthy shards, ``base * stalled_factor`` for stalled ones, and
        0.0 (a *missing measurement*, per the detector contract) for
        departed ones — what real per-device telemetry would report."""
        t = np.full(num_shards, base)
        for s in self.stalled(tick):
            t[s] = base * stalled_factor
        for s in self.departed(tick):
            t[s] = 0.0
        return t


class FaultInjector:
    """Drives a :class:`FaultSchedule` against a fleet feed: the one
    copy of the stall/backlog/replay/drain bookkeeping shared by the
    fault tests, the degraded benchmarks, and the example.

    A stalled shard's batches buffer upstream (offered mask False); a
    recovered shard drains its backlog oldest-first at production rate
    while fresh batches keep queueing (the catch-up path).

    A *departed* shard (:class:`Churn`) buffers its stream in a
    per-stream **replay queue** instead: while it is away, the backup
    rank named in ``backups`` (the control plane's
    ``StragglerDetector.reassignment`` choice, via
    ``FleetController.leave``) re-runs those micro-batches on its own
    uplink — delivered with the ``replay`` flag set, so the executor
    admits them regardless of lateness and counts them in
    ``items_replayed``.  The backup's own fresh batches queue behind in
    its stall backlog meanwhile.  Once a joiner takes the slot back,
    any remaining queued batches drain on the slot itself (ordinary
    catch-up, stream order preserved), and fresh delivery resumes.

    :attr:`origin` records, after each :meth:`inject`, which stream's
    batch each slot delivered (-1 = nothing) — the attribution tests
    and benchmarks need to compare a churned run against a healthy
    oracle per *stream*, not per slot.

    After the stream ends, keep calling :meth:`inject` with
    ``fresh=False`` (and ``tick`` advancing past the fault windows — a
    still-stalled uplink never delivers) until :attr:`pending` is 0 so
    the tail drains — otherwise the buffered records really would be
    lost, which is exactly what the control plane exists to prevent.
    """

    def __init__(self, schedule: FaultSchedule,
                 event_log: EventLog | None = None):
        self.schedule = schedule
        self.event_log = event_log
        self._backlog = collections.defaultdict(collections.deque)
        self._replay = collections.defaultdict(collections.deque)
        self.origin = None                  # [E] after the first inject
        for f in schedule.faults:
            self._backlog[f.shard]          # materialize per-shard queues
        for c in schedule.churn:
            self._replay[c.shard]

    def _emit(self, kind: str, tick: int | None, **kw) -> None:
        if self.event_log is not None:
            self.event_log.emit(kind, tick=tick, **kw)

    @property
    def pending(self) -> int:
        """Batches still buffered upstream across all faulted and
        departed shards (stall backlogs + replay queues)."""
        return sum(len(q) for q in self._backlog.values()) \
            + sum(len(q) for q in self._replay.values())

    def requeue(self, stream: int, rows: np.ndarray,
                batch: int) -> None:
        """Push raw ``[k, 2+D]`` ring rows (``ts`` in column 0, the
        ingest stamp in column 1 — the stamp is dropped here: replayed
        rows get *fresh* stamps at redelivery, so the replay detour
        shows in the event log, not the latency lineage) onto
        ``stream``'s replay queue as ``<= batch``-sized deliveries —
        the landing pad for ``FleetExecutor.remesh``'s departed-shard
        payload (a dead device's unconsumed ring, re-run elsewhere)."""
        for lo in range(0, len(rows), batch):
            chunk = rows[lo:lo + batch]
            n, d = chunk.shape[0], chunk.shape[1] - 2
            items = np.zeros((batch, d), np.float32)
            t = np.zeros((batch,), np.float32)
            mask = np.zeros((batch,), bool)
            items[:n], t[:n], mask[:n] = chunk[:, 2:], chunk[:, 0], True
            self._replay[stream].append((items, t, mask))
        self._emit("requeue", None, shard=int(stream),
                   cause="remesh payload re-queued for replay",
                   rows=int(len(rows)),
                   batches=len(range(0, len(rows), batch)))

    def translate(self, keep: list, tick: int) -> None:
        """Renumber this injector's bookkeeping through a re-mesh.

        ``keep`` is the same mapping handed to
        :meth:`FleetExecutor.remesh` (new slot ``j`` inherits old shard
        ``keep[j]``); ``tick`` is the first tick that will run on the
        new numbering.  Stall backlogs, replay queues, and the schedule
        are rewritten in the new numbering, so a mid-schedule re-mesh
        keeps injecting correctly instead of stalling/replaying the
        wrong (renumbered) slots.

        Loud failure over silent loss: an old shard that did NOT
        survive (departed and not reassigned a new slot) must hold no
        pending batches, no fault window still open at ``tick``, and no
        churn arc with a leave or join still ahead — otherwise
        ``ValueError``.  A genuinely dead stream's unconsumed rows
        travel via :meth:`FleetExecutor.remesh`'s payload +
        :meth:`requeue`, already addressed in the NEW numbering.
        Empty queues and fully-elapsed schedule entries for unmapped
        shards are dropped; :attr:`origin` resets (it described the old
        numbering)."""
        old_to_new = {k: j for j, k in enumerate(keep) if k is not None}

        def _xlate(queues, what):
            out = collections.defaultdict(collections.deque)
            for s, q in queues.items():
                if s in old_to_new:
                    out[old_to_new[s]] = q
                elif q:
                    raise ValueError(
                        f"re-mesh dropped shard {s} with {len(q)} pending "
                        f"{what} batch(es) and no new slot — drain it or "
                        f"requeue the remesh payload before translating")
            return out

        backlog = _xlate(self._backlog, "backlog")
        replay = _xlate(self._replay, "replay")
        faults, churn = [], []
        for f in self.schedule.faults:
            if f.shard in old_to_new:
                faults.append(dataclasses.replace(
                    f, shard=old_to_new[f.shard]))
            elif f.end > tick:
                raise ValueError(
                    f"re-mesh dropped shard {f.shard} with an open or "
                    f"future fault window ({f}, tick {tick}) and no new "
                    f"slot")
        for c in self.schedule.churn:
            if c.shard in old_to_new:
                churn.append(dataclasses.replace(
                    c, shard=old_to_new[c.shard]))
            elif c.leave >= tick or (c.join is not None and c.join > tick):
                raise ValueError(
                    f"re-mesh dropped shard {c.shard} with an open or "
                    f"future churn arc ({c}, tick {tick}) and no new slot")
        self._backlog, self._replay = backlog, replay
        self.schedule = FaultSchedule(faults=faults, churn=churn)
        for f in self.schedule.faults:
            self._backlog[f.shard]          # re-materialize per-shard queues
        for c in self.schedule.churn:
            self._replay[c.shard]
        self.origin = None
        self._emit("remesh", tick,
                   cause="injector schedule/queues translated through "
                         "the re-mesh keep map",
                   keep=[None if k is None else int(k) for k in keep])

    def inject(self, tick: int, items: np.ndarray, ts: np.ndarray,
               fresh: bool = True, backups: dict | None = None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Apply the schedule to this tick's producer batch.

        items: [E, N, D], ts: [E, N] (the healthy ground-truth feed;
        with ``fresh=False`` both are only a shape/dtype template for a
        drain tick).  ``backups``: {departed shard -> backup rank}, the
        control plane's current reassignment plan.  Returns (items, ts,
        offered, replay) copies: stalled shards blanked, recovering
        shards draining their backlog, departed streams replaying on
        their backup's uplink with the per-shard ``replay`` flag set.
        """
        items, ts = items.copy(), ts.copy()
        e, n = ts.shape
        offered = np.full(ts.shape, fresh, bool)
        replay = np.zeros(e, bool)
        origin = np.full(e, -1, np.int64)
        if fresh:
            origin[:] = np.arange(e)
        claimed = set()                     # slots with a delivery decided
        departed = self.schedule.departed(tick)
        stalled = self.schedule.stalled(tick)
        full = np.ones(n, bool)

        # 1. churn slots: a departed stream queues; a rejoined slot with
        #    a remaining queue drains it in stream order (fresh behind)
        for s, q in list(self._replay.items()):
            if s in departed:
                if fresh:
                    q.append((items[s].copy(), ts[s].copy(), full.copy()))
                    self._emit("replay_queue", tick, shard=int(s),
                               cause="stream departed; batch queued",
                               depth=len(q))
                offered[s] = False
                items[s] = 0.0
                origin[s] = -1
                claimed.add(s)
            elif q and s not in stalled:
                if fresh:
                    q.append((items[s].copy(), ts[s].copy(), full.copy()))
                items[s], ts[s], offered[s] = q.popleft()
                origin[s] = s
                claimed.add(s)
                self._emit("slot_drain", tick, shard=int(s),
                           cause="rejoined slot draining its replay queue",
                           remaining=len(q))

        # 2. stall buffering: a stalled uplink delivers nothing
        for s, q in list(self._backlog.items()):
            if s in claimed:
                continue
            if fresh and s in stalled:
                q.append((items[s].copy(), ts[s].copy()))
                offered[s] = False
                items[s] = 0.0
                origin[s] = -1
                claimed.add(s)
                self._emit("stall_buffer", tick, shard=int(s),
                           cause="uplink stalled; batch buffered upstream",
                           depth=len(q))

        # 3. backup replay: a departed stream's oldest batch re-runs on
        #    its backup's uplink (priority over the backup's own
        #    backlog; the backup's fresh batch queues behind)
        for s, b in (backups or {}).items():
            q = self._replay[s]
            # b is None when leave() found no healthy rank: the queue
            # simply waits (a None must never reach the numpy indexing
            # below — None indexes as np.newaxis and would broadcast
            # the replay chunk over the whole fleet)
            if (b is not None and s in departed and q and b not in claimed
                    and b not in stalled and b not in departed and b != s):
                if fresh and offered[b].any():
                    self._backlog[b].append((items[b].copy(),
                                             ts[b].copy()))
                items[b], ts[b], offered[b] = q.popleft()
                replay[b] = True
                origin[b] = s
                claimed.add(b)
                self._emit("replay_delivery", tick, shard=int(b),
                           cause="backup re-running departed stream's batch",
                           stream=int(s), remaining=len(q))

        # 4. backlog drain: recovered shards catch up oldest-first
        for s, q in list(self._backlog.items()):
            if s in claimed or not q or s in stalled:
                continue
            # a still-stalled uplink never delivers, even on drain
            # ticks — keep `tick` advancing past the fault windows
            if fresh:
                q.append((items[s].copy(), ts[s].copy()))
            items[s], ts[s] = q.popleft()
            offered[s] = True
            origin[s] = s
            self._emit("backlog_drain", tick, shard=int(s),
                       cause="recovered shard draining its stall backlog",
                       remaining=len(q))
        self.origin = origin
        return items, ts, offered, replay
