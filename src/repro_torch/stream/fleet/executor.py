"""The edge fleet on one card: S = R x E stream shards in one tick.

Port of ``repro.stream.fleet.executor``.  ``FleetExecutor`` runs S
independent edge shards -- each with its own ring, window carry and
watermark -- in one ``step``.  The reference lays them over a
``("region", "edge")`` device mesh; here they are the leading
``[S]`` dim (region-major: shard ``s`` is region ``s // E``, edge column
``s % E``) of every state tensor, all on one card:

    per shard:  enqueue -> dequeue -> watermark -> windows -> rules
                -> edge pipeline stages       (StreamExecutor's code)
    region:     escalation candidates pre-aggregate on the edge dim
                under a per-region fog budget (shed candidates keep
                their edge results)
    fleet:      region survivors cross to the core ranks (region 0,
                edge columns ``0..num_core-1``) -> fleet-budgeted core
                stage -> back the same two hops -> commit

The per-shard work is the single-device executor's own
``ingest_and_window`` and ``pipeline.run_edge``, run once a shard on
row views of the stacked state (the ring is written in place, never
re-stacked), so a fleet of S shards equals S lone executors except
where the fleet semantics differ on purpose: the watermark reference is
the fleet-wide min of the per-shard maxima (layered per region, then
across regions), core capacity is a fleet-level budget, and each region
caps what it forwards at its fog budget (``stream.fleet.federation``).
The cross-shard phases (watermark, exchange, core stage, commit,
lineage, counters) are tensor ops over the shard dim.  Nothing in a
tick reads a device value on the host.

Churn: ``set_active`` masks shards out within the current width (an
inactive shard contributes no watermark, escalations or fleet sums; its
ring keeps draining on its own rows); ``remesh`` changes the width and
migrates the state (a departed shard's unconsumed ring rows come back
to the host).  Backup replay rides the per-shard ``mode`` operand.

The tick compiles once, as the reference's does: it is a
``runtime.capture.Step`` (``trace_count``, ``_compile_count``), eager at
its first call and on the card captured then as a CUDA graph and
replayed.  The masks, the modes, both budgets, ``now`` and the fed wall
time are operands copied into static buffers before each replay.  A new
signature comes only from a ``remesh`` (which drops the old graphs), a
budget grown past its slot ceiling, or a new producer batch shape: the
bound ``FleetController.max_trace_count`` holds the count to.  An
enabled tracer's stage spans run in Python, so on the card they come
from the warm-up and the capture only; ``fleet.dispatch`` marks every
tick.
"""
from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import device_constant, resolve_device
from repro_torch.core import rules as R
from repro_torch.core.pipeline import DataDrivenPipeline, PipelineResult
from repro_torch.data.ringbuffer import RingBuffer
from repro_torch.kernels import build
from repro_torch.obs import latency as OL
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime import capture, elastic
from repro_torch.stream import ingest as SI
from repro_torch.stream.executor import (META_COLS, StepOutput, StreamConfig,
                                         StreamExecutor, StreamMetrics,
                                         StreamState, _check_ring, _scalar,
                                         advance_metrics, clone_state,
                                         cost_of, ingest_and_window)
from repro_torch.stream.fleet import federation as F
from repro_torch.stream.fleet import routing as FR


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet topology and budget knobs.  ``core_budget`` and
    ``fog_budget`` are the initial values of the dynamic budgets, which
    the control plane resizes between ticks up to the slot ceilings
    (``core_budget_max`` / ``fog_budget_max``); growing past a ceiling
    grows the exchange buffers from the next tick on.

    ``num_shards`` edge shards in ``num_regions`` equal regions
    (region-major numbering); ``num_regions=1`` is the flat fleet.  The
    core ranks are region 0's edge columns ``0..num_core-1``; every
    region's matching columns are its fog tier."""
    stream: StreamConfig           # per-shard stream config
    num_shards: int                # total edge shards (all regions)
    num_core: int = 1              # core ranks = region-0 cols 0..K-1
    core_budget: int = 8           # initial fleet-level escalations / step
    core_budget_max: int | None = None   # slot ceiling (shape)
    num_regions: int = 1           # R regions on the outer dim
    fog_budget: int | None = None  # initial per-region escalation budget
    #                                (None = non-binding: the flat
    #                                semantics)
    fog_budget_max: int | None = None    # per-region ceiling

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"need >= 1 shard, got {self.num_shards}")
        if self.num_regions < 1 or self.num_shards % self.num_regions:
            raise ValueError(
                f"num_shards ({self.num_shards}) must split into "
                f"num_regions ({self.num_regions}) equal regions")
        if not (1 <= self.num_core <= self.edges_per_region):
            raise ValueError(
                "need 1 <= num_core <= edges_per_region (the core "
                "sub-mesh is region 0's leading edge columns), got "
                f"{self.num_core} / {self.edges_per_region}")
        if self.core_budget < 0:
            raise ValueError(f"core_budget must be >= 0, got {self}")
        if self.core_budget_max is not None \
                and self.core_budget_max < self.core_budget:
            raise ValueError(f"core_budget_max < core_budget: {self}")
        if self.fog_budget is not None and self.fog_budget < 0:
            raise ValueError(f"fog_budget must be >= 0, got {self}")
        if self.fog_budget_max is not None and self.fog_budget is not None \
                and self.fog_budget_max < self.fog_budget:
            raise ValueError(f"fog_budget_max < fog_budget: {self}")

    @property
    def edges_per_region(self) -> int:
        """Edge shards a region (the inner dim's width)."""
        return self.num_shards // self.num_regions

    @property
    def core_slots(self) -> int:
        """Slot ceiling of the dynamic core budget."""
        return self.core_budget if self.core_budget_max is None \
            else self.core_budget_max

    @property
    def fog_slots(self) -> int:
        """Per-region slot ceiling of the fog budget.  With no fog budget
        it is the region's worst-case demand (every window of every edge
        escalating): non-binding, the flat fleet exactly."""
        if self.fog_budget_max is not None:
            return self.fog_budget_max
        if self.fog_budget is not None:
            return self.fog_budget
        return self.edges_per_region * self.stream.windows_per_step

    @property
    def initial_fog_budget(self) -> int:
        """Per-region budget in force before any resize."""
        return self.fog_slots if self.fog_budget is None \
            else self.fog_budget

    @property
    def route_capacity(self) -> int:
        """Per-(src, dest) slot count of the hop-1 buffer: global slots
        fan out round-robin over the fog columns, so one shard never
        sends more than ceil(NW / num_core) records to one column."""
        return -(-self.stream.windows_per_step // self.num_core)

    @property
    def cross_capacity(self) -> int:
        """Per-(region, region) slot count of the hop-2 buffer,
        ``ceil(fog_slots / num_core)``: from the fog-budget ceiling, not
        from the region width."""
        return max(1, -(-self.fog_slots // self.num_core))

    def exchange(self) -> FR.TieredExchange:
        """Static geometry of the two-hop exchange."""
        return FR.TieredExchange(
            num_regions=self.num_regions,
            edges_per_region=self.edges_per_region,
            num_core=self.num_core, edge_capacity=self.route_capacity,
            cross_capacity=self.cross_capacity)


class FleetMetrics(NamedTuple):
    """Per-shard stream counters, the fleet sums and the exchange
    counters, each with a leading ``[S]`` dim: ``fleet`` leaves are
    replicated over it, ``region_watermark`` within each region."""
    shard: StreamMetrics            # each shard's local counters
    fleet: StreamMetrics            # summed over the member shards
    escalations_sent: torch.Tensor  # fog-budget survivors
    fog_shed: torch.Tensor          # candidates shed by the fog budget
    core_received: torch.Tensor     # records landed here as core rank
    core_processed: torch.Tensor    # of those, got core compute
    fleet_core_overflow: torch.Tensor  # fleet survivors beyond budget
    late_excluded: torch.Tensor     # records admitted past the fleet wm
    watermark: torch.Tensor         # fleet watermark used last tick (f32)
    region_watermark: torch.Tensor  # the shard's region's watermark (f32)

    def as_dict(self) -> dict:
        """Host-side snapshot in two device-to-host transfers (the int
        counters, the watermarks), with the reference's keys: per-shard
        counters as lists, fleet counters as ints (``drift_counts`` as a
        list)."""
        ints = [*self.shard, *self.fleet, self.escalations_sent,
                self.fog_shed, self.core_received, self.core_processed,
                self.fleet_core_overflow, self.late_excluded]
        host = torch.cat([v.reshape(-1) for v in ints]).cpu().numpy()
        parts, at = [], 0
        for v in ints:
            parts.append(host[at:at + v.numel()].reshape(v.shape))
            at += v.numel()
        nf = len(StreamMetrics._fields)
        shard, fleet, rest = parts[:nf], parts[nf:2 * nf], parts[2 * nf:]
        wms = torch.cat([self.watermark.reshape(-1),
                         self.region_watermark.reshape(-1)]).cpu().numpy()

        def _fleet(v):
            return v[0].tolist() if v.ndim > 1 else int(v.reshape(-1)[0])

        names = ("escalations_sent", "fog_shed", "core_received",
                 "core_processed", "fleet_core_overflow", "late_excluded")
        out = {"shard": {k: v.tolist() for k, v in
                         zip(StreamMetrics._fields, shard)},
               "fleet": {k: _fleet(v) for k, v in
                         zip(StreamMetrics._fields, fleet)}}
        for k, v in zip(names, rest):
            out[k] = _fleet(v) if k == "fleet_core_overflow" else v.tolist()
        n = self.watermark.numel()
        out["watermark"] = float(wms[0])
        out["region_watermark"] = [float(x) for x in wms[n:]]
        return out


class FleetState(NamedTuple):
    """The fleet's state: every leaf carries a leading ``[S]`` shard dim
    (region-major), the reference's layout leaf for leaf."""
    shard: StreamState              # rings, carries, clocks, counters
    fleet: StreamMetrics            # summed counters (replicated)
    escalations_sent: torch.Tensor
    fog_shed: torch.Tensor
    core_received: torch.Tensor
    core_processed: torch.Tensor
    fleet_core_overflow: torch.Tensor
    late_excluded: torch.Tensor
    watermark: torch.Tensor         # [S] f32, fleet reference (replicated)
    region_watermark: torch.Tensor  # [S] f32, replicated within a region

    @property
    def metrics(self) -> FleetMetrics:
        return FleetMetrics(self.shard.metrics, self.fleet,
                            self.escalations_sent, self.fog_shed,
                            self.core_received, self.core_processed,
                            self.fleet_core_overflow, self.late_excluded,
                            self.watermark, self.region_watermark)


def _shard_view(st: StreamState, s: int) -> StreamState:
    """Shard ``s``'s row of a stacked state, as views: the ring's
    storage is the stacked tensor's, so the tick writes it in place.
    The counters stay with the fleet (``ingest_and_window`` reads none)."""
    return StreamState(
        rb=RingBuffer(st.rb.store[s], st.rb.head[s], st.rb.tail[s]),
        carry=st.carry[s], carry_valid=st.carry_valid[s],
        max_ts=st.max_ts[s], metrics=None,
        adm=SI.AdmissionState(st.adm.seen[s], st.adm.seen_pos[s]))


def _stack(rows: list, field: str) -> torch.Tensor:
    return torch.stack([getattr(r, field) for r in rows])


class FleetExecutor:
    """S stream shards and their escalation exchange in one tick.

    engine/pipeline: as ``StreamExecutor``'s; the pipeline must end in
    a single core stage (the canonical two-tier shape) -- its edge
    prefix runs per shard, its core stage on the core ranks over the
    exchanged records.  ``cfg.core_budget`` replaces the pipeline's
    per-device ``core_capacity``.  device: ``None`` is the CUDA card
    (raises without one); ``"cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, cfg: FleetConfig, engine: R.RuleEngine,
                 pipeline: DataDrivenPipeline,
                 device: str | torch.device | None = None):
        ci = pipeline.core_index
        if ci is None or ci != len(pipeline.stages) - 1:
            raise ValueError("fleet pipeline needs exactly one core stage, "
                             "as the last stage")
        if cfg.stream.fused and engine.table() is None:
            raise ValueError(
                "FleetConfig.stream has fused=True but the RuleEngine is "
                "not tabular (threshold_rule-style rules only) -- callable "
                "rules cannot run inside the fused kernel; use fused=False")
        self.cfg = cfg
        self.engine = engine
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self._remeshes = 0
        self._budget = cfg.core_budget       # dynamic
        self._slots = cfg.core_slots         # buffer ceiling
        self._region_budget = np.full(cfg.num_regions,
                                      cfg.initial_fog_budget, np.int32)
        self._fog_slots = cfg.fog_slots
        self._healthy = np.ones(cfg.num_shards, bool)
        self._active = np.ones(cfg.num_shards, bool)
        self.last_step_seconds = 0.0
        self.tracer = NULL_TRACER
        self._lat_hist = OL.histogram_init(device=self.device)
        # one lineage bank a shard: per-shard and per-region breakdowns
        # pool over the leading dim
        self._lineage = OL.lineage_init(device=self.device)[None].repeat(
            cfg.num_shards, 1, 1)
        self._t0 = time.perf_counter()     # lineage epoch (f32 stamps)
        # warmup exclusion: a tick during which a kernel was built
        # measured the build -- its wall time is withheld from the next
        # tick's histogram feed
        self._skip_feed = False
        self.warmup_excluded = 0
        self._step_num = 0
        # True: step() synchronizes before its clock stops, so
        # last_step_seconds measures the device's work too
        self.measure_steps = True
        # the compile-once tick: state, histogram and lineage donated
        self._tick_step = capture.Step(self._tick, device=self.device,
                                       donate_argnums=(0, 1, 2),
                                       name="fleet tick")

    @property
    def trace_count(self) -> int:
        """Fleet-tick signatures built so far: 1 after the first tick,
        one more after each remesh or slot-ceiling growth that a tick
        followed, or a new producer batch shape."""
        return self._tick_step.trace_count

    def _compile_count(self) -> int:
        """CUDA graphs of the fleet tick captured (>= trace_count; on
        the CPU equal to it)."""
        return self._tick_step.compile_count

    # -- control-plane knobs (host-side, between ticks) --------------------
    @property
    def core_budget(self) -> int:
        """Current dynamic fleet core budget."""
        return self._budget

    @property
    def core_slots(self) -> int:
        """Current slot ceiling of the budget (the core batch's rows)."""
        return self._slots

    def set_core_budget(self, budget: int) -> None:
        """Resize the fleet core budget between ticks (an operand);
        growing past the slot ceiling grows the core batch from the next
        tick on, whose tick builds a new signature (the old graphs are
        dropped)."""
        budget = int(budget)
        if budget < 0:
            raise ValueError(f"core_budget must be >= 0, got {budget}")
        if budget > self._slots:
            self._slots = budget
            self._tick_step.clear()
        self._budget = budget

    @property
    def region_budget(self) -> np.ndarray:
        """Current dynamic per-region fog budgets ([R] ints)."""
        return self._region_budget.copy()

    @property
    def fog_slots(self) -> int:
        """Current per-region fog slot ceiling (hop 2's buffer)."""
        return self._fog_slots

    def set_region_budget(self, budgets) -> None:
        """Resize the per-region fog budgets between ticks (a scalar
        applies to every region); growing the largest past the ceiling
        grows the hop-2 buffer from the next tick on."""
        budgets = np.broadcast_to(
            np.asarray(budgets, np.int32),
            (self.cfg.num_regions,)).copy()
        if (budgets < 0).any():
            raise ValueError(f"fog budgets must be >= 0, got {budgets}")
        if int(budgets.max()) > self._fog_slots:
            self._fog_slots = int(budgets.max())
            self._tick_step.clear()
        self._region_budget = budgets

    def set_health(self, healthy) -> None:
        """Install the per-shard health mask the *next* tick's watermark
        uses (False = left out of the fleet min)."""
        healthy = np.asarray(healthy, bool)
        if healthy.shape != (self.cfg.num_shards,):
            raise ValueError(f"health mask must be [{self.cfg.num_shards}]"
                             f", got {healthy.shape}")
        self._healthy = healthy.copy()

    @property
    def health(self) -> np.ndarray:
        return self._healthy.copy()

    def set_active(self, active) -> None:
        """Install the per-shard membership mask for the *next* tick
        (False = the shard left the fleet).  The core ranks
        (``0..num_core-1``) must stay active: a core rank leaving is a
        change of width -- use :meth:`remesh`."""
        active = np.asarray(active, bool)
        if active.shape != (self.cfg.num_shards,):
            raise ValueError(f"active mask must be [{self.cfg.num_shards}]"
                             f", got {active.shape}")
        if not active[:self.cfg.num_core].all():
            raise ValueError(
                f"core sub-mesh ranks 0..{self.cfg.num_core - 1} must stay "
                f"active (got {active}); a core rank leaving changes the "
                f"device set -- use remesh()")
        self._active = active.copy()

    @property
    def active(self) -> np.ndarray:
        return self._active.copy()

    @property
    def remeshes(self) -> int:
        """Width changes so far."""
        return self._remeshes

    def set_tracer(self, tracer) -> None:
        """Install an ``obs.trace.Tracer``: an enabled one marks each
        tick and its stages on a ``torch.profiler`` timeline."""
        self.tracer = tracer

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Fleet-tick latency percentiles from the device histogram (one
        host transfer).  A tick's wall time feeds the histogram on the
        next tick; ticks that built a kernel or a tick signature are
        excluded and counted in ``warmup_excluded``."""
        out = OL.histogram_percentiles(self._lat_hist, qs)
        out["warmup_excluded"] = self.warmup_excluded
        return out

    def lineage_percentiles(self, by: str | None = None,
                            qs=(50, 95, 99)):
        """Per-stage event-time latency percentiles from the lineage
        banks (one host transfer): ``by=None`` pools every shard,
        ``"shard"`` gives S dicts, ``"region"`` R dicts (pooling is
        histogram summation).  hop1 populates on the fog columns, hop2
        only on region 0's core ranks."""
        bank = self._lineage.cpu().numpy().astype(np.int64)
        if by is None:
            return OL.lineage_percentiles(bank, qs)
        if by == "shard":
            return [OL.lineage_percentiles(bank[i], qs)
                    for i in range(bank.shape[0])]
        if by == "region":
            rr = self.cfg.num_regions
            pooled = bank.reshape((rr, -1) + bank.shape[1:]).sum(axis=1)
            return [OL.lineage_percentiles(pooled[i], qs)
                    for i in range(rr)]
        raise ValueError(f"by must be None, 'shard' or 'region', got {by!r}")

    def lineage_counts(self) -> np.ndarray:
        """The fleet-pooled lineage bank, ``[n_stages, buckets]`` int64
        on the host (one transfer, summed over shards)."""
        return self._lineage.cpu().numpy().astype(np.int64).sum(axis=0)

    def step_cost(self, state: FleetState, items, ts) -> dict:
        """Cost of ONE fleet tick at these operands
        (``obs.costmodel.analyze``): total FLOPs and bytes plus the
        per-stage breakdown (exchange, core compute, commit, ...) and
        what each hand kernel reported.  Every shard offers its whole
        batch as live traffic under the current masks and budgets.  The
        tick runs eagerly, once, on a copy of ``state``, the histogram and
        the lineage banks, and builds no tick signature: nothing is
        consumed, the next ``step`` is the one it would have been."""
        dev, s = self.device, self.cfg.num_shards
        items = torch.as_tensor(items, device=dev)
        return cost_of(
            self, self._tick, clone_state(state), self._lat_hist.clone(),
            self._lineage.clone(), items,
            torch.as_tensor(ts, device=dev),
            torch.ones(items.shape[:2], dtype=torch.bool, device=dev),
            torch.zeros((s,), dtype=torch.int32, device=dev),
            torch.as_tensor(self._healthy, device=dev),
            torch.as_tensor(self._active, device=dev),
            _scalar(self._budget, torch.int32, dev),
            torch.as_tensor(self._region_budget, device=dev),
            _scalar(0.0, torch.float32, dev),
            _scalar(0.0, torch.float32, dev))

    # -- state ------------------------------------------------------------
    def init_state(self, feature_dim: int) -> FleetState:
        """A fresh fleet state on the executor's device: each shard's
        row is ``StreamExecutor.init_state``'s, stacked."""
        s, dev = self.cfg.num_shards, self.device
        one = StreamExecutor(self.cfg.stream, self.engine, self.pipeline,
                             device=dev).init_state(feature_dim)

        def tile(x):
            return x[None].repeat((s,) + (1,) * x.ndim)

        def zero():
            return torch.zeros((s,), dtype=torch.int32, device=dev)

        shard = StreamState(
            rb=RingBuffer(*(tile(x) for x in one.rb)),
            carry=tile(one.carry), carry_valid=tile(one.carry_valid),
            max_ts=tile(one.max_ts),
            metrics=StreamMetrics(*(tile(x) for x in one.metrics)),
            adm=SI.AdmissionState(*(tile(x) for x in one.adm)))
        f32_min = torch.finfo(torch.float32).min
        return FleetState(
            shard=shard,
            fleet=StreamMetrics(*(tile(x) for x in one.metrics)),
            escalations_sent=zero(), fog_shed=zero(), core_received=zero(),
            core_processed=zero(), fleet_core_overflow=zero(),
            late_excluded=zero(),
            watermark=torch.full((s,), f32_min, dtype=torch.float32,
                                 device=dev),
            region_watermark=torch.full((s,), f32_min, dtype=torch.float32,
                                        device=dev))

    # -- one fleet tick ---------------------------------------------------
    def _tick(self, state: FleetState, lat_hist: torch.Tensor,
              lineage: torch.Tensor, items: torch.Tensor, ts: torch.Tensor,
              offered: torch.Tensor, mode: torch.Tensor,
              healthy: torch.Tensor, active: torch.Tensor,
              budget: torch.Tensor, region_budget: torch.Tensor,
              now: torch.Tensor, last_dt: torch.Tensor):
        """The fleet tick as a function of its operands: (out, state,
        histogram, lineage banks), the last three the donated ones; the
        histogram takes the previous tick's wall time after the tick."""
        new_state, out, lineage = self._fleet_step(
            state, lineage, items, ts, offered, mode, healthy, active,
            budget, region_budget, now)
        lat_hist = OL.histogram_update(lat_hist, last_dt)
        return out, new_state, lat_hist, lineage

    def _static_key(self) -> tuple:
        """What the tick's shapes and code depend on besides its
        operands: the config (a remesh replaces it), both slot ceilings,
        the rule table."""
        table = self.engine.table()
        return (id(self.cfg), self._slots, self._fog_slots,
                table if table is not None else id(self.engine))

    def _fleet_step(self, state: FleetState, lineage: torch.Tensor,
                    items: torch.Tensor, ts: torch.Tensor,
                    offered: torch.Tensor, mode: torch.Tensor,
                    healthy: torch.Tensor, active: torch.Tensor,
                    budget: torch.Tensor, region_budget: torch.Tensor,
                    now: torch.Tensor
                    ) -> tuple[FleetState, StepOutput, torch.Tensor]:
        cfg, tr = self.cfg, self.tracer
        rr, ee, s = cfg.num_regions, cfg.edges_per_region, cfg.num_shards
        sh = state.shard

        # fleet watermark: min of the per-shard maxima (as of the last
        # tick) over healthy, active shards, layered per region and then
        # across regions, clamped against the previous reference so it
        # never rolls back.  An excluded-but-present shard runs on its
        # own max (the catch-up path); what it admits past the fleet
        # reference is counted in late_excluded
        with tr.span("obs:fleet_watermark"):
            wm_raw, rwm_raw = F.tiered_watermark(
                sh.max_ts.reshape(rr, ee), healthy.reshape(rr, ee),
                active.reshape(rr, ee))
            wm = torch.maximum(wm_raw, state.watermark)             # [S]
            rwm = torch.maximum(rwm_raw.repeat_interleave(ee),
                                state.region_watermark)
            eff_wm = torch.where(healthy & active, wm, sh.max_ts)

        # the per-shard tick: the single-device executor's code on each
        # shard's row of the state
        ings, partials = [], []
        for i in range(s):
            ing = ingest_and_window(
                cfg.stream, self.engine, _shard_view(sh, i), items[i],
                ts[i], watermark_ts=eff_wm[i], offer_mask=offered[i],
                excluded_ref=wm[i], mode=mode[i], now=now, tracer=tr)
            with tr.span("obs:edge_stages"):
                partial, _ = self.pipeline.run_edge(ing.record,
                                                    live=ing.emit)
            ings.append(ing)
            partials.append(partial)

        # a departed shard never escalates
        core_live = _stack(partials, "escalated") & active[:, None]
        w_birth = _stack(ings, "w_birth")
        with tr.span("obs:exchange_core"):
            core_out, core_feats, processed, stats, taps = \
                F.federate_escalations_tiered(
                    _stack(partials, "outputs"), core_live,
                    self.pipeline.run_core, num_regions=rr,
                    edges_per_region=ee, num_core=cfg.num_core,
                    region_budget=region_budget, core_budget=budget,
                    edge_capacity=cfg.route_capacity,
                    cross_capacity=max(1, -(-self._fog_slots
                                            // cfg.num_core)),
                    core_slots=self._slots, birth=w_birth)
        with tr.span("obs:core_commit"):
            # the commit is row-wise: all shards' windows in one batch
            n = core_live.shape[1]

            def flat(t):
                return t.reshape((s * n,) + t.shape[2:])
            partial = PipelineResult(
                flat(_stack(partials, "outputs")),
                flat(_stack(partials, "consequence")), flat(core_live),
                flat(_stack(partials, "stored")),
                flat(_stack(partials, "dropped")),
                tuple(flat(torch.stack(f)) for f in
                      zip(*(p.stage_features for p in partials))))
            result = self.pipeline.commit_core(
                partial, flat(core_live), flat(core_out), flat(core_feats),
                flat(processed))

        # event-time lineage into each shard's bank: hop1 populates on
        # fog columns, hop2 on region 0's core ranks
        with tr.span("obs:lineage"):
            w_lat = now - w_birth
            emit = _stack(ings, "emit")
            lineage = OL.lineage_update(lineage, {
                "queueing": (_stack(ings, "q_lat"), _stack(ings, "q_mask")),
                "window": (w_lat, emit),
                "hop1": (now - taps.hop1_birth, taps.hop1_mask),
                "hop2": (now - taps.hop2_birth, taps.hop2_mask),
                "e2e": (w_lat, emit),
            })

        with tr.span("obs:metrics"):
            stacked = SimpleNamespace(**{k: _stack(ings, k) for k in (
                "n_in", "n_accepted", "n_deduped", "n_dequeued", "n_late",
                "n_replayed", "n_backfilled", "emit", "consequence",
                "drift")})
            stored = result.stored.reshape(s, n)
            dropped = result.dropped.reshape(s, n)
            metrics = advance_metrics(
                sh.metrics, stacked, core_live.sum(-1, dtype=torch.int32),
                stored.sum(-1, dtype=torch.int32),
                dropped.sum(-1, dtype=torch.int32),
                (core_live & ~processed).sum(-1, dtype=torch.int32))
            # fleet totals sum over members only
            contrib = StreamMetrics(*(
                torch.where(active.reshape((s,) + (1,) * (v.ndim - 1)), v,
                            0) for v in metrics))
            fleet = F.allreduce_metrics(contrib)
        adm = sh.adm if cfg.stream.admission.inert else SI.AdmissionState(
            _stack([i.adm for i in ings], "seen"),
            _stack([i.adm for i in ings], "seen_pos"))
        new_shard = StreamState(
            rb=RingBuffer(sh.rb.store, _stack([i.rb for i in ings], "head"),
                          _stack([i.rb for i in ings], "tail")),
            carry=_stack(ings, "carry"),
            carry_valid=_stack(ings, "carry_valid"),
            max_ts=_stack(ings, "max_ts"), metrics=metrics, adm=adm)
        new_state = FleetState(
            shard=new_shard, fleet=fleet,
            escalations_sent=state.escalations_sent + stats.escalations_sent,
            fog_shed=state.fog_shed + stats.fog_shed,
            core_received=state.core_received + stats.core_received,
            core_processed=state.core_processed + stats.core_processed,
            fleet_core_overflow=state.fleet_core_overflow
            + stats.fleet_overflow,
            late_excluded=state.late_excluded
            + _stack(ings, "n_late_excluded"),
            watermark=wm.to(torch.float32),
            region_watermark=rwm.to(torch.float32))
        out = StepOutput(
            _stack(ings, "aggregates"), _stack(ings, "features"),
            _stack(ings, "window_count"), stacked.consequence, core_live,
            result.outputs.reshape((s, n) + result.outputs.shape[1:]))
        return new_state, out, lineage

    # -- public API ---------------------------------------------------------
    def step(self, state: FleetState, items, ts, offered=None,
             replay=None, mode=None) -> tuple[FleetState, StepOutput]:
        """One fleet tick: offer ``items [S, N, D]`` with event
        timestamps ``ts [S, N]`` (one producer batch a shard; tensors or
        numpy, moved to the executor's device), consume one window batch
        a shard.  The returned ``StepOutput`` leaves carry a leading
        ``[S]`` dim.

        ``offered``: optional ``[S, N]`` bool, which producer slots hold
        real items (a stalled shard's uplink offers nothing).
        ``mode``: optional ``[S]`` ``stream.ingest.MODE_*`` codes, which
        shards' batches are replay or backfill traffic (lateness-exempt,
        never moving the shard's own clock); ``replay``: the legacy
        ``[S]`` bool shorthand for ``MODE_REPLAY`` (not both).  The
        health and membership masks and the budgets set between ticks
        ride along.  Replay or backfill needs a ring drained every tick
        (``N <= micro_batch``), checked on the host.

        ``last_step_seconds`` is the host wall time of the call; with
        ``measure_steps`` (the default) it synchronizes the card before
        the clock stops, so it includes the device's work."""
        cfg, dev = self.cfg, self.device
        if replay is not None and mode is not None:
            raise ValueError("pass either replay (bool shorthand) or "
                             "mode (MODE_* codes), not both")
        if replay is not None:
            mode = np.where(np.asarray(replay, bool),
                            SI.MODE_REPLAY, SI.MODE_LIVE).astype(np.int32)
        if mode is None:
            mode = np.zeros(cfg.num_shards, np.int32)
        else:
            mode = np.asarray(mode.cpu() if isinstance(mode, torch.Tensor)
                              else mode, np.int32)
            if mode.any() and items.shape[1] > cfg.stream.micro_batch:
                raise ValueError(
                    f"replay/backfill needs a per-tick-drained ring: "
                    f"offer size {items.shape[1]} > micro_batch "
                    f"{cfg.stream.micro_batch} leaves reprocessed "
                    "rows queued past their lateness-exempt tick")
        items = torch.as_tensor(items, device=dev)
        ts = torch.as_tensor(ts, device=dev)
        offered = torch.ones(items.shape[:2], dtype=torch.bool, device=dev) \
            if offered is None else torch.as_tensor(offered, device=dev) \
            .to(torch.bool)
        _check_ring(state.shard.rb.store, (cfg.stream.capacity + 1,
                                           META_COLS + items.shape[-1]))
        self._step_num += 1
        feed = 0.0 if self._skip_feed else self.last_step_seconds
        if self._skip_feed and self.last_step_seconds > 0.0:
            self.warmup_excluded += 1
        builds_before, compiles_before = build.builds, self._compile_count()
        t0 = time.perf_counter()
        with self.tracer.step_annotation("fleet_tick", self._step_num):
            with self.tracer.span("fleet.dispatch", step=self._step_num):
                # the masks and budgets are small cached constants
                # (device_constant), copied into the tick's static
                # buffers before a replay
                out, state, self._lat_hist, self._lineage = self._tick_step(
                    state, self._lat_hist, self._lineage, items, ts, offered,
                    device_constant(tuple(mode.tolist()), torch.int32, dev),
                    device_constant(tuple(self._healthy.tolist()),
                                    torch.bool, dev),
                    device_constant(tuple(self._active.tolist()),
                                    torch.bool, dev),
                    capture.Scalar(self._budget, torch.int32),
                    device_constant(tuple(self._region_budget.tolist()),
                                    torch.int32, dev),
                    capture.Scalar(time.perf_counter() - self._t0,
                                   torch.float32),
                    capture.Scalar(feed, torch.float32),
                    static_key=self._static_key())
            if self.measure_steps and dev.type == "cuda":
                with self.tracer.span("fleet.device_execute",
                                      step=self._step_num):
                    torch.cuda.synchronize(dev)
        self.last_step_seconds = time.perf_counter() - t0
        self._skip_feed = build.builds > builds_before \
            or self._compile_count() > compiles_before
        return state, out

    # -- a change of width ------------------------------------------------
    def remesh(self, state: FleetState, num_shards: int, *,
               keep: list | None = None, num_core: int | None = None,
               num_regions: int | None = None,
               fold_counters: dict | None = None
               ) -> tuple[FleetState, dict]:
        """Re-lay the fleet over ``num_shards`` shards and migrate the
        state: churn beyond what the ``active`` mask absorbs.

        The new ``(region, edge)`` shape is ``runtime.elastic.remesh``'s,
        resizing ONE dim a call: by default the region count is kept and
        the edge width absorbs the change; pass ``num_regions`` to
        resize the regions instead (the edge width then stays).

        ``keep``: for each NEW slot (region-major), the OLD shard whose
        row (ring, carry, watermark, counters) it inherits, or ``None``
        for a fresh row (a joiner); defaults to truncation on shrink and
        fresh tail slots on grow.  ``num_core`` defaults to the old value
        clamped to the new width.  ``fold_counters``: optional {departed
        old index -> kept old index}: the departed shard's monotone
        counters and lineage are added into the kept row.

        Returns ``(new_state, departed)``: each dropped old shard's
        *unconsumed* ring rows as a host ``[k, 2+D]`` array (event ts in
        column 0, the ingest stamp in column 1), the backup-replay
        payload.  A region keeps its identity across an edge resize
        (its watermark and fog budget carry over); a region-count change
        re-derives them."""
        cfg = self.cfg
        old_e, old_r = cfg.num_shards, cfg.num_regions
        fix_regions = num_regions is None or num_regions == old_r
        new_r, new_ee = elastic.remesh(old_r, cfg.edges_per_region,
                                       num_shards, fix_regions)
        if not fix_regions and new_r != num_regions:
            raise ValueError(
                f"{num_shards} devices at edge width "
                f"{cfg.edges_per_region} form {new_r} regions, not "
                f"num_regions={num_regions} -- resize one axis per call")
        new_e = new_r * new_ee
        if keep is None:
            keep = [i if i < old_e else None for i in range(new_e)]
        if len(keep) != new_e:
            raise ValueError(f"keep must name {new_e} slots, got {keep}")
        kept = [k for k in keep if k is not None]
        if len(set(kept)) != len(kept) \
                or any(not (0 <= k < old_e) for k in kept):
            raise ValueError(f"keep must be distinct old indices < "
                             f"{old_e} (or None), got {keep}")
        departed_idx = [i for i in range(old_e) if i not in kept]
        fold_counters = fold_counters or {}
        if any(src not in departed_idx or dst not in kept
               for src, dst in fold_counters.items()):
            raise ValueError(f"fold_counters must map departed -> kept "
                             f"old indices, got {fold_counters} with "
                             f"departed={departed_idx}")

        rb = state.shard.rb
        head, tail = rb.head.cpu().numpy(), rb.tail.cpu().numpy()
        cap = rb.store.shape[1] - 1
        departed = {}
        for i in departed_idx:
            idx = (int(tail[i]) + np.arange(int(head[i]) - int(tail[i]))) \
                % cap
            departed[i] = rb.store[i][torch.as_tensor(
                idx, device=rb.store.device)].cpu().numpy()
        if fold_counters:
            folded = {}
            for name in ("escalations_sent", "fog_shed", "core_received",
                         "core_processed", "late_excluded"):
                folded[name] = getattr(state, name).clone()
            shard_m = [v.clone() for v in state.shard.metrics]
            for src, dst in fold_counters.items():
                for arr in shard_m + list(folded.values()):
                    arr[dst] += arr[src]
            state = state._replace(
                shard=state.shard._replace(metrics=StreamMetrics(*shard_m)),
                **folded)

        feature_dim = rb.store.shape[-1] - META_COLS
        self.cfg = dataclasses.replace(
            cfg, num_shards=new_e, num_regions=new_r,
            num_core=min(cfg.num_core, new_ee) if num_core is None
            else num_core)
        fresh = self.init_state(feature_dim)
        new_state = elastic.reshard_state(state, keep, fresh)
        f32_min = torch.finfo(torch.float32).min
        if new_r == old_r:
            # an edge-width resize keeps region identity: each region's
            # watermark carries over, whoever fills its slots, and the
            # fog ceiling only grows
            old_rwm = state.region_watermark.reshape(old_r, -1)[:, 0]
            new_state = new_state._replace(
                region_watermark=old_rwm.repeat_interleave(new_ee))
            self._fog_slots = max(self._fog_slots, self.cfg.fog_slots)
            if self.cfg.fog_budget is None \
                    and self.cfg.fog_budget_max is None:
                self._region_budget = np.maximum(
                    self._region_budget,
                    np.int32(self.cfg.initial_fog_budget))
        else:
            # a region-count change re-forms the regions: their
            # watermarks and fog budgets re-derive
            new_state = new_state._replace(region_watermark=torch.full(
                (new_e,), f32_min, dtype=torch.float32, device=self.device))
            self._fog_slots = self.cfg.fog_slots
            rbud = np.full(new_r, min(self.cfg.initial_fog_budget,
                                      self._fog_slots), np.int32)
            lap = min(old_r, new_r)
            rbud[:lap] = np.minimum(self._region_budget[:lap],
                                    self._fog_slots)
            self._region_budget = rbud

        self._healthy = np.asarray(
            [self._healthy[k] if k is not None else True for k in keep])
        self._active = np.asarray(
            [self._active[k] if k is not None else True for k in keep])
        # the lineage banks are per-shard: fold departed rows into their
        # counter-fold survivor, then renumber by keep
        lin = self._lineage.clone()
        for src, dst in fold_counters.items():
            lin[dst] = OL.histogram_merge(lin[dst], lin[src])
        self._lineage = torch.stack(
            [lin[k] if k is not None else torch.zeros_like(lin[0])
             for k in keep])
        self._remeshes += 1
        self._tick_step.clear()         # the next tick builds anew
        return new_state, departed
