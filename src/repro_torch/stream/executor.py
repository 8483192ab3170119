"""Continuous micro-batch stream executor (ingest -> windows -> rules
-> pipeline).

Port of ``repro.stream.executor``: producers post sensor tuples into
the ring buffer (``data.ringbuffer``), the edge consumes them in
fixed-size micro-batches, computes windowed aggregates
(``stream.windows``), evaluates the data-driven IF-THEN rules on the
per-window features (``core.rules``), and pushes the window records
through a ``DataDrivenPipeline`` whose rule-gated core stage is
capacity-bounded.

Each tick is a fixed-shape sequence of tensor ops with no host read of
a device value (no ``.item()``, no Python branch on a device value).
The reference jits it once and counts its traces; here the tick is a
``runtime.capture.Step``: built once for each signature (``trace_count``;
``_compile_count`` the CUDA graphs captured), its first call eager, on
the card captured then and replayed on every later call.  The budget,
the ingest mode, ``now`` and the fed wall time are operands filled in
before each replay, never values frozen into the graph.  The stage
spans of an enabled tracer (``obs:ingest``, ...) run in Python, so on
the card they are recorded at the warm-up and at the capture only;
``stream.dispatch`` marks every step.  ``step_cost`` runs the tick
eagerly on a copy and counts no trace.

Cross-batch window continuity: the executor carries the trailing
``window - stride`` samples between steps, so every step emits exactly
``micro_batch // stride`` complete windows and consecutive steps tile
the stream with no gap and no double count.

State is updated in place where the reference donated it (the ring's
storage): a ``StreamState`` handed to ``step`` is consumed.  The rest of
the returned state, and the outputs, are the caller's: the next step
never overwrites them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import rules as R
from repro_torch.core.pipeline import DataDrivenPipeline
from repro_torch.data import ringbuffer as rbuf
from repro_torch.kernels import build
from repro_torch.kernels.fused_tick import fused_tick
from repro_torch.obs import costmodel as OC
from repro_torch.obs import latency as OL
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.runtime import capture
from repro_torch.stream import ingest as I
from repro_torch.stream import windows as W


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static shape/policy knobs.

    The reference's ``backend``/``interpret`` have no counterpart: on
    the card the staged path (``fused=False``) always runs the
    ``window_reduce`` kernel and the fused path always runs the
    ``fused_tick`` kernel; on the CPU both run their plain versions.
    """
    micro_batch: int               # samples dequeued per step (B)
    window: int                    # samples per window (W)
    stride: int                    # window start spacing (S), S <= W
    capacity: int = 4096           # ring-buffer capacity (items)
    lateness: float = 0.0          # watermark slack (event-time units)
    min_count: int = 1             # valid samples for a window to fire
    fused: bool = False            # fused window+features+rules tick
    overlap_ingest: bool = False   # stage tick N+1 during tick N (run())
    ingest_int8: bool = False      # int8-quantize staged telemetry (lossy)
    admission: I.AdmissionPlan = I.AdmissionPlan()   # dedupe + contract lane

    def __post_init__(self):
        if not (0 < self.stride <= self.window):
            raise ValueError(f"need 0 < stride <= window, got {self}")
        if self.micro_batch % self.stride or self.micro_batch < self.stride:
            raise ValueError("micro_batch must be a positive multiple of "
                             f"stride, got {self}")
        if self.capacity < self.micro_batch:
            raise ValueError("capacity must hold one micro-batch")
        if self.ingest_int8 and not self.overlap_ingest:
            raise ValueError("ingest_int8 rides the overlapped ingest "
                             "stager: set overlap_ingest=True too")

    @property
    def windows_per_step(self) -> int:
        return self.micro_batch // self.stride

    @property
    def carry_len(self) -> int:
        return self.window - self.stride


class StreamMetrics(NamedTuple):
    """Monotone int32 counters, updated on the device every step."""
    steps: torch.Tensor
    items_offered: torch.Tensor     # producer -> enqueue attempts
    items_accepted: torch.Tensor    # made it into the ring
    items_rejected: torch.Tensor    # contract violations + backpressure
    items_dequeued: torch.Tensor    # consumed by the executor
    items_late: torch.Tensor        # dropped by the watermark
    items_replayed: torch.Tensor    # backup-replay records (lateness-exempt)
    items_deduped: torch.Tensor     # offered rows dropped as re-deliveries
    items_backfilled: torch.Tensor  # backfill-mode records (lateness-exempt)
    windows_emitted: torch.Tensor   # windows with >= min_count samples
    rules_fired: torch.Tensor       # windows with consequence != NONE
    windows_escalated: torch.Tensor # sent to the core tier
    windows_stored: torch.Tensor    # store-at-edge consequence
    windows_dropped: torch.Tensor   # quality-dropped
    core_overflow: torch.Tensor     # flagged beyond core_capacity
    drift_counts: torch.Tensor      # [D] per-field contract violations

    def as_dict(self) -> dict[str, int | list[int]]:
        """Host-side snapshot in one device-to-host transfer, plain
        ints (``drift_counts`` as a list)."""
        host = torch.cat([torch.stack(self[:-1]),
                          self.drift_counts]).cpu().tolist()
        out = dict(zip(self._fields[:-1], host))
        out["drift_counts"] = host[len(self) - 1:]
        return out


def _zero_metrics(feature_dim: int, device) -> StreamMetrics:
    return StreamMetrics(
        *(torch.zeros((), dtype=torch.int32, device=device)
          for _ in StreamMetrics._fields[:-1]),
        drift_counts=torch.zeros((feature_dim,), dtype=torch.int32,
                                 device=device))


#: Ring rows are [ts | ingest_wall | features]: column 0 the event
#: timestamp, column 1 the ingest wall time (seconds since the
#: executor's epoch, f32) stamped at enqueue -- the birth stamp the
#: event-time latency lineage measures every stage against.
META_COLS = 2


class StreamState(NamedTuple):
    rb: rbuf.RingBuffer            # [cap, META_COLS+D] rows (see above)
    carry: torch.Tensor            # [W-S, META_COLS+D] trailing samples
    carry_valid: torch.Tensor      # [W-S] bool
    max_ts: torch.Tensor           # [] f32 running max event time
    metrics: StreamMetrics
    adm: I.AdmissionState          # dedupe-window ring ([0] when inert)


class StepOutput(NamedTuple):
    aggregates: torch.Tensor       # [NW, D] mean window aggregate
    features: torch.Tensor         # [NW, 5] rule features (signal col)
    window_count: torch.Tensor     # [NW] valid samples per window
    consequence: torch.Tensor      # [NW] rule consequence codes
    escalated: torch.Tensor        # [NW] bool reached the core tier
    outputs: torch.Tensor          # [NW, ...] pipeline outputs


class IngestResult(NamedTuple):
    """Front half of a stream step (ingest -> watermark -> windows ->
    rules)."""
    rb: rbuf.RingBuffer
    carry: torch.Tensor
    carry_valid: torch.Tensor
    max_ts: torch.Tensor
    aggregates: torch.Tensor       # [NW, D]
    window_count: torch.Tensor     # [NW]
    features: torch.Tensor         # [NW, 5]
    consequence: torch.Tensor      # [NW] engine codes (emit-masked)
    emit: torch.Tensor             # [NW] bool count >= min_count
    record: torch.Tensor           # [NW, 5 + D] features ++ aggregate
    n_in: torch.Tensor
    n_accepted: torch.Tensor
    n_dequeued: torch.Tensor
    n_late: torch.Tensor
    n_late_excluded: torch.Tensor  # admitted, but late vs the fleet ref
    n_replayed: torch.Tensor       # replay-mode records (never late-dropped)
    n_deduped: torch.Tensor        # offered rows dropped by the dedupe window
    n_backfilled: torch.Tensor     # backfill-mode records (never late-dropped)
    drift: torch.Tensor            # [D] per-field contract violations
    adm: I.AdmissionState          # rotated dedupe window (post-record)
    q_lat: torch.Tensor            # [B] f32 queueing delay per dequeued row
    q_mask: torch.Tensor           # [B] bool which rows were dequeued
    w_birth: torch.Tensor          # [NW] f32 oldest ingest stamp per window


def _scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-dim device tensor from a host number, written by a fill
    kernel rather than copied (a pageable copy would wait for the
    card); tensors pass through."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


def clone_state(tree):
    """A copy of a (nested) NamedTuple of tensors, every tensor cloned."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(clone_state(x) for x in tree))


#: what a tick changes on an executor besides its state: restored by
#: :func:`cost_of`
_HOST_SIDE = ("_lat_hist", "_lineage", "last_step_seconds", "_skip_feed",
              "tracer")


def cost_of(executor, tick, *args) -> dict:
    """``obs.costmodel.analyze`` of ``tick(*args)`` with a recording
    tracer installed on ``executor`` (its stage spans attribute the
    cost), and the executor's host-side counters restored afterwards:
    the tick runs once, so hand it a copy of the state."""
    saved = {k: getattr(executor, k) for k in _HOST_SIDE}
    tr = Tracer()
    executor.tracer = tr
    try:
        return OC.analyze(tick, *args, tracer=tr)
    finally:
        for k, v in saved.items():
            setattr(executor, k, v)


def _check_ring(store: torch.Tensor, want: tuple) -> None:
    """A ring of another shape than the executor's raises: the tick is
    built for its own (a foreign ring of the right shape is copied
    in)."""
    if tuple(store.shape[-2:]) != want:
        raise ValueError(f"ring {tuple(store.shape)} does not match the "
                         f"executor's [..., {want[0]}, {want[1]}] "
                         "(capacity + 1, 2 + D)")


def _count(mask: torch.Tensor) -> torch.Tensor:
    """True entries along the last dim (a leading shard dim stays)."""
    return mask.sum(-1, dtype=torch.int32)


def ingest_and_window(cfg: StreamConfig, engine: R.RuleEngine,
                      state: StreamState, items: torch.Tensor,
                      ts: torch.Tensor,
                      watermark_ts: torch.Tensor | None = None,
                      offer_mask: torch.Tensor | None = None,
                      excluded_ref: torch.Tensor | None = None,
                      replay=None, mode=None,
                      now: torch.Tensor | float = 0.0,
                      tracer=NULL_TRACER) -> IngestResult:
    """enqueue -> dequeue -> watermark -> carry-continuous windows ->
    rule features, on fixed shapes.

    ``watermark_ts``: reference max event time for the late test,
    defaulting to this stream's own ``state.max_ts``; a fleet passes the
    fleet-wide minimum of per-shard maxima, so lagging shards hold back
    window close everywhere.  The shard's own running max only ever
    advances.  ``offer_mask``: optional [N] bool, which producer slots
    hold real items this tick (a stalled uplink offers nothing; shapes
    stay fixed).  ``excluded_ref``: optional fleet reference used only
    for accounting: items admitted by ``watermark_ts`` but late by it
    are counted in ``n_late_excluded`` (a straggler-excluded shard's
    catch-up records, processed locally and flagged).

    ``mode`` (``MODE_*``, int or 0-dim tensor) is the ingest mode of
    the offered batch: replayed and backfilled rows the offer
    contributed are lateness-exempt and never advance the local clock.
    ``replay`` (bool or 0-dim tensor) is the legacy shorthand for
    ``MODE_REPLAY``; passing both is an error.  ``now`` is this tick's
    wall time (seconds since the executor's epoch) stamped on every
    enqueued row and measured against by the lineage taps
    ``q_lat``/``q_mask`` (per dequeued row) and ``w_birth`` (per
    window, the oldest valid sample's stamp; 0 for empty windows).

    Before any row reaches the ring it passes the admission lane of
    ``cfg.admission``; the default (inert) plan skips it statically.

    ``tracer``: an enabled ``obs.trace.Tracer`` marks the stages
    (``obs:ingest``, ``obs:window``, ...) on a profiler timeline; the
    default marks nothing and costs nothing.
    """
    if replay is not None and mode is not None:
        raise ValueError("pass either replay= (bool shorthand) or "
                         "mode= (stream.ingest mode code), not both")
    dev = state.rb.store.device
    if replay is not None:
        mode = torch.where(_scalar(replay, torch.bool, dev),
                           I.MODE_REPLAY, I.MODE_LIVE).to(torch.int32)
    n_in = items.shape[0]
    plan = cfg.admission
    held = state.rb.head - state.rb.tail       # rows queued before this offer
    now = _scalar(now, torch.float32, dev)
    with tracer.span("obs:ingest"):
        rows_in = torch.cat(
            [ts.to(torch.float32)[:, None], now.expand(n_in, 1),
             items.to(torch.float32)], dim=1)
        if offer_mask is None:
            n_offered = _scalar(n_in, torch.int32, dev)
        else:
            n_offered = _count(offer_mask.to(torch.bool))
        if plan.inert:
            n_dedup = torch.zeros((), dtype=torch.int32, device=dev)
            drift = torch.zeros((items.shape[1],), dtype=torch.int32,
                                device=dev)
            adm = state.adm
            rb, n_acc = rbuf.enqueue(state.rb, rows_in, offer_mask)
        else:
            with tracer.span("obs:admission"):
                gate = I.admission_gate(plan, state.adm, ts, items,
                                        offer_mask)
                rb, n_acc = rbuf.enqueue(state.rb, rows_in, gate.admit)
                adm = I.admission_record(plan, state.adm, gate, n_acc)
            n_dedup = gate.n_deduped
            drift = gate.drift
        rb, rows, valid = rbuf.dequeue(rb, cfg.micro_batch)
    wm = state.max_ts if watermark_ts is None \
        else _scalar(watermark_ts, torch.float32, dev)
    dequeued = valid
    if mode is None:
        exempt = None
    else:
        # FIFO positional split: rows the ring held before this offer
        # dequeue first and keep exact normal semantics; only the rows
        # a replay/backfill offer contributed are lateness-exempt
        mode = _scalar(mode, torch.int32, dev)
        reproc = mode >= I.MODE_REPLAY
        pos = torch.arange(cfg.micro_batch, dtype=held.dtype, device=dev)
        exempt = reproc & (pos >= held)
    with tracer.span("obs:watermark"):
        valid, n_late, max_ts = W.apply_watermark(
            rows[:, 0], valid, wm, cfg.lateness, exempt=exempt)
    max_ts = torch.maximum(state.max_ts, max_ts)
    if mode is None:
        n_rep = torch.zeros((), dtype=torch.int32, device=dev)
        n_bf = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        n_ex = _count(exempt & dequeued)
        n_rep = torch.where(mode == I.MODE_REPLAY, n_ex, 0)
        n_bf = torch.where(mode == I.MODE_BACKFILL, n_ex, 0)
        # reprocessed rows never advance the local event-time clock
        own_max = torch.where(dequeued & ~exempt, rows[:, 0],
                              torch.finfo(torch.float32).min).amax()
        max_ts = torch.where(reproc, torch.maximum(state.max_ts, own_max),
                             max_ts)
    if excluded_ref is None:
        n_lx = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        live = valid if exempt is None else valid & ~exempt
        ref = _scalar(excluded_ref, torch.float32, dev)
        n_lx = _count(live & (rows[:, 0] < ref - cfg.lateness))

    # cross-batch continuity: prepend the carried W-S samples
    seq = torch.cat([state.carry, rows], dim=0)
    seq_valid = torch.cat([state.carry_valid, valid], dim=0)
    q_lat = now - rows[:, 1]
    if cfg.fused:
        # one pass over the block: window reduction, rule features,
        # lineage birth and the rule sweep (the fused_tick kernel on
        # the card), bitwise equal to the staged scopes below
        with tracer.span("obs:fused_tick"):
            agg, wcount, feats, w_birth, cons = fused_tick(
                seq, seq_valid, cfg.window, cfg.stride,
                table=engine.table(), min_count=cfg.min_count,
                meta_cols=META_COLS)
            emit = wcount >= cfg.min_count
    else:
        with tracer.span("obs:window"):
            sig = seq[:, META_COLS:]
            agg, wcount = W.sliding_window(
                sig, seq_valid, cfg.window, cfg.stride, reducer="mean",
                partial=False)
            feats, _ = W.window_features(sig, seq_valid, cfg.window,
                                         cfg.stride, partial=False)
        with tracer.span("obs:lineage"):
            # per-window birth stamp: the oldest valid sample's
            w_birth, _ = W.sliding_window(
                seq[:, 1:2], seq_valid, cfg.window, cfg.stride,
                reducer="min", partial=False)
            w_birth = w_birth[:, 0]
        with tracer.span("obs:rules"):
            emit = wcount >= cfg.min_count
            _, cons = engine.evaluate(feats)
            cons = torch.where(emit, cons, R.C_NONE)
    record = torch.cat([feats, agg], dim=1)                 # [NW, 5 + D]
    keep = seq.shape[0] - cfg.carry_len
    return IngestResult(
        rb=rb, carry=seq[keep:], carry_valid=seq_valid[keep:],
        max_ts=max_ts, aggregates=agg, window_count=wcount, features=feats,
        consequence=cons, emit=emit, record=record,
        n_in=n_offered, n_accepted=n_acc,
        n_dequeued=_count(valid) + n_late,
        n_late=n_late, n_late_excluded=n_lx, n_replayed=n_rep,
        n_deduped=n_dedup, n_backfilled=n_bf, drift=drift, adm=adm,
        q_lat=q_lat, q_mask=dequeued, w_birth=w_birth)


def advance_metrics(m: StreamMetrics, ing: IngestResult,
                    n_escalated: torch.Tensor, n_stored: torch.Tensor,
                    n_dropped: torch.Tensor,
                    overflow: torch.Tensor) -> StreamMetrics:
    """One step's worth of counter increments.

    Conservation per tick: ``n_in == n_accepted + rejected + deduped``
    (``items_rejected`` covers contract violations and ring
    backpressure; deduped re-deliveries are accounted apart)."""
    return StreamMetrics(
        steps=m.steps + 1,
        items_offered=m.items_offered + ing.n_in,
        items_accepted=m.items_accepted + ing.n_accepted,
        items_rejected=m.items_rejected
        + (ing.n_in - ing.n_accepted - ing.n_deduped),
        items_dequeued=m.items_dequeued + ing.n_dequeued,
        items_late=m.items_late + ing.n_late,
        items_replayed=m.items_replayed + ing.n_replayed,
        items_deduped=m.items_deduped + ing.n_deduped,
        items_backfilled=m.items_backfilled + ing.n_backfilled,
        windows_emitted=m.windows_emitted + _count(ing.emit),
        rules_fired=m.rules_fired + _count(ing.consequence != R.C_NONE),
        windows_escalated=m.windows_escalated + n_escalated,
        windows_stored=m.windows_stored + n_stored,
        windows_dropped=m.windows_dropped + n_dropped,
        core_overflow=m.core_overflow + overflow,
        drift_counts=m.drift_counts + ing.drift,
    )


class StreamExecutor:
    """Drives a continuous stream through ring buffer -> windows ->
    rules -> pipeline, one fixed-shape tick per ``step``.

    engine: rule engine evaluated on the [NW, 5] window features.
    pipeline: run on the [NW, 5 + D] window records (features
    concatenated with the mean aggregate).
    device: ``None`` is the CUDA card (raises without one);
    ``"cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, cfg: StreamConfig, engine: R.RuleEngine,
                 pipeline: DataDrivenPipeline,
                 device: str | torch.device | None = None):
        if cfg.fused and engine.table() is None:
            raise ValueError(
                "StreamConfig(fused=True) needs a tabular RuleEngine "
                "(threshold_rule-style rules only) -- callable rules "
                "cannot run inside the fused kernel; use fused=False")
        self.cfg = cfg
        self.engine = engine
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self._budget = None            # dynamic core budget
        self.last_step_seconds = 0.0   # host wall time of the last step()
        self.tracer = NULL_TRACER
        self._lat_hist = OL.histogram_init(device=self.device)
        self._lineage = OL.lineage_init(device=self.device)
        self._t0 = time.perf_counter()     # lineage epoch (f32-friendly)
        # warmup exclusion: a step during which a kernel was built
        # measured the build, not the tick -- its wall time is withheld
        # from the histogram (fed as 0.0, the "missing" sentinel)
        self._skip_feed = False
        self.warmup_excluded = 0
        self._step_num = 0
        # the compile-once tick: state, histogram and lineage donated
        self._tick_step = capture.Step(self._tick, device=self.device,
                                       donate_argnums=(0, 1, 2),
                                       name="stream tick")

    @property
    def trace_count(self) -> int:
        """Tick signatures built so far: 1 after the first step of a
        fixed feed, one more for each new producer batch shape."""
        return self._tick_step.trace_count

    def _compile_count(self) -> int:
        """CUDA graphs of the tick captured (>= trace_count; on the CPU,
        where nothing is captured, equal to it)."""
        return self._tick_step.compile_count

    # -- state ------------------------------------------------------------
    def init_state(self, feature_dim: int) -> StreamState:
        cfg, dev = self.cfg, self.device
        return StreamState(
            rb=rbuf.create(cfg.capacity, (META_COLS + feature_dim,),
                           device=dev),
            carry=torch.zeros((cfg.carry_len, META_COLS + feature_dim),
                              dtype=torch.float32, device=dev),
            carry_valid=torch.zeros((cfg.carry_len,), dtype=torch.bool,
                                    device=dev),
            max_ts=torch.full((), torch.finfo(torch.float32).min,
                              dtype=torch.float32, device=dev),
            metrics=_zero_metrics(feature_dim, dev),
            adm=I.admission_init(cfg.admission, dev),
        )

    def set_tracer(self, tracer) -> None:
        """Install an ``obs.trace.Tracer``: an enabled one marks each
        ``step()`` and its stages on a ``torch.profiler`` timeline."""
        self.tracer = tracer

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Step-latency percentiles from the device histogram (one host
        transfer).  A step's wall time feeds the histogram on the next
        tick; steps that built a kernel or a tick signature (the first
        step, a capture) are excluded and counted in
        ``warmup_excluded``."""
        out = OL.histogram_percentiles(self._lat_hist, qs)
        out["warmup_excluded"] = self.warmup_excluded
        return out

    def lineage_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Per-stage event-time latency percentiles (one host transfer
        of the lineage bank) over ``obs.latency.LINEAGE_STAGES``."""
        return OL.lineage_percentiles(self._lineage, qs)

    def step_cost(self, state: StreamState, items, ts) -> dict:
        """Cost of ONE tick at these operands (``obs.costmodel.analyze``):
        total FLOPs and bytes plus the per-stage breakdown.  The tick runs
        once on a copy of ``state`` with the executor's latency
        histogram, lineage bank and step clock restored afterwards, so
        nothing is consumed: the next ``step`` is the one it would have
        been.  It runs eagerly and builds no tick signature."""
        dev = self.device
        return cost_of(
            self, self._tick, clone_state(state), self._lat_hist.clone(),
            self._lineage.clone(),
            torch.as_tensor(items, device=dev), torch.as_tensor(ts, device=dev),
            _scalar(self._effective_budget(), torch.int32, dev),
            _scalar(0.0, torch.float32, dev), _scalar(0.0, torch.float32, dev),
            _scalar(I.MODE_LIVE, torch.int32, dev))

    @property
    def core_budget(self) -> int | None:
        """Dynamic core budget, or None for the pipeline's static cap."""
        return self._budget

    def set_core_budget(self, budget: int) -> None:
        """Resize the effective core budget between steps: an operand
        of the tick, so no new signature.  The static
        ``pipeline.core_capacity`` stays the compaction shape (and the
        resize ceiling)."""
        if budget < 0:
            raise ValueError(f"core budget must be >= 0, got {budget}")
        self._budget = int(budget)

    def _effective_budget(self) -> int:
        cap = self.pipeline.core_capacity
        if self._budget is None:
            return cap if cap is not None else self.cfg.windows_per_step
        return self._budget if cap is None else min(self._budget, cap)

    # -- one tick -----------------------------------------------------------
    def _tick(self, state: StreamState, lat_hist: torch.Tensor,
              lineage: torch.Tensor, items: torch.Tensor, ts: torch.Tensor,
              budget: torch.Tensor, last_dt: torch.Tensor, now: torch.Tensor,
              mode: torch.Tensor):
        """The tick as a function of its operands: (out, state,
        histogram, lineage bank), the last three the donated ones."""
        ing = ingest_and_window(self.cfg, self.engine, state, items, ts,
                                mode=mode, now=now, tracer=self.tracer)
        # non-emitted windows (count < min_count) enter the pipeline
        # dead: no rules, no escalation, no core-capacity consumption
        with self.tracer.span("obs:pipeline"):
            result = self.pipeline.run(ing.record, live=ing.emit,
                                       core_budget=budget)
        n_esc = _count(result.escalated)
        overflow = torch.clamp(n_esc - budget, min=0)
        with self.tracer.span("obs:metrics"):
            metrics = advance_metrics(
                state.metrics, ing, n_esc, _count(result.stored),
                _count(result.dropped), overflow)
            lat_hist = OL.histogram_update(lat_hist, last_dt)
        with self.tracer.span("obs:lineage"):
            w_lat = now - ing.w_birth
            lineage = OL.lineage_update(lineage, {
                "queueing": (ing.q_lat, ing.q_mask),
                "window": (w_lat, ing.emit),
                "e2e": (w_lat, ing.emit),
            })
        new_state = StreamState(
            rb=ing.rb, carry=ing.carry, carry_valid=ing.carry_valid,
            max_ts=ing.max_ts, metrics=metrics, adm=ing.adm)
        return StepOutput(ing.aggregates, ing.features, ing.window_count,
                          ing.consequence, result.escalated,
                          result.outputs), new_state, lat_hist, lineage

    def _static_key(self) -> tuple:
        """What the tick's shapes and code depend on besides its
        operands: the config, the rule table and the compaction shape."""
        table = self.engine.table()
        return (id(self.cfg), table if table is not None else id(self.engine),
                self.pipeline.core_capacity)

    # -- public API ---------------------------------------------------------
    def step(self, state: StreamState, items, ts,
             mode: int | torch.Tensor = I.MODE_LIVE
             ) -> tuple[StreamState, StepOutput]:
        """One micro-batch tick: offer ``items [N, D]`` with event
        timestamps ``ts [N]`` (tensors or numpy arrays; moved to the
        executor's device), consume one window batch.

        ``mode``: this tick's ingest mode (``stream.ingest.MODE_*``).

        Timestamps ride the ring as float32, so event-time resolution
        degrades past ~2^24 time units; the ingest stamp (row column 1)
        is wall seconds since executor construction, with the same
        caveat after ~2^24 seconds.

        ``last_step_seconds`` records the host wall time of the call --
        the enqueue time unless the caller synchronizes.  The previous
        step's wall time feeds the device latency histogram, except
        after a step that built a kernel or a tick signature
        (``warmup_excluded``).  A ring other than ``[capacity + 1,
        2 + D]`` raises."""
        self._step_num += 1
        feed = 0.0 if self._skip_feed else self.last_step_seconds
        if self._skip_feed and self.last_step_seconds > 0.0:
            self.warmup_excluded += 1
        builds_before, compiles_before = build.builds, self._compile_count()
        dev = self.device
        items = torch.as_tensor(items, device=dev)
        ts = torch.as_tensor(ts, device=dev)
        _check_ring(state.rb.store, (self.cfg.capacity + 1,
                                     META_COLS + items.shape[-1]))
        t0 = time.perf_counter()
        with self.tracer.step_annotation("stream_step", self._step_num), \
                self.tracer.span("stream.dispatch", step=self._step_num):
            out, state, self._lat_hist, self._lineage = self._tick_step(
                state, self._lat_hist, self._lineage, items, ts,
                capture.Scalar(self._effective_budget(), torch.int32),
                capture.Scalar(feed, torch.float32),
                capture.Scalar(time.perf_counter() - self._t0,
                               torch.float32),
                capture.Scalar(mode, torch.int32),
                static_key=self._static_key())
        self.last_step_seconds = time.perf_counter() - t0
        self._skip_feed = build.builds > builds_before \
            or self._compile_count() > compiles_before
        return state, out

    def run(self, state: StreamState, producer: Iterable
            ) -> tuple[StreamState, list[StepOutput]]:
        """Drain a producer iterable of ``(items, ts)`` or ``(items, ts,
        mode)`` micro-batches.

        With ``cfg.overlap_ingest`` the host stages batch N+1
        (``runtime.overlap.IngestStager``, optionally int8) while the
        device computes batch N; ``step`` copies the staged batch into
        the tick's static items buffer on the compute stream.  Without
        int8 the outputs are bitwise those of the direct loop, and each
        batch keeps its mode."""
        outs = []
        if not self.cfg.overlap_ingest:
            for items, ts, *m in producer:
                state, out = self.step(state, items, ts,
                                       mode=m[0] if m else I.MODE_LIVE)
                outs.append(out)
            return state, outs
        from repro_torch.runtime.overlap import IngestStager
        stager = IngestStager(int8=self.cfg.ingest_int8, device=self.device)
        for items, ts, *m in producer:
            staged = stager.stage(items, ts, m[0] if m else I.MODE_LIVE)
            if staged is not None:
                state, out = self.step(state, *staged[:2], mode=staged[2])
                outs.append(out)
        staged = stager.flush()
        if staged is not None:
            state, out = self.step(state, *staged[:2], mode=staged[2])
            outs.append(out)
        return state, outs
