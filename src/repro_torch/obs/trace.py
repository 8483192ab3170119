"""Span tracer with ``torch.profiler`` hooks, device stage marks and
Chrome-trace export.

Port of ``repro.obs.trace``.  ``Tracer`` records lightweight wall-clock
spans around the host phases of a stream tick (prepare -> dispatch ->
the compile-once step's copy-in, launch and copy-out -> device execute
-> control).  While a profiler records (``with
tracer.profile(logdir)``), each span doubles as a
``torch.profiler.record_function`` range (where the reference used a
JAX ``TraceAnnotation``), so the same spans appear on the host
timeline beside the device ops; the executors' stage spans
(``obs:ingest``, ``obs:window``, ...) take the place of the reference's
``jax.named_scope`` labels (:data:`DEVICE_STAGES`).

A span is recorded when its Python runs.  The executors' ticks replay a
captured CUDA graph on the card (``runtime.capture``), in which no
Python runs, so a host stage span is recorded at the warm-up and the
capture only.  ``Tracer(device_marks=True)`` times the stages of every
tick: while a tick is captured, each ``obs:*`` span and the step's body
(``step.graph``) launch a one-thread mark (``kernels.stage_mark``) at
their open and their close.  The marks are nodes of the graph: every
replay writes ``%globaltimer`` into its row of a device ring the tracer
owns, and the tick's last mark advances the ring's row count, with no
host work.  :meth:`Tracer.device_stages` reads the ring in one transfer.
A mark is a node of about a microsecond of device time; a tick of the
8-shard fleet holds about 90 of them.  Without marks (the default) a
captured graph holds exactly what it held before, and the mark kernel
is never built.  On the CPU a mark writes ``time.perf_counter_ns()``.

Clocks.  Spans are read on ``time.perf_counter``.  The installed
``torch.profiler`` stamps its events on the Unix clock
(``CLOCK_REALTIME``, through kineto's approximate clock, in ns); a
Chrome export of a capture gives microseconds after its
``baseTimeNanoseconds``.  The tracer keeps the offset between the two
(``unix_offset_ns``), and :meth:`Tracer.calibrate` maps device marks
onto ``perf_counter``, so host spans, device stages and a profiler
capture of the same ticks lie on one clock.

Two export paths:

* :meth:`Tracer.export_chrome_trace` -- self-contained Chrome trace
  JSON (open in ``chrome://tracing`` or https://ui.perfetto.dev) of the
  host spans and, on a track of their own, the device stages;
* :meth:`Tracer.profile` -- a ``torch.profiler.profile`` capture of the
  host and, on the card, the CUDA activity, written to ``logdir`` as a
  Chrome trace when the context closes.

The spans open at a moment are kept too (:meth:`Tracer.open_stage`):
``obs.costmodel.analyze`` attributes each operation to the innermost
open ``obs:*`` span.

Overhead discipline: a disabled tracer (``NULL_TRACER``, the executors'
default) costs one attribute lookup and a pre-built null context per
span -- safe to leave in the hot path; an enabled tracer costs two
clock reads and one list append per span, and a ``record_function``
range while a profiler records; with marks, two mark launches per stage
span at the capture.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch

_NULL_CTX = contextlib.nullcontext()

#: The stage labels the port opens inside a tick, in hot-path order
#: (single-device prefix, then the fleet-only stages): the reference's
#: ``jax.named_scope`` taxonomy, with the admission lane and the fused
#: window kernel, which the port names apart.  ``obs.costmodel``
#: attributes operations to the innermost open one.
DEVICE_STAGES = (
    "obs:ingest", "obs:admission", "obs:watermark", "obs:fused_tick",
    "obs:window", "obs:lineage", "obs:rules", "obs:pipeline", "obs:metrics",
    "obs:fleet_watermark", "obs:edge_stages", "obs:exchange_core",
    "obs:all_to_all_out", "obs:fog_compact", "obs:all_to_all_region",
    "obs:core_compute", "obs:all_to_all_back", "obs:core_commit",
    "obs:latency",
)

#: The span of a compile-once step's captured body in the mark layouts.
GRAPH_SPAN = "step.graph"

#: The mark ring keeps the last RING_TICKS ticks, each with up to
#: RING_WIDTH - 1 marks (an 8-shard fleet tick makes 88): 4 MiB of int64.
#: A step whose tick marks more widens it before its first capture
#: (:meth:`Tracer.sizing`).
RING_TICKS, RING_WIDTH = 1024, 512

_SERIAL = itertools.count(1)


def _unix_offset_ns(tries: int = 8) -> int:
    """The Unix clock (``torch.profiler``'s) minus ``perf_counter``, in
    ns, from the narrowest of ``tries`` brackets."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


class _TickLayout:
    """The marks of one tick being captured: the next free slot of the
    ring's row (column 0 holds the layout's tag), the ``obs:*`` spans
    open, and each closed span's (name, depth, open slot, close slot);
    depth counts the ``obs:*`` spans around it.  A ``width`` of None
    counts the slots a tick takes and marks nothing."""

    def __init__(self, width: int | None):
        self.width = width
        self.next = 1
        self.depth = 0
        self.spans: list[tuple[str, int, int, int]] = []

    def take(self) -> int:
        slot = self.next
        if self.width is not None and slot >= self.width:
            raise RuntimeError(
                f"a tick marks more than the ring's {self.width - 1} slots "
                "a row (obs.trace.RING_WIDTH)")
        self.next += 1
        return slot


class Tracer:
    """Accumulates named host spans; thread-safe appends; with
    ``device_marks`` also the device time of every ``obs:*`` span of
    every captured tick (see the module docstring).

    Spans nest naturally in Chrome trace rendering (same thread id,
    containing timestamps).  ``args`` ride along into the trace
    viewer's detail pane.
    """

    def __init__(self, enabled: bool = True, device_marks: bool = False):
        if device_marks and not enabled:
            raise ValueError("a disabled tracer marks nothing")
        self.enabled = enabled
        self.device_marks = device_marks
        self._spans: list[tuple[str, float, float, int, dict]] = []
        self._lock = threading.Lock()
        self._open = threading.local()
        self._t0 = time.perf_counter()
        self.unix_offset_ns = _unix_offset_ns()
        self.calibrations: list[dict] = []
        # the mark ring (made by bind) and each tag's layout, tag - 1
        self._serial = next(_SERIAL) if device_marks else None
        self._ring = None
        self._probe = None
        self._layouts: list[tuple] = []

    @property
    def marks_key(self):
        """None for a tracer that marks nothing, else a number of its
        own: a compile-once step's signature includes it, so that a
        marking tracer captures a graph that writes its ring."""
        return self._serial

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._open, "names", None)
        if stack is None:
            stack = self._open.names = []
        return stack

    @contextlib.contextmanager
    def _span(self, name: str, args: dict):
        stack = self._stack()
        stack.append(name)
        tick = getattr(self._open, "tick", None) \
            if name.startswith("obs:") else None
        if tick is not None:
            depth = tick.depth
            tick.depth += 1
            opened = tick.take()
            self._mark(tick, opened)
        try:
            # a range only while a profiler records (a range costs about
            # 10 us even then); the clock reads inside it, so a span and
            # the range agree to the range's own cost
            with torch.profiler.record_function(name) \
                    if torch.autograd._profiler_enabled() else _NULL_CTX:
                t0 = time.perf_counter()
                try:
                    yield args
                finally:
                    t1 = time.perf_counter()
        finally:
            stack.pop()
            if tick is not None:
                tick.depth -= 1
                closed = tick.take()
                self._mark(tick, closed)
                tick.spans.append((name, depth, opened, closed))
        with self._lock:
            self._spans.append((name, t0, t1, threading.get_ident(), args))

    def span(self, name: str, **args):
        """Context manager: record ``name`` around the enclosed block
        (and mark it on a live ``torch.profiler`` capture); it yields
        the span's ``args``, which the block may add to (``None`` from a
        disabled tracer).  Inside a marked tick an ``obs:*`` span also
        marks the device."""
        if not self.enabled:
            return _NULL_CTX
        return self._span(name, args)

    def profile(self, logdir: str):
        """Capture the host and (on the card) CUDA activity while the
        context is open; the trace lands in ``logdir`` as a Chrome
        trace when it closes.  View it at https://ui.perfetto.dev."""
        if not self.enabled:
            return _NULL_CTX
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        os.makedirs(logdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts,
                       on_trace_ready=tensorboard_trace_handler(logdir))

    def open_stage(self) -> str | None:
        """The innermost ``obs:*`` span open on this thread, or None."""
        for name in reversed(self._stack()):
            if name.startswith("obs:"):
                return name
        return None

    def clear(self) -> None:
        """Forget the spans and the marked ticks (the ring's row count
        starts again; the layouts stay, as captured graphs name them)."""
        with self._lock:
            self._spans = []
        if self._ring is not None:
            self._ring[-1, 0] = 0

    # -- device marks ------------------------------------------------------
    def bind(self, device) -> None:
        """Make the mark ring on ``device`` (a compile-once step's; once)
        and, on the card, build and load the mark kernel.  A tracer
        without marks ignores it."""
        if not self.device_marks:
            return
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._ring is not None:
            if self._ring.device != device:
                raise ValueError(f"the tracer marks on {self._ring.device}, "
                                 f"not {device}")
            return
        if device.type == "cuda":
            from repro_torch.kernels.stage_mark import ops
            ops.load()
        self._ring = torch.zeros((RING_TICKS + 1, RING_WIDTH),
                                 dtype=torch.int64, device=device)
        self._probe = torch.zeros((2, 2), dtype=torch.int64, device=device)

    def _mark(self, tick: _TickLayout, slot: int, tag: int = 0) -> None:
        if tick.width is None:          # sizing: count, mark nothing
            return
        from repro_torch.kernels.stage_mark import stage_mark
        stage_mark(self._ring, slot, tag)

    @contextlib.contextmanager
    def _tick(self, width: int | None):
        if getattr(self._open, "tick", None) is not None:
            raise RuntimeError("a marked tick inside a marked tick")
        tick = self._open.tick = _TickLayout(width)
        try:
            yield tick
        finally:
            self._open.tick = None

    def sizing(self):
        """Context around a compile-once step's first, eager call: with
        marks, it counts the slots a tick of the step takes, marking
        nothing, and then fits the ring to them before the step is
        captured (:meth:`_fit`); else a pre-built null context."""
        if not self.device_marks:
            return _NULL_CTX
        return self._sizing()

    @contextlib.contextmanager
    def _sizing(self):
        with self._tick(None) as tick:
            tick.take()                 # the body's start (step.graph)
            yield
            tick.take()                 # its end
        self._fit(tick.next)

    def _fit(self, width: int) -> None:
        """A ring of at least ``width`` columns: while no captured tick
        writes the ring (no layout yet), a new one of the next power of
        two; after, a wider tick is refused here, before its capture."""
        if self._ring is None or width <= self._ring.shape[1]:
            return
        if self._layouts:
            raise RuntimeError(
                f"a tick takes {width - 1} mark slots, more than the "
                f"{self._ring.shape[1] - 1} of the ring that this tracer's "
                "captured ticks write: give this step a tracer of its own")
        self._ring = torch.zeros(
            (RING_TICKS + 1, 1 << (width - 1).bit_length()),
            dtype=torch.int64, device=self._ring.device)

    def tick_marks(self):
        """Context around a compile-once step's captured body: with
        marks, its start and end (``step.graph``) and every ``obs:*``
        span inside it mark the ring; else a pre-built null context."""
        if not self.device_marks:
            return _NULL_CTX
        return self._tick_marks()

    @contextlib.contextmanager
    def _tick_marks(self):
        if self._ring is None:
            raise RuntimeError("bind the tracer to the step's device first")
        with self._tick(self._ring.shape[1]) as tick:
            opened = tick.take()
            self._mark(tick, opened)
            yield
            closed = tick.take()
            layout = ((GRAPH_SPAN, -1, opened, closed),) + tuple(
                sorted(tick.spans, key=lambda sp: sp[2]))
            if layout not in self._layouts:
                self._layouts.append(layout)
            self._mark(tick, closed, self._layouts.index(layout) + 1)

    def _sync(self) -> None:
        if self._ring.is_cuda:
            torch.cuda.synchronize(self._ring.device)

    def calibrate(self, tries: int = 16) -> dict:
        """Map the device's mark clock onto ``perf_counter``: a mark
        launched between two host stamps, then a synchronize; of
        ``tries`` the narrowest bracket.  Returns (and keeps) ``offset_ns``
        (host ns = device ns + offset), ``error_ns`` (the bracket's
        half-width) and ``at_s`` (when, on ``perf_counter``)."""
        if self._ring is None:
            raise RuntimeError("bind the tracer to a device first")
        best = None
        for _ in range(tries):
            self._sync()
            a = time.perf_counter_ns()
            self._mark_probe()
            self._sync()
            b = time.perf_counter_ns()
            d = int(self._probe[0, 1])
            if best is None or b - a < best[1] - best[0]:
                best = (a, b, d)
        a, b, d = best
        cal = {"offset_ns": (a + b) // 2 - d, "error_ns": (b - a) / 2,
               "at_s": a * 1e-9}
        self.calibrations.append(cal)
        return cal

    def _mark_probe(self) -> None:
        from repro_torch.kernels.stage_mark import stage_mark
        stage_mark(self._probe, 1)

    def _marked(self) -> tuple[np.ndarray, np.ndarray]:
        """The ring's complete rows, oldest first, and each row's tag
        (one transfer)."""
        if self._ring is None:
            return np.zeros((0, 1), np.int64), np.zeros(0, np.int64)
        ring = self._ring.cpu().numpy()
        ticks = ring.shape[0] - 1
        count = int(ring[ticks, 0])
        n = min(count, ticks)
        rows = ring[np.arange(count - n, count) % ticks]
        return rows, rows[:, 0]

    def device_stages(self) -> dict:
        """The marked ticks still in the ring, oldest first (one
        transfer), in device ns:

        * ``ticks``: how many;
        * ``stages``: for each span name an int64 array a tick, the
          close minus the open summed over the span's openings in the
          tick (0 where a tick opened none);
        * ``graph``: ``[ticks, 2]``, the step body's start and end;
          ``host_graph`` the same in ``perf_counter`` seconds by the
          latest calibration (None before one);
        * ``openings``: one group a layout (a captured signature):
          ``ticks``, the group's indices, and ``spans``, each opening
          in open order as (name, depth, opens, closes), depth the
          ``obs:*`` spans around it."""
        rows, tags = self._marked()
        n = rows.shape[0]
        stages: dict[str, np.ndarray] = {}
        graph = np.zeros((n, 2), np.int64)
        openings = []
        for tag in np.unique(tags):
            sel = tags == tag
            group = []
            for name, depth, a, b in self._layouts[int(tag) - 1]:
                if name == GRAPH_SPAN:
                    graph[sel] = rows[sel][:, [a, b]]
                    continue
                acc = stages.setdefault(name, np.zeros(n, np.int64))
                acc[sel] += rows[sel, b] - rows[sel, a]
                group.append((name, depth, rows[sel, a], rows[sel, b]))
            openings.append({"ticks": np.flatnonzero(sel), "spans": group})
        host = None
        if self.calibrations:
            host = (graph + self.calibrations[-1]["offset_ns"]) * 1e-9
        return {"ticks": n, "stages": stages, "graph": graph,
                "host_graph": host, "openings": openings}

    # -- reading -----------------------------------------------------------
    @property
    def spans(self) -> list:
        """(name, t_start, t_end, thread_id, args) tuples, seconds on
        the ``perf_counter`` clock."""
        with self._lock:
            return list(self._spans)

    def profiler_ns(self, t: float) -> int:
        """``perf_counter`` seconds on ``torch.profiler``'s clock (Unix
        ns)."""
        return round(t * 1e9) + self.unix_offset_ns

    def stage_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Per-span-name duration percentiles (microseconds):
        ``{name: {count, mean_us, total_us, p50_us, p95_us, p99_us}}``
        -- the host-side per-stage latency breakdown."""
        by_name: dict[str, list[float]] = {}
        for name, t0, t1, _, _ in self.spans:
            by_name.setdefault(name, []).append((t1 - t0) * 1e6)
        out = {}
        for name, durs in sorted(by_name.items()):
            d = np.asarray(durs)
            stats = {"count": int(d.size),
                     "mean_us": float(d.mean()),
                     "total_us": float(d.sum())}
            for q in qs:
                stats[f"p{q}_us"] = float(np.percentile(d, q))
            out[name] = stats
        return out

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace JSON object: ``traceEvents`` complete events in
        microseconds after ``baseTimeNanoseconds`` on
        ``torch.profiler``'s clock, as a profiler capture's Chrome
        export gives them, so the two line up.  Host spans are process
        1, one track a thread; the marked ticks' stages (calibrated now
        if no calibration was made) are process 2, one track."""
        base = self.profiler_ns(self._t0)
        events = []
        for name, t0, t1, tid, args in self.spans:
            events.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": (self.profiler_ns(t0) - base) * 1e-3,
                "dur": (t1 - t0) * 1e6,
                "args": {k: _plain(v) for k, v in args.items()},
            })
        rows, tags = self._marked()
        if rows.shape[0]:
            cal = self.calibrations[-1] if self.calibrations \
                else self.calibrate()
            shift = cal["offset_ns"] + self.unix_offset_ns - base
            for row, tag in zip(rows, tags):
                for name, _, a, b in self._layouts[int(tag) - 1]:
                    events.append({
                        "name": name, "ph": "X", "pid": 2, "tid": 0,
                        "ts": (int(row[a]) + shift) * 1e-3,
                        "dur": (int(row[b]) - int(row[a])) * 1e-3,
                        "args": {}})
            events.append({"name": "process_name", "ph": "M", "pid": 2,
                           "args": {"name": "device stages (marks)"}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base}

    def export_chrome_trace(self, path: str) -> str:
        """Write :meth:`to_chrome_trace` to ``path``; returns ``path``.
        Open in ``chrome://tracing`` or https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


def _plain(v):
    """JSON-safe span arg (numpy scalars -> python scalars)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


#: Shared disabled tracer: the executors' default -- every hook on it is
#: a pre-built null context, so uninstrumented runs pay ~nothing.
NULL_TRACER = Tracer(enabled=False)
