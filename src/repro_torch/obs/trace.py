"""Host-side span tracer with ``torch.profiler`` hooks and Chrome-trace
export.

Port of ``repro.obs.trace``.  ``Tracer`` records lightweight wall-clock
spans around the host phases of a stream tick (inject -> dispatch ->
device execute -> control -> drain).  Each span doubles as a
``torch.profiler.record_function`` range (where the reference used a
JAX ``TraceAnnotation``), so when a capture is live (``with
tracer.profile(logdir)``) the same spans appear on the host timeline
beside the device ops; the executors' stage spans (``obs:ingest``,
``obs:window``, ...) take the place of the reference's
``jax.named_scope`` labels (:data:`DEVICE_STAGES`).

Two export paths:

* :meth:`Tracer.export_chrome_trace` -- self-contained Chrome trace
  JSON (open in ``chrome://tracing`` or https://ui.perfetto.dev) from
  the host spans alone;
* :meth:`Tracer.profile` -- a ``torch.profiler.profile`` capture of the
  host and, on the card, the CUDA activity, written to ``logdir`` as a
  Chrome trace when the context closes.

A span is recorded when its Python runs.  The executors' ticks replay
a captured CUDA graph on the card (``runtime.capture``), so their stage
spans are recorded at the warm-up and the capture, while
``stream.dispatch`` and ``fleet.dispatch`` mark every tick.

The spans open at a moment are kept too (:meth:`Tracer.open_stage`):
``obs.costmodel.analyze`` attributes each operation to the innermost
open ``obs:*`` span.

Overhead discipline: a disabled tracer (``NULL_TRACER``, the executors'
default) costs one attribute lookup and a pre-built null context per
span -- safe to leave in the hot path; an enabled tracer costs a
``record_function`` range, two clock reads and one list append per
span.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

_NULL_CTX = contextlib.nullcontext()

#: The stage labels of the tick, in hot-path order (single-device
#: prefix, then the fleet-only stages): the reference's
#: ``jax.named_scope`` taxonomy.  ``obs.costmodel`` attributes
#: operations to the innermost open one.
DEVICE_STAGES = (
    "obs:ingest", "obs:watermark", "obs:window", "obs:lineage",
    "obs:rules", "obs:pipeline", "obs:metrics",
    "obs:fleet_watermark", "obs:edge_stages", "obs:exchange_core",
    "obs:all_to_all_out", "obs:fog_compact", "obs:all_to_all_region",
    "obs:core_compute", "obs:all_to_all_back", "obs:core_commit",
    "obs:latency",
)


class Tracer:
    """Accumulates named host spans; thread-safe appends.

    Spans nest naturally in Chrome trace rendering (same thread id,
    containing timestamps).  ``args`` ride along into the trace
    viewer's detail pane.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._spans: list[tuple[str, float, float, int, dict]] = []
        self._lock = threading.Lock()
        self._open = threading.local()
        self._t0 = time.perf_counter()

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
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield self
        finally:
            t1 = time.perf_counter()
            stack.pop()
            with self._lock:
                self._spans.append((name, t0, t1,
                                    threading.get_ident(), args))

    def span(self, name: str, **args):
        """Context manager: record ``name`` around the enclosed block
        (and mark it on a live ``torch.profiler`` capture)."""
        if not self.enabled:
            return _NULL_CTX
        return self._span(name, args)

    def step_annotation(self, name: str, step_num: int):
        """A range marking one tick (``name#step_num``) on a live
        capture's timeline, where the reference used
        ``jax.profiler.StepTraceAnnotation``; not a recorded span."""
        if not self.enabled:
            return _NULL_CTX
        return torch.profiler.record_function(f"{name}#{step_num}")

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
        with self._lock:
            self._spans = []

    # -- reading -----------------------------------------------------------
    @property
    def spans(self) -> list:
        """(name, t_start, t_end, thread_id, args) tuples, seconds on
        the ``perf_counter`` clock."""
        with self._lock:
            return list(self._spans)

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
        """Chrome trace JSON object (``traceEvents`` complete events,
        microsecond timestamps relative to tracer creation)."""
        events = []
        for name, t0, t1, tid, args in self.spans:
            events.append({
                "name": name, "ph": "X", "pid": 1, "tid": tid,
                "ts": (t0 - self._t0) * 1e6,
                "dur": (t1 - t0) * 1e6,
                "args": {k: _plain(v) for k, v in args.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

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
