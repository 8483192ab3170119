"""Metrics registry (stable schema).

Port of ``repro.obs.export``'s snapshot, with the reference's golden
keys: :func:`metrics_snapshot` -- one executor's full observability
state: ``StreamMetrics``/``FleetMetrics`` counters, the in-step latency
histogram's percentiles, the lineage percentiles, the tracer's
per-stage breakdown, and the trace count, in one dict.
``"trace_count"`` is the executor's own: the tick signatures its
compile-once step built (``runtime.capture``), an int, 1 after warmup
on a fixed feed as in the reference.  The reference's
``BENCH_<suite>.json`` writer is not ported: the port's benchmark
(``perfbench/``) prints its own result line.
"""
from __future__ import annotations

SCHEMA_VERSION = 1

#: Golden top-level keys of a metrics snapshot (tests pin this).
SNAPSHOT_KEYS = ("schema_version", "kind", "metrics", "latency", "lineage",
                 "stages", "trace_count")


def metrics_snapshot(executor, state, kind: str | None = None) -> dict:
    """One executor's observability state as a stable-schema dict.

    ``executor`` is a ``StreamExecutor`` or ``FleetExecutor`` (anything
    with ``trace_count``, ``latency_percentiles()``,
    ``lineage_percentiles()`` and a ``tracer``); ``state`` the matching state whose ``metrics.as_dict()``
    is the counter snapshot.  ``kind`` defaults to the executor class
    name.  ``trace_count`` is the executor's own (an int)."""
    tracer = getattr(executor, "tracer", None)
    return {
        "schema_version": SCHEMA_VERSION,
        "kind": kind or type(executor).__name__,
        "metrics": state.metrics.as_dict(),
        "latency": executor.latency_percentiles(),
        "lineage": executor.lineage_percentiles(),
        "stages": tracer.stage_percentiles()
        if tracer is not None and tracer.enabled else {},
        "trace_count": int(executor.trace_count),
    }
