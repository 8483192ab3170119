"""Metrics registry + BENCH artifact exporter (stable schema).

Port of ``repro.obs.export``, with the reference's golden keys:

* :func:`metrics_snapshot` -- one executor's full observability state:
  ``StreamMetrics``/``FleetMetrics`` counters, the in-step latency
  histogram's percentiles, the lineage percentiles, the tracer's
  per-stage breakdown, and the trace count, in one dict.
  ``"trace_count"`` is the executor's own: the tick signatures its
  compile-once step built (``runtime.capture``), an int, 1 after
  warmup on a fixed feed as in the reference.
* :func:`bench_payload` / :func:`write_bench` -- the
  ``BENCH_<suite>.json`` artifact: a suite's CSV rows (``derived``
  parsed into a dict) plus platform provenance, written atomically
  (``BENCH_<suite>.tmp`` then rename).  The platform block names
  PyTorch and the CUDA card in place of JAX's backend.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

BENCH_SCHEMA_VERSION = 1

#: Golden top-level keys of a BENCH artifact (tests pin this).
BENCH_KEYS = ("schema_version", "suite", "created_unix", "platform", "rows")

#: Golden top-level keys of a metrics snapshot (tests pin this).
SNAPSHOT_KEYS = ("schema_version", "kind", "metrics", "latency", "lineage",
                 "stages", "trace_count")


def parse_derived(derived: str) -> dict:
    """Parse a CSV row's ``derived`` column (``k=v;k=v`` pairs, ints
    and floats coerced; bare tokens map to ``True``)."""
    out: dict = {}
    for part in filter(None, (derived or "").split(";")):
        if "=" not in part:
            out[part] = True
            continue
        k, v = part.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = v
    return out


def _platform(device=None) -> dict:
    """Where the numbers were taken: ``backend`` is the device type the
    run's tensors live on (``device``; the card when there is one),
    ``device_count`` the CUDA cards, and the PyTorch and Python
    versions."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return {
        "backend": torch.device(device).type,
        "device_count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "python": sys.version.split()[0],
    }


def bench_payload(suite: str, rows: list[dict], device=None) -> dict:
    """BENCH artifact dict for one suite.  ``rows`` are the harness's
    collected ``{"name", "us_per_call", "derived"}`` records;
    ``derived`` strings are parsed.  ``device``: where the rows were
    measured (default: the card when there is one)."""
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "suite": suite,
        "created_unix": time.time(),
        "platform": _platform(device),
        "rows": [{"name": r["name"],
                  "us_per_call": float(r["us_per_call"]),
                  "derived": parse_derived(r["derived"])
                  if isinstance(r["derived"], str) else dict(r["derived"])}
                 for r in rows],
    }


def write_bench(payload: dict, directory: str = ".") -> str:
    """Write ``BENCH_<suite>.json`` atomically; returns the path."""
    path = os.path.join(directory, f"BENCH_{payload['suite']}.json")
    tmp = os.path.join(directory, f"BENCH_{payload['suite']}.tmp")
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return path


def metrics_snapshot(executor, state, kind: str | None = None) -> dict:
    """One executor's observability state as a stable-schema dict.

    ``executor`` is a ``StreamExecutor`` or ``FleetExecutor`` (anything
    with ``trace_count``, ``latency_percentiles()``,
    ``lineage_percentiles()`` and a ``tracer``); ``state`` the matching state whose ``metrics.as_dict()``
    is the counter snapshot.  ``kind`` defaults to the executor class
    name.  ``trace_count`` is the executor's own (an int)."""
    tracer = getattr(executor, "tracer", None)
    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "kind": kind or type(executor).__name__,
        "metrics": state.metrics.as_dict(),
        "latency": executor.latency_percentiles(),
        "lineage": executor.lineage_percentiles(),
        "stages": tracer.stage_percentiles()
        if tracer is not None and tracer.enabled else {},
        "trace_count": int(executor.trace_count),
    }
