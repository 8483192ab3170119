"""Device milliseconds a graphed fleet tick in the per-shard loop: the
sum over the shards of their top-level stage spans (``obs:ingest``,
``obs:watermark``, ``obs:fused_tick`` or ``obs:window``, ``obs:rules``,
``obs:lineage``, ``obs:edge_stages``: every span of depth 0 that opens
after ``obs:fleet_watermark`` closes and closes before
``obs:exchange_core`` opens), the median over the program's traced
ticks (``pb/progtrace.py``).  Wall time between marks: the graph's gaps
inside each span count, the ops between two spans do not."""
import numpy as np


def read(run: dict, cell: dict):
    prog = run.get("program")
    if not prog:
        return None
    per_tick = []
    for group in prog["openings"]:
        spans = group["spans"]
        ends = {n: (np.asarray(a), np.asarray(b)) for n, d, a, b in spans
                if d == 0 and n in ("obs:fleet_watermark",
                                    "obs:exchange_core")}
        if len(ends) != 2:
            continue
        lo, hi = ends["obs:fleet_watermark"][1], ends["obs:exchange_core"][0]
        total = np.zeros(len(group["ticks"]), np.int64)
        for n, d, a, b in spans:
            a, b = np.asarray(a), np.asarray(b)
            if d == 0 and np.all(a >= lo) and np.all(b <= hi):
                total += b - a
        per_tick.append(total)
    if not per_tick:
        return None
    return float(np.median(np.concatenate(per_tick))) * 1e-6
