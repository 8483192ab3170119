"""``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of a cell of ``BENCHMARK.json``.

It needs the cell's cards (``torch.cuda``): without them it exits 2 and
prints no result.  It prints the compared numbers beside their limits
as its last lines on standard error, and as its last line on standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.  A run that finds JAX or the JAX package loaded exits 3
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from perfbench.pb import spec as S
from perfbench.pb.ranks import foreign_modules


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """Each compared number beside its limit; ``correct`` when every
    number keeps its limit (``ticks_checked`` is a floor)."""
    rows, ok = [], True
    for k, v in numbers.items():
        lim = limits[k]
        good = v >= lim if k == "ticks_checked" else v <= lim
        ok &= bool(good)
        rows.append((k, v, lim))
    return ok, rows


def result(cell: dict, run: dict, trace: bool, kind: str) -> dict:
    """The run's result line (with ``checks`` last)."""
    correct, rows = verdict(run["numbers"], cell["config"]["limits"])
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = cell["readers"][m["name"]].read(run, cell)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": int(run["peak_bytes"])}
    out = {"correct": correct, "attempted": run["window_ticks"],
           "failed": 0 if correct else run["numbers"]["ticks_checked"],
           "metrics": metrics, "device": device}
    if trace:
        g = run["graphed"]
        device["busy_s"], device["window_s"] = run.get(
            "traced_s", (g["busy_s"], g["window_s"]))
        out["breakdown"] = {"device_ops": [list(x) for x in g["device_ops"]],
                            "idle_gaps": [list(x) for x in g["idle_gaps"]]}
    out["run"] = {k: run[k] for k in (
        "window_ticks", "ticks", "window_s", "harness_ms_per_tick",
        "check_s", "setup_parts", "counter_diffs")}
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out


def main(argv, root: Path, t_start: float) -> int:
    args = parse(argv)
    cell = S.cell(root, args.workload)
    import repro_torch  # noqa: F401  (the program: a checkout without it fails here)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    scratch = root / "build" / "perfbench"
    if cell["chips"] == 1:
        from perfbench.pb import runner
        # one process a card, one intra-op thread: the host's side of a
        # tick is what varies from run to run
        torch.set_num_threads(1)
        run = runner.measure(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda:0", t_start, scratch=scratch)
        run["foreign"] = foreign_modules()
        run["kind"] = torch.cuda.get_device_name(0)
    else:
        from perfbench.pb import ranks
        run = ranks.measure(root, args.workload, cell["chips"], args.seed,
                            args.seconds, bool(args.trace), t_start)
    bad = sorted(set(run["foreign"]) | set(foreign_modules()))
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    line = result(cell, run, bool(args.trace), run["kind"])
    for k, (got, want) in run["counter_diffs"].items():
        print(f"counter {k}: program {got}, reference {want}",
              file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
