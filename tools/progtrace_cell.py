#!/usr/bin/env python3
"""A one-card benchmark cell's ``--trace 1`` run with the program's own
traced stretch (``perfbench/pb/progtrace.py``) after the harness's two,
on one CUDA card.

    python3 tools/progtrace_cell.py --workload fleet_8x2.hotcold \
        --seed <n> --seconds <s> [--out build/progtrace]

It prints the run's result line, as ``perfbench/run.py --trace 1``
prints it, with the five readings of the program's spans added
(``edge_stages_graphed_ms``, ``exchange_graphed_ms``,
``step_launch_host_ms``, ``step_prepare_host_ms``, ``launch_wait_ms``),
then one JSON line, ``{"program": ...}``, of what the stretch read
beside the window: rows/s and the tick's p99 with marks on (the
stretch) and off (the window); device ops a tick and the idle share
with marks on (a profiled stretch of the cell's ``trace_ticks``, the
harness's way) and off (the harness's own); marks a tick; both
calibrations and the device timer's step; the medians of the host
spans beside the step call's; the ratio of ``exchange_graphed_ms`` to
``fleet_exchange_device_ms``; each stage's median.  The stretch's whole
record goes to ``<out>/<workload>_<seed>.json``.  Without a card it
exits 2.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: the readers of the program's spans, and their units
METRICS = (("edge_stages_graphed_ms", "ms/tick"),
           ("exchange_graphed_ms", "ms/tick"),
           ("step_launch_host_ms", "ms"), ("step_prepare_host_ms", "ms"),
           ("launch_wait_ms", "ms"))


def summary(cell: dict, run: dict, marked: dict, line: dict) -> dict:
    import numpy as np
    cfg, prog = cell["config"], run["program"]
    rows = cfg["micro_batch"] * cfg.get("num_regions", 1) \
        * cfg.get("edges_per_region", 1)
    tick_s = np.asarray(prog["tick_s"])
    host = {k: np.asarray(v) for k, v in prog["host"].items()}
    split = ("fleet.prepare", "step.copy_in", "step.launch", "step.copy_out")
    per_tick = sum(host[k] for k in split)
    graph = np.asarray(prog["graph"])
    wait = np.asarray(prog["graph_host_s"])[:, 0] \
        - np.asarray(prog["host_start"]["step.launch"])
    g, n = run["graphed"], cfg["trace_ticks"]
    m = line["metrics"]
    return {
        "window_rows_per_s": run["rows"] / run["window_s"],
        "window_tick_p99_ms": float(np.percentile(run["tick_s"], 99)) * 1e3,
        "marked_rows_per_s": rows * tick_s.size / float(tick_s.sum()),
        "marked_tick_p99_ms": float(np.percentile(tick_s, 99)) * 1e3,
        "ops_per_tick": g["ops"] / n,
        "marked_ops_per_tick": marked["ops"] / n,
        "idle_share": 100.0 * (1 - g["busy_s"] / g["window_s"]),
        "marked_idle_share": 100.0 * (1 - marked["busy_s"]
                                      / marked["window_s"]),
        "marks_per_tick": prog["marks_per_tick"],
        "calibration": prog["calibration"],
        "timer_step_ns": prog["timer_step_ns"],
        "timer_min_step_ns": prog["timer_min_step_ns"],
        "host_median_ms": {k: float(np.median(v)) * 1e3
                           for k, v in host.items()},
        "split_median_ms": float(np.median(per_tick)) * 1e3,
        "step_call_median_ms": float(np.median(prog["step_s"])) * 1e3,
        "split_over_step_call": float(np.median(per_tick)
                                      / np.median(prog["step_s"])),
        "graph_body_median_ms": float(np.median(graph[:, 1] - graph[:, 0]))
        * 1e-6,
        "launch_wait_ms_p50_p99": [float(np.percentile(wait, q)) * 1e3
                                   for q in (50, 99)],
        "copy_in_median": {k: float(np.median(v))
                           for k, v in prog["copy_in"].items()},
        "exchange_graphed_over_eager": m["exchange_graphed_ms"]["value"]
        / m["fleet_exchange_device_ms"]["value"]
        if "exchange_graphed_ms" in m and "fleet_exchange_device_ms" in m
        else None,
        "stage_median_ms": {k: float(np.median(v)) * 1e-6
                            for k, v in prog["stages"].items()},
        "eager_stage_ms": {k: v / run["eager_ticks"] * 1e3
                           for k, v in run["stages"].items()},
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="tools/progtrace_cell.py")
    ap.add_argument("--workload", default="fleet_8x2.hotcold")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "progtrace"))
    args = ap.parse_args(argv)
    import torch

    from perfbench.pb import cli, devtrace, progtrace, runner, spec
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    cell = spec.cell(ROOT, args.workload)
    if not torch.cuda.is_available() or cell["chips"] != 1:
        print("needs one CUDA card and a one-card cell", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    harness_traced, marked = runner.traced, {}

    def traced(tk, cfg, device, scratch):
        out = harness_traced(tk, cfg, device, scratch)
        tracer = Tracer(device_marks=True)
        out["program"] = progtrace.stretch(tk, tracer)
        tk.system.set_tracer(tracer)       # its graph, captured above

        def graphed():
            with torch.profiler.record_function(devtrace.WINDOW_RANGE):
                for _ in range(cfg["trace_ticks"]):
                    tk.tick()
                tk.sync()
        marked.update(devtrace.window(devtrace.capture(graphed, scratch)))
        tk.system.set_tracer(NULL_TRACER)
        return out
    runner.traced = traced
    run = runner.measure(cell, args.seed, args.seconds, True, "cuda:0",
                         T_START, scratch=ROOT / "build" / "perfbench")
    kind = torch.cuda.get_device_name(0)
    line = cli.result(cell, run, True, kind)
    here = ROOT / "perfbench"
    for name, unit in METRICS:
        v = spec._module(here, "metrics", name).read(run, cell)
        if v is not None:
            line["metrics"][name] = {"value": v, "unit": unit}
    print(json.dumps(line))
    print(json.dumps({"program": summary(cell, run, marked, line)}))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}_{args.seed}.json").write_text(
        json.dumps(run["program"]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
