"""The result line: every metric a cell lists is in its line (end to
end without ``--trace``, per layer with it), the keys the contract
names are there and ``checks`` comes last; across ranks the ranks'
runs merge into one.  The trace's numbers here are made up (the
profiler's, the eager stages' and the program's marks and host spans):
what is tested is the harness's arithmetic, not a device."""
from __future__ import annotations

import json

import pytest

from perfbench.conftest import bench_with_set_aside, cell, run_small
from perfbench.pb import cli, ranks
from perfbench.pb import yardstick

CELLS = [w["name"] for w in bench_with_set_aside()["workloads"]]


#: what the readers of ``_program``'s record read from it
PROGRAM = {"edge_stages_graphed_ms": 0.5, "exchange_graphed_ms": 1.25,
           "launch_wait_ms": 0.25, "step_launch_host_ms": 0.3,
           "step_prepare_host_ms": 0.7}


def _program(n: int = 4) -> dict:
    """A ``progtrace.stretch`` record of ``n`` ticks: device marks in ns,
    host spans in s."""
    return dict(
        openings=[{"ticks": list(range(n)), "spans": [
            ("obs:fleet_watermark", 0, [0] * n, [50_000] * n),
            ("obs:ingest", 0, [60_000] * n, [560_000] * n),
            ("obs:window", 1, [70_000] * n, [90_000] * n),
            ("obs:exchange_core", 0, [600_000] * n, [1_600_000] * n)]}],
        stages={"obs:fleet_watermark": [50_000] * n,
                "obs:exchange_core": [1_000_000] * n,
                "obs:core_commit": [200_000] * n},
        host={"fleet.prepare": [1e-4] * n, "step.copy_in": [2e-4] * n,
              "step.launch": [3e-4] * n, "step.copy_out": [4e-4] * n},
        host_start={"step.launch": [float(t) for t in range(n)]},
        graph_host_s=[[t + 2.5e-4, t + 3e-3] for t in range(n)])


def _traced(run: dict, cell: dict, busy: float = 0.06) -> dict:
    bound = yardstick.fused_tick_bound_s(cell["config"])
    run.update(
        graphed=dict(window_s=0.1, busy_s=busy, ops=16 * 400,
                     kernels={"fused_tick_kernel_span": [bound * 4] * 16,
                              "reduce_kernel": [1e-5] * 32},
                     device_ops=[("reduce_kernel", 3.2e-4)],
                     idle_gaps=[("cudaGraphLaunch", 0.03)]),
        traced_ticks=16, eager_ticks=2,
        stages={"obs:admission": 1e-3, "obs:pipeline": 6e-4,
                "obs:fleet_watermark": 1e-4, "obs:exchange_core": 2e-3,
                "obs:core_commit": 4e-4},
        program=_program(), kind="test", foreign=[])
    return run


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_line_has_every_listed_metric(name, trace):
    c = cell(name)
    run = run_small(cell(name), seconds=0.2)
    if c["chips"] > 1:
        run = ranks.merge([_traced(dict(run), c, b)
                           for b in (0.05, 0.06, 0.07, 0.08)], trace,
                          c["system"].merge_numbers)
    else:
        run = _traced(run, c)
    line = cli.result(c, run, trace, run["kind"])
    want = [m["name"] for m in (c["per_layer"] if trace
                                else c["end_to_end"])]
    assert sorted(line["metrics"]) == sorted(want)
    assert list(line)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert line["correct"] is True
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == c["chips"]
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        got = {k: v["value"] for k, v in line["metrics"].items()}
        if "fused_tick_roofline" in got:
            assert got["fused_tick_roofline"] == pytest.approx(25.0)
        for k, v in PROGRAM.items():
            if k in got:
                assert got[k] == pytest.approx(v), k
        idle = line["metrics"]["device_idle_share"]["value"]
        assert 0 <= idle <= 100
    json.dumps(line)
