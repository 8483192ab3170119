"""The result line: every metric a cell lists is in its line (end to
end without ``--trace``, per layer with it), the keys the contract
names are there and ``checks`` comes last; across ranks the ranks'
runs merge into one.  The trace's numbers here are made up (the
profiler's here, the rest from the cell's system's ``sample_trace``),
and no system is named: what is tested is the harness's arithmetic, not
a device."""
from __future__ import annotations

import json

import pytest

from perfbench.conftest import bench_with_set_aside, cell, run_small
from perfbench.pb import cli, ranks

CELLS = [w["name"] for w in bench_with_set_aside()["workloads"]]


#: the runner's own traced stretch, as it reads for any system: its
#: graphed ticks' window, busy time, ops, a kernel, device ops and gaps
GRAPHED = dict(window_s=0.1, ops=16 * 400,
               kernels={"reduce_kernel": [1e-5] * 32},
               device_ops=[("reduce_kernel", 3.2e-4)],
               idle_gaps=[("cudaGraphLaunch", 0.03)])


def _traced(run: dict, cell: dict, busy: float = 0.06) -> dict:
    """``run`` with a made-up trace: the runner's graphed stretch, then
    what the cell's system's ``sample_trace`` says its stretches add;
    its kernels join the runner's, nothing else is overwritten."""
    record, _ = cell["system"].sample_trace(cell["config"])
    record = dict(record)
    own = record.pop("graphed", {})
    assert set(own) <= {"kernels"}, own
    kernels = dict(GRAPHED["kernels"])
    assert not set(own.get("kernels", {})) & set(kernels)
    kernels.update(own.get("kernels", {}))
    run.update(graphed=dict(GRAPHED, busy_s=busy, kernels=kernels),
               traced_ticks=16, kind="test", foreign=[])
    assert not set(record) & set(run), set(record) & set(run)
    run.update(record)
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
        _, expected = c["system"].sample_trace(c["config"])
        for k, v in expected.items():
            if k in got:
                assert got[k] == pytest.approx(v), k
        idle = line["metrics"]["device_idle_share"]["value"]
        assert 0 <= idle <= 100
    json.dumps(line)
