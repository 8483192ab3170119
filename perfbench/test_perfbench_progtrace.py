"""The program's own traced stretch (``pb/progtrace.py``) on the CPU: a
run of the fleet cell with the stretch after its window reads `correct`
(the reference checks the stretch's ticks too), and each of its five
readers finds a number to read.  The CPU's numbers are the plain mark's
(``time.perf_counter_ns``): what is tested is the bookkeeping, not a
device."""
from __future__ import annotations

import time

import numpy as np
import pytest

from perfbench.conftest import ROOT, SEED, cell, shrink
from perfbench.pb import cli, devtrace, progtrace, runner, spec

METRICS = ("edge_stages_graphed_ms", "exchange_graphed_ms",
           "step_launch_host_ms", "step_prepare_host_ms", "launch_wait_ms")


def _run(monkeypatch, ticks: int = 5) -> tuple[dict, dict]:
    c = shrink(cell("fleet_8x2.hotcold"))
    monkeypatch.setattr(progtrace, "TICKS", ticks)
    monkeypatch.setattr(runner, "traced", lambda tk, cfg, device, scratch: {
        "program": progtrace.stretch(tk)})
    run = runner.measure(c, SEED, 0.2, True, "cpu", time.perf_counter())
    return c, run


def test_stretch_is_checked_and_every_reader_reads(monkeypatch):
    c, run = _run(monkeypatch)
    correct, _ = cli.verdict(run["numbers"], c["config"]["limits"])
    assert correct
    prog = run["program"]
    assert prog["ticks"] == progtrace.TICKS
    assert prog["calibration"][0]["error_ns"] >= 0
    # one host span of each kind a tick, the step's inside the dispatch
    for name in ("fleet.prepare", "fleet.dispatch", "step.copy_in",
                 "step.launch", "step.copy_out"):
        assert len(prog["host"][name]) == progtrace.TICKS, name
    inner = progtrace.per_tick(run, ("step.copy_in", "step.launch",
                                     "step.copy_out"))
    assert np.all(inner <= np.asarray(prog["host"]["fleet.dispatch"]))
    # the operands the feed hands in new each tick are copied in
    assert min(prog["copy_in"]["bytes"]) > 0
    here = ROOT / "perfbench"
    got = {m: spec._module(here, "metrics", m).read(run, c) for m in METRICS}
    assert all(v is not None for v in got.values()), got
    assert all(v > 0 for k, v in got.items() if k != "launch_wait_ms"), got
    assert got["edge_stages_graphed_ms"] < float(
        np.median(np.asarray(prog["graph"])[:, 1]
                  - np.asarray(prog["graph"])[:, 0])) * 1e-6


@pytest.mark.parametrize("name", METRICS)
def test_reader_reads_nothing_without_the_stretch(name):
    """A run whose program cannot mark (the key absent or None) gives
    no reading and raises nothing."""
    c = cell("fleet_8x2.hotcold")
    reader = spec._module(ROOT / "perfbench", "metrics", name)
    assert reader.read({}, c) is None
    assert reader.read({"program": None}, c) is None


def test_traced_runs_the_systems_stretches_in_order(monkeypatch):
    """``runner.traced`` runs the runner's profiled graphed ticks, then
    the fleet's stretches in order (eager stages, the program's marks),
    each merged into the run, and the ``--trace 1`` line reads every
    listed metric that the stand-in profile feeds.  The profiler is
    stood in for: the CPU has no device trace."""
    captured = []

    def capture(fn, scratch):
        captured.append(fn.__name__)
        fn()
        return []
    monkeypatch.setattr(devtrace, "prime", lambda device: None)
    monkeypatch.setattr(devtrace, "capture", capture)
    monkeypatch.setattr(devtrace, "window", lambda events: dict(
        window_s=0.1, busy_s=0.05, ops=32, kernels={}, device_ops=[],
        idle_gaps=[]))
    monkeypatch.setattr(devtrace, "stages",
                        lambda events: {"obs:exchange_core": 1e-3})
    monkeypatch.setattr(progtrace, "TICKS", 5)
    c = shrink(cell("fleet_8x2.hotcold"))
    run = runner.measure(c, SEED, 0.2, True, "cpu", time.perf_counter())
    assert captured == ["graphed", "eager"]
    assert run["program"]["ticks"] == progtrace.TICKS
    assert run["ticks"] == run["window_ticks"] + c["config"]["warmup_ticks"] \
        + c["config"]["trace_ticks"] + c["config"]["eager_ticks"] \
        + 1 + progtrace.TICKS
    line = cli.result(c, run, True, "cpu")
    assert line["correct"] is True
    want = {m["name"] for m in c["per_layer"]} - {"fused_tick_roofline"}
    assert set(line["metrics"]) == want
