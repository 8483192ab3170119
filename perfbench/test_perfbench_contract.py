"""A system that is not a stream runs through the harness as it stands:
a toy system, its configuration, traffic and plain reference are files
of a benchmark of its own, found by name (``spec.cell``), run on the CPU
(``runner.measure``) and judged (``cli.result``) with no harness file
edited.  A sound run reads ``correct`` true, one whose step is off by
one reads false.  Dropped into a copy of this benchmark with a traced
stretch and a per-layer reader of its own, its cell passes every test
that runs over each cell or each system module.  And the harness's own
modules name no stream concept."""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

from perfbench.conftest import ROOT, SEED
from perfbench.pb import cli, spec

#: the toy: each step adds a tick's seeded integer vector and a seeded
#: offset into an int64 accumulator on the device; the plain reference
#: sums the same feed, made again from the seed, on the host; its traced
#: stretch times a few more ticks on the host
TOY = '''
import time

import numpy as np
import torch


def params(cfg, seed):
    return np.random.default_rng(seed).integers(0, 7, cfg["width"])


class Feed:
    def __init__(self, traffic, cfg, shards, seed, device):
        gen = torch.Generator(device).manual_seed(seed)
        self.pool = torch.randint(0, traffic["high"],
                                  (traffic["pool_ticks"], cfg["width"]),
                                  generator=gen, device=device)
        self.items_per_tick = cfg["width"]

    def tick(self, t):
        return (self.pool[t % self.pool.shape[0]],)


feed = Feed


class Toy:
    shards = 1

    def __init__(self, cfg, params, device):
        self.offset = torch.as_tensor(params, device=device)
        self.acc = torch.zeros(cfg["width"], dtype=torch.int64,
                               device=device)
        self.steps = 0

    def step(self, x):
        self.acc += x + self.offset
        self.steps += 1
        return self.acc

    def counters(self):
        return {"steps": self.steps}

    def outputs(self, out):
        return out.cpu().clone()

    def close(self):
        self.acc = self.offset = None


def build(cfg, params, device, ranks=None):
    return Toy(cfg, params, device)


def check(cfg, params, traffic, seed, device, ticks, final, n_ticks,
          shards):
    pool = Feed(traffic, cfg, shards, seed, "cpu").pool.numpy()
    acc = np.zeros(cfg["width"], np.int64)
    bad = 0
    for t in range(n_ticks):
        acc += pool[t % len(pool)] + params
        if t in ticks:
            bad += int((ticks[t]["out"].numpy() != acc).sum())
            bad += ticks[t]["after"]["steps"] != t + 1
    diffs = {} if final["steps"] == n_ticks else \\
        {"steps": [final["steps"], n_ticks]}
    return (dict(mismatches=bad + len(diffs), ticks_checked=len(ticks)),
            diffs)


def merge_numbers(nums):
    return dict(mismatches=sum(x["mismatches"] for x in nums),
                ticks_checked=min(x["ticks_checked"] for x in nums))


def timed_ticks(tk, cfg, device, scratch):
    a = time.perf_counter()
    for _ in range(cfg["trace_ticks"]):
        tk.tick()
    tk.sync()
    return {"toy": {"ticks": cfg["trace_ticks"],
                    "seconds": time.perf_counter() - a}}


stretches = [timed_ticks]


def sample_trace(cfg):
    return {"toy": {"ticks": 4, "seconds": 2e-3}}, {"toy_tick_ms": 0.5}


def small(cfg, traffic):
    return dict(cfg, width=1024), traffic
'''

#: the toy's own per-layer reader: host milliseconds a tick of its
#: stretch
TOY_READER = '''
def read(run, cell):
    t = run.get("toy")
    return None if not t else t["seconds"] / t["ticks"] * 1e3
'''

CONFIG = {"system": "toy", "source": "a test", "width": 1 << 16,
          "reduced": [], "assumed": {}, "guarantees": ["sums are exact"],
          "warmup_ticks": 2, "trace_ticks": 4, "check_one_in": 3,
          "limits": {"mismatches": 0, "ticks_checked": 1}}
TRAFFIC = {"pool_ticks": 5, "high": 1000}
E2E = ("items_per_s", "peak_mem_gib", "setup_s")
LAYERS = ("device_idle_share", "device_ops_per_tick")


@pytest.fixture
def toy(tmp_path):
    """A benchmark of the toy system alone, under ``tmp_path``; its cell
    at a test's size."""
    here = tmp_path / "toybench"
    for d in ("systems", "configs", "traffic", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "systems/toy.py").write_text(TOY)
    (here / "configs/toy.json").write_text(json.dumps(CONFIG))
    (here / "traffic/ints.json").write_text(json.dumps(TRAFFIC))
    for m in E2E + LAYERS:
        shutil.copy(ROOT / f"perfbench/metrics/{m}.py",
                    here / f"metrics/{m}.py")
    bench = {
        "command": ["python3", "toybench/run.py"], "paths": ["toybench"],
        "run_seconds": 10,
        "configs": [{"name": "toy", "source": "a test",
                     "file": "toybench/configs/toy.json", "reduced": [],
                     "why": "a test"}],
        "workloads": [{"name": "toy.ints", "config": "toy",
                       "traffic": "ints", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": m, "unit": "u", "better": "lower",
                        "bound": 0.25, "source": "host_clock"} for m in E2E],
        "per_layer": [{"name": m, "unit": "u", "better": "lower",
                       "source": "device_trace", "layer": "device",
                       "moves": "items_per_s"} for m in LAYERS]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell(tmp_path, "toy.ints")
    c["config"], c["traffic"] = c["system"].small(c["config"], c["traffic"])
    return c


def _run(c: dict, patch=None) -> dict:
    from perfbench.pb import runner
    return runner.measure(c, SEED, 0.3, False, "cpu", time.perf_counter(),
                          patch=patch)


def _off_by_one(c: dict):
    """The toy's step adds each element one place too far along."""
    toy_cls = c["system"].Toy

    @contextlib.contextmanager
    def patch():
        orig = toy_cls.step

        def step(self, x):
            self.acc[1:] += (x + self.offset)[:-1]
            self.steps += 1
            return self.acc
        toy_cls.step = step
        try:
            yield
        finally:
            toy_cls.step = orig
    return patch


def test_toy_system_sound_run_reads_correct(toy):
    run = _run(toy)
    line = cli.result(toy, run, False, "test")
    assert line["correct"] is True, line["checks"]
    assert sorted(line["metrics"]) == sorted(E2E)
    width = toy["config"]["width"]
    assert run["rows"] == run["window_ticks"] * width
    assert line["metrics"]["items_per_s"]["value"] == pytest.approx(
        run["window_ticks"] * width / run["window_s"])
    assert line["checks"]["ticks_checked"]["value"] >= 2
    # the runner's graphed stretch serves every system: its readers read
    # a (made-up) profile of the toy's traced ticks
    run.update(graphed=dict(window_s=0.1, busy_s=0.04, ops=12,
                            kernels={}, device_ops=[("add", 0.04)],
                            idle_gaps=[("cudaGraphLaunch", 0.06)]),
               traced_ticks=4)
    traced = cli.result(toy, run, True, "test")
    got = {k: v["value"] for k, v in traced["metrics"].items()}
    assert got == pytest.approx({"device_idle_share": 60.0,
                                 "device_ops_per_tick": 3.0})
    assert list(traced)[-1] == "checks"


def test_toy_system_off_by_one_reads_incorrect(toy):
    run = _run(toy, patch=_off_by_one(toy))
    line = cli.result(toy, run, False, "test")
    assert line["correct"] is False
    assert line["checks"]["mismatches"]["value"] > 0
    assert line["failed"] == line["checks"]["ticks_checked"]["value"]


#: what only a stream system knows: its sizes, feed, reference, weights
STREAM_WORDS = ("micro_batch", "num_regions", "Feed(", "reference.stream",
                "core_weights")


#: what the result test, which runs every cell, names neither: the
#: stream's window kernel, its spans and the frozen yardstick
RESULT_WORDS = ("fused_tick", "obs:", "yardstick")


@pytest.mark.parametrize("path", ["pb/runner.py", "pb/cli.py", "pb/ranks.py",
                                  "conftest.py", "test_perfbench_result.py"])
def test_harness_names_no_stream_concept(path):
    text = (ROOT / "perfbench" / path).read_text()
    words = STREAM_WORDS + (RESULT_WORDS if path.startswith("test_") else ())
    found = [w for w in words if re.search(re.escape(w), text)]
    assert not found, (path, found)


SYSTEMS = sorted(p.stem for p in (ROOT / "perfbench/systems").glob("*.py")
                 if p.stem != "__init__")


@pytest.mark.parametrize("name", SYSTEMS)
def test_system_modules_give_the_contract(name):
    """Every system module gives each name ``systems/__init__.py``
    documents."""
    mod = spec._module(ROOT / "perfbench", "systems", name)
    for attr in ("params", "build", "feed", "check", "merge_numbers",
                 "small", "sample_trace"):
        assert callable(getattr(mod, attr)), attr
    assert all(callable(s) for s in mod.stretches)


#: the harness tests that run over every cell or every system module
PER_CELL = ("perfbench/test_perfbench_result.py",
            "perfbench/test_perfbench_spec.py::test_cell_parts_found_by_name",
            "perfbench/test_perfbench_contract.py"
            "::test_system_modules_give_the_contract")
TOY_CASES = {"test_line_has_every_listed_metric[False-toy.ints]",
             "test_line_has_every_listed_metric[True-toy.ints]",
             "test_cell_parts_found_by_name[toy.ints]",
             "test_system_modules_give_the_contract[toy]"}


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_dropped_in_system(tmp_path):
    """A cell of a system that is not a stream, with a traced stretch and
    a per-layer reader of its own, is new files and entries: in a copy
    of the benchmark the tests that run over every cell or every system
    module pass for it, and no file of the copy is edited."""
    root = tmp_path / "bench"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "perfbench")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "perfbench"
    (here / "systems/toy.py").write_text(TOY)
    (here / "configs/toy.json").write_text(json.dumps(CONFIG))
    (here / "traffic/ints.json").write_text(json.dumps(TRAFFIC))
    (here / "metrics/toy_tick_ms.py").write_text(TOY_READER)
    grown = dict(bench)
    grown["configs"] = bench["configs"] + [{
        "name": "toy", "source": "a test",
        "file": "perfbench/configs/toy.json", "reduced": [], "why": "a test"}]
    grown["workloads"] = bench["workloads"] + [{
        "name": "toy.ints", "config": "toy", "traffic": "ints", "chips": 1,
        "why": "a test"}]
    grown["per_layer"] = bench["per_layer"] + [{
        "name": "toy_tick_ms", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "toy step", "moves": "items_per_s",
        "workloads": ["toy.ints"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(grown, indent=1))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONDONTWRITEBYTECODE="1")
    junit = tmp_path / "junit.xml"
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "toy", f"--junitxml={junit}",
         *PER_CELL], cwd=root, env=env, capture_output=True, text=True,
        timeout=180)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    cases = ET.parse(junit).getroot().iter("testcase")
    ran = {c.get("name"): [x.tag for x in c
                           if x.tag in ("skipped", "failure", "error")]
           for c in cases}
    assert set(ran) == TOY_CASES, ran
    assert not any(ran.values()), ran
    after = _digests(root / "perfbench")
    assert {k: after.get(k) for k in before} == before
    assert json.loads((root / "BENCHMARK.json").read_text()) == grown
