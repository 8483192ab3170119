"""A system that is not a stream runs through the harness as it stands:
a toy system, its configuration, traffic and plain reference are files
of a benchmark of its own, found by name (``spec.cell``), run on the CPU
(``runner.measure``) and judged (``cli.result``) with no harness file
edited.  A sound run reads ``correct`` true, one whose step is off by
one reads false.  And the harness's own modules name no stream
concept."""
from __future__ import annotations

import contextlib
import json
import re
import shutil
import time

import pytest

from perfbench.conftest import ROOT, SEED
from perfbench.pb import cli, spec

#: the toy: each step adds a tick's seeded integer vector and a seeded
#: offset into an int64 accumulator on the device; the plain reference
#: sums the same feed, made again from the seed, on the host
TOY = '''
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


stretches = []


def small(cfg, traffic):
    return dict(cfg, width=1024), traffic
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


@pytest.mark.parametrize("path", ["pb/runner.py", "pb/cli.py", "pb/ranks.py",
                                  "conftest.py"])
def test_harness_names_no_stream_concept(path):
    text = (ROOT / "perfbench" / path).read_text()
    found = [w for w in STREAM_WORDS if re.search(re.escape(w), text)]
    assert not found, (path, found)


@pytest.mark.parametrize("name", ["stream", "fleet"])
def test_system_modules_give_the_contract(name):
    """Every system module gives each name ``systems/__init__.py``
    documents."""
    mod = spec._module(ROOT / "perfbench", "systems", name)
    for attr in ("params", "build", "feed", "check", "merge_numbers",
                 "small"):
        assert callable(getattr(mod, attr)), attr
    assert all(callable(s) for s in mod.stretches)
