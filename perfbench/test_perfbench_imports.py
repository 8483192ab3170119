"""What the benchmark loads: nothing whose top-level module name,
compared whole, is ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro`` (the port, ``repro_torch``, begins with that name), and no
module of the reference, each imported alone, the port either.  Each
check runs in a fresh interpreter: the test process itself may hold
JAX."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.conftest import ROOT

FOREIGN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(1)
from pathlib import Path
from perfbench.pb import cli, devtrace, feed, ranks, runner, spec
from perfbench.pb import yardstick
from perfbench.conftest import run_small
bench = spec.benchmark(Path({root!r}))
for w in bench["workloads"]:
    cell = spec.cell(Path({root!r}), w["name"])
    if w["chips"] == 1:
        run_small(cell, seconds=0.2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import importlib, json, sys
sys.path[:0] = [{root!r}]
importlib.import_module("perfbench.reference.{name}")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCES = sorted(p.stem for p in (ROOT / "perfbench/reference")
                    .glob("*.py") if p.stem != "__init__")


def _top_names(code: str, **fields) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code.format(root=str(ROOT),
                                           src=str(ROOT / "src"),
                                           **fields)],
        check=True, capture_output=True, text=True, env=env, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_names(HARNESS)
    assert "repro_torch" in names and "perfbench" in names
    assert not names & FOREIGN, names & FOREIGN


@pytest.mark.parametrize("name", REFERENCES)
def test_reference_loads_neither_jax_nor_the_port(name):
    names = _top_names(REFERENCE, name=name)
    assert "torch" in names
    assert not names & (FOREIGN | {"repro_torch"}), names


def _run(root, *extra) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "fleet_8x2.hotcold", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         *extra], cwd=root, capture_output=True, text=True, env=env,
        timeout=300)


def test_no_card_no_result():
    r = _run(ROOT, "--trace", "0")
    assert r.returncode == 2 and r.stdout == "", (r.returncode, r.stdout)
    assert "CUDA" in r.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert "repro_torch" in r.stderr
