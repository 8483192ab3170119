"""``BENCHMARK.json`` and the files it names: the contract's shape, the
names and units, every cell's parts found by name, and a dropped-in
configuration, traffic mix and metric picked up with no file edited."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.conftest import bench_with_set_aside, cell, run_small
from perfbench.pb import spec as S
from perfbench.pb.cli import verdict

ROOT = Path(__file__).resolve().parents[1]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_shape():
    b = bench()
    assert set(b) == KEYS
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in SOURCES
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for x in b[group]:
            S.check_name(x["name"], group)
            names.append((group, x["name"]))
            if "unit" in x:
                assert UNIT.fullmatch(x["unit"]), x["unit"]
                assert x["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in x:
                    assert 1 <= len(x[text]) <= 200
                    assert "\n" not in x[text] and "\t" not in x[text]
    for w in b["workloads"]:
        S.check_name(w["config"], "config")
        S.check_name(w["traffic"], "traffic")
    for c in b["configs"]:
        for k in c["reduced"]:
            S.check_name(k, "reduced key")
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for g in ("configs", "workloads"):
        own = [n for x, n in names if x == g]
        assert len(set(own)) == len(own)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize(
    "name", [w["name"] for w in bench_with_set_aside()["workloads"]])
def test_cell_parts_found_by_name(name):
    c = cell(name)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(c["readers"][m["name"]].read)
    assert callable(c["system"].build)
    for key in ("source", "assumed", "reduced", "guarantees", "limits"):
        assert key in c["config"], key
    entry = {x["name"]: x for x in bench_with_set_aside()["configs"]}[
        c["workload"]["config"]]
    assert entry["reduced"] == c["config"]["reduced"]
    for k in entry["reduced"]:
        assert k in c["config"], k


def test_every_config_used_and_per_layer_moves_reported():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        e2e = {x["name"]: x for x in b["end_to_end"]}[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells
            assert "workloads" not in e2e or w in e2e["workloads"]


def test_dropped_in_config_traffic_and_metric(tmp_path):
    """A new configuration, traffic mix, metric and cell are files and
    entries: the copied benchmark finds them with no file edited."""
    root = tmp_path
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((ROOT / "perfbench/configs/edge_gateway.json")
                     .read_text())
    cfg["dedupe_window"] = 65536
    (root / "perfbench/configs/edge_gateway_k64.json").write_text(
        json.dumps(cfg))
    (root / "perfbench/traffic/bursty.json").write_text(json.dumps(
        {"pool_ticks": 10, "hot_run": 5, "hot_feature": 0,
         "hot_shift": 0.5, "redeliver_share": 0.2, "nan_rows": 8}))
    (root / "perfbench/metrics/rows_per_tick.py").write_text(
        "def read(run, cell):\n"
        "    return run['rows'] / run['window_ticks']\n")
    b["configs"].append({"name": "edge_gateway_k64",
                         "source": "https://arxiv.org/abs/1808.01353",
                         "file": "perfbench/configs/edge_gateway_k64.json",
                         "reduced": cfg["reduced"], "why": "a test"})
    b["workloads"].append({"name": "gateway_k64.bursty",
                           "config": "edge_gateway_k64", "traffic": "bursty",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "rows_per_tick", "unit": "rows",
                           "better": "higher", "source": "host_clock",
                           "layer": "harness", "moves": "items_per_s",
                           "workloads": ["gateway_k64.bursty"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = S.cell(root, "gateway_k64.bursty")
    assert c["config"]["dedupe_window"] == 65536
    assert c["traffic"]["redeliver_share"] == 0.2
    assert c["readers"]["rows_per_tick"].read(
        {"rows": 10, "window_ticks": 5}, c) == 2
    assert [m["name"] for m in c["per_layer"]][-1] == "rows_per_tick"
    # the cells already there see nothing of it
    old = S.cell(root, "fleet_8x2.hotcold")
    assert "rows_per_tick" not in {m["name"] for m in old["per_layer"]}
    # and the harness runs the new cell, reads the new metric, checks it
    run = run_small(c)
    ok, _ = verdict(run["numbers"], c["config"]["limits"])
    assert ok, run["numbers"]
    assert c["readers"]["rows_per_tick"].read(run, c) \
        == c["config"]["micro_batch"]
