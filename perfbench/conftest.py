"""The harness's own tests run its cells on the CPU at a size a test run
holds: every width as configured, each system's sizes cut by its
``small`` (``shrink``)."""
from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 4099

#: entries set aside from ``BENCHMARK.json`` whose files the tests still
#: drive (``PERF.md``, Open questions): the gateway's exactly-once cell,
#: out until the program tells a fresh row from a re-delivery, and the
#: fleet over four cards, out for want of chip time
SET_ASIDE = {
    "configs": [{"name": "edge_gateway",
                 "source": "https://arxiv.org/abs/1808.01353",
                 "file": "perfbench/configs/edge_gateway.json",
                 "reduced": [], "why": "one edge gateway, admission on"}],
    "workloads": [{"name": "gateway.redeliver", "config": "edge_gateway",
                   "traffic": "redeliver", "chips": 1,
                   "why": "5% re-sent and 64 NaN rows a tick"},
                  {"name": "fleet_8x2.ranks4", "config": "fleet_8x2",
                   "traffic": "hotcold", "chips": 4,
                   "why": "the hotcold feed, 2 shards a card on 4 cards"}],
}


def bench_with_set_aside() -> dict:
    from perfbench.pb import spec
    bench = spec.benchmark(ROOT)
    for k, extra in SET_ASIDE.items():
        bench[k] = bench[k] + extra
    return bench


def cell(name: str) -> dict:
    """Cell ``name`` of ``BENCHMARK.json`` or of ``SET_ASIDE``."""
    from perfbench.pb import spec
    return spec.cell(ROOT, name, bench_with_set_aside())


def shrink(cell: dict) -> dict:
    """``cell`` at a CPU test's size, in place (a module-level function:
    the ranks' processes import it)."""
    cfg, tr = cell["system"].small(cell["config"], cell["traffic"])
    cell["config"] = dict(cfg, check_one_in=3, warmup_ticks=2)
    cell["traffic"] = tr
    return cell


def run_small(cell: dict, seed: int = SEED, seconds: float = 0.4,
              patch=None) -> dict:
    from perfbench.pb import runner
    return runner.measure(shrink(cell), seed, seconds, False, "cpu",
                          time.perf_counter(), patch=patch)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
