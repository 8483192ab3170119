"""The system under test for a ``"system": "fleet"`` configuration: the
edge fleet, ``repro_torch.stream.fleet.FleetExecutor``, on one card
(every shard a row of one card's tensors) or laid over ranks (one
process a card, each holding its consecutive run of the shards; the
exchanges are the program's collectives).  Its weights, feed, reference,
check and traced stretches are the stream's (``stream.py``)."""
from __future__ import annotations

import torch

from perfbench.systems import stream as ST

#: the fleet counters kept a shard beside the stream counters
EXTRAS = ("escalations_sent", "fog_shed", "core_received",
          "core_processed", "late_excluded")


class Fleet:

    def __init__(self, cfg: dict, p: torch.Tensor, device, ranks=None):
        from repro_torch.stream.fleet import FleetConfig, FleetExecutor
        from repro_torch.stream.fleet import executor as FX
        engine = ST.rule_engine(cfg)
        fcfg = FleetConfig(
            stream=ST.stream_config(cfg),
            num_shards=cfg["num_regions"] * cfg["edges_per_region"],
            num_regions=cfg["num_regions"], num_core=cfg["num_core"],
            core_budget=cfg["core_budget"], fog_budget=cfg["fog_budget"])
        mesh = None if ranks is None else FX.rank_mesh(fcfg, device)
        self.ex = FleetExecutor(fcfg, engine,
                                ST.pipeline(cfg, engine, p, None),
                                device=device, mesh=mesh)
        # the harness closes each tick with its own synchronize
        self.ex.measure_steps = False
        self.state = self.ex.init_state(cfg["features"])
        self.shards = self.ex.local_shards
        self.first_shard = self.ex.shard_offset

    def step(self, items: torch.Tensor, ts: torch.Tensor):
        self.state, out = self.ex.step(self.state, items, ts)
        return out

    def counters(self) -> dict:
        m = self.state.metrics.as_dict()
        out = dict(m["shard"])
        for k in EXTRAS:
            out[k] = m[k]
        out["fleet_core_overflow"] = m["fleet_core_overflow"]
        out["watermark"] = m["watermark"]
        return out

    def outputs(self, out) -> dict:
        return ST.host_outputs(out)

    def set_tracer(self, tracer) -> None:
        self.ex.set_tracer(tracer)

    def eager(self):
        from repro_torch.runtime import capture
        return capture.disable()

    def close(self) -> None:
        # the captured graphs hold the ranks' collectives: drop them
        # while the process group still stands (the program offers no
        # public call for it)
        self.ex._tick_step.clear()
        self.ex = self.state = None


def build(cfg: dict, params, device, ranks=None):
    return Fleet(cfg, torch.as_tensor(params, device=device), device, ranks)


params, feed, check = ST.params, ST.feed, ST.check
merge_numbers, stretches = ST.merge_numbers, ST.stretches
sample_trace = ST.sample_trace


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    return (dict(cfg, micro_batch=512, capacity=4096, core_budget=16,
                 fog_budget=12), ST.small_traffic(traffic))
