"""The system under test for a ``"system": "stream"`` configuration: one
edge gateway, ``repro_torch.stream.StreamExecutor``, built from the
configuration file as it states it.  It gives what ``systems/__init__.py``
asks of a system module: the core's weights, the stream feed
(``pb/feed.py``), the plain stream reference (``reference/stream.py``)
with its comparison (``reference/compare.py``), and the two traced
stretches of a stream (eager stage spans, then the program's own marks)
with a sample of what they record; ``fleet.py`` shares all of them.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.pb import devtrace, progtrace, yardstick
from perfbench.pb.feed import Feed, sub_seed
from perfbench.reference import compare as RC
from perfbench.reference import stream as RS


def core_weights(cfg: dict, seed: int) -> np.ndarray:
    """The core's ``[5 + D, 5 + D]`` float32 weights, from the seed."""
    w = 5 + cfg["features"]
    rng = np.random.default_rng(sub_seed(seed, 2))
    return (rng.standard_normal((w, w)) * cfg["core_weight_scale"]) \
        .astype(np.float32)


params = core_weights


def all_shards(cfg: dict) -> int:
    return cfg.get("num_regions", 1) * cfg.get("edges_per_region", 1)


class StreamFeed:
    """The stream feed as the runner takes it: tick ``t``'s ``(items,
    ts)`` for the program's shards, and the rows a tick offers over every
    shard of the run (ranks included)."""

    def __init__(self, traffic: dict, cfg: dict, shards, seed: int, device):
        self.pool = Feed(traffic, cfg, shards, seed, device)
        self.items_per_tick = cfg["micro_batch"] * all_shards(cfg)

    def tick(self, t: int) -> tuple:
        return self.pool.tick(t)


feed = StreamFeed


def check(cfg: dict, params, traffic: dict, seed: int, device, ticks: dict,
          final: dict, n_ticks: int, shards: range) -> tuple[dict, dict]:
    """The plain reference (float64 core) over every shard's feed, made
    again from the seed, held against the program's ``shards``."""
    ref = RS.Stream(cfg, torch.as_tensor(params, device=device)
                    .to(torch.float64), device)
    whole = Feed(traffic, cfg, range(all_shards(cfg)), seed, device)
    ref_ticks = ref.run(whole, n_ticks, set(ticks))
    mine = slice(shards.start, shards.stop)
    return (RC.compare(ticks, final, ref_ticks, ref.counters(), mine),
            RC.final_diffs(final, ref.counters(), mine))


def merge_numbers(nums: list) -> dict:
    """The ranks' compared numbers: mismatches summed, the widest gap,
    the fewest ticks checked."""
    return dict(
        window_mismatches=sum(x["window_mismatches"] for x in nums),
        counter_mismatches=sum(x["counter_mismatches"] for x in nums),
        core_gap=max(x["core_gap"] for x in nums),
        ticks_checked=min(x["ticks_checked"] for x in nums))


def eager_stages(tk, cfg: dict, device, scratch) -> dict:
    """``eager_ticks`` eager ticks with the program's tracer on: device
    time by stage span (``devtrace.stages``)."""
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    tk.system.set_tracer(Tracer())

    def eager():
        with tk.system.eager():
            for _ in range(cfg["eager_ticks"]):
                tk.tick()
    st = devtrace.stages(devtrace.capture(eager, scratch))
    tk.system.set_tracer(NULL_TRACER)
    return dict(stages=st, eager_ticks=cfg["eager_ticks"])


def program_marks(tk, cfg: dict, device, scratch) -> dict:
    """The program's own marked graphed ticks (``pb/progtrace.py``)."""
    return {"program": progtrace.stretch(tk)}


stretches = [eager_stages, program_marks]


def sample_trace(cfg: dict) -> tuple[dict, dict]:
    """Made-up card readings of a stream's traced run: the window
    kernel's calls at four times its least time, the eager stages, and a
    ``progtrace.stretch`` record of 4 marked ticks (device marks in ns,
    host spans in s); and what the readers read from them."""
    bound = yardstick.fused_tick_bound_s(cfg)
    n = 4
    program = dict(
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
    record = dict(
        graphed=dict(kernels={"fused_tick_kernel_span": [bound * 4] * 16}),
        eager_ticks=2,
        stages={"obs:admission": 1e-3, "obs:pipeline": 6e-4,
                "obs:fleet_watermark": 1e-4, "obs:exchange_core": 2e-3,
                "obs:core_commit": 4e-4},
        program=program)
    return record, {"fused_tick_roofline": 25.0,
                    "edge_stages_graphed_ms": 0.5,
                    "exchange_graphed_ms": 1.25, "launch_wait_ms": 0.25,
                    "step_launch_host_ms": 0.3, "step_prepare_host_ms": 0.7}


def small_traffic(traffic: dict) -> dict:
    return dict(traffic, pool_ticks=6, hot_run=2,
                nan_rows=min(traffic["nan_rows"], 4))


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    return (dict(cfg, micro_batch=1024, capacity=8192, dedupe_window=2048,
                 core_capacity=8), small_traffic(traffic))


#: the configuration's consequence names -> the program's codes
CODE_NAMES = ("none", "store_edge", "send_core", "trigger_topology",
              "drop", "notify")


def rule_engine(cfg: dict):
    from repro_torch.core import rules as R
    return R.RuleEngine([
        R.threshold_rule(r["name"], r["feature"], r["op"], r["value"],
                         CODE_NAMES.index(r["consequence"]),
                         priority=r["priority"]) for r in cfg["rules"]])


def pipeline(cfg: dict, engine, p: torch.Tensor, core_capacity):
    """The two tiers: the edge passes each window record on, the core
    runs ``core_layers`` x ``tanh(h @ p)`` on the records sent to it."""
    from repro_torch.core import pipeline as P
    layers = cfg["core_layers"]

    def edge_fn(_, batch):
        return batch, batch[:, :5]

    def core_fn(w, batch):
        h = batch
        for _ in range(layers):
            h = torch.tanh(h @ w)
        return h, batch[:, :5]
    return P.two_tier_pipeline(edge_fn, core_fn, engine, core_params=p,
                               core_capacity=core_capacity)


def stream_config(cfg: dict):
    from repro_torch.stream import AdmissionPlan, DataContract, StreamConfig
    d = cfg["features"]
    contract = None
    if "contract_lo" in cfg:
        contract = DataContract(lo=(cfg["contract_lo"],) * d,
                                hi=(cfg["contract_hi"],) * d,
                                require_finite=cfg["require_finite"])
    return StreamConfig(
        micro_batch=cfg["micro_batch"], window=cfg["window"],
        stride=cfg["stride"], capacity=cfg["capacity"],
        lateness=cfg["lateness"], min_count=cfg["min_count"],
        fused=cfg["fused"],
        admission=AdmissionPlan(dedupe_window=cfg.get("dedupe_window", 0),
                                contract=contract))


def host_outputs(out) -> dict:
    """A ``StepOutput``'s leaves on the host, with a leading shard dim."""
    names = ("aggregates", "features", "window_count", "consequence",
             "escalated", "outputs")
    return {k: getattr(out, k).cpu() for k in names}


class Gateway:
    shards = 1

    def __init__(self, cfg: dict, p: torch.Tensor, device):
        from repro_torch.stream import StreamExecutor
        self.cfg = cfg
        self.ex = StreamExecutor(stream_config(cfg), rule_engine(cfg),
                                 pipeline(cfg, rule_engine(cfg), p,
                                          cfg["core_capacity"]),
                                 device=device)
        self.state = self.ex.init_state(cfg["features"])

    def step(self, items: torch.Tensor, ts: torch.Tensor):
        self.state, out = self.ex.step(self.state, items[0], ts[0])
        return out

    def counters(self) -> dict:
        m = self.state.metrics.as_dict()
        return {k: [v] for k, v in m.items()}

    def outputs(self, out) -> dict:
        return {k: v[None] for k, v in host_outputs(out).items()}

    def set_tracer(self, tracer) -> None:
        self.ex.set_tracer(tracer)

    def eager(self):
        from repro_torch.runtime import capture
        return capture.disable()

    def close(self) -> None:
        self.ex = self.state = None


def build(cfg: dict, params, device, ranks=None):
    if ranks is not None:
        raise ValueError("a gateway runs on one card")
    return Gateway(cfg, torch.as_tensor(params, device=device), device)

