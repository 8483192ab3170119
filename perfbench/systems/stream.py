"""The system under test for a ``"system": "stream"`` configuration: one
edge gateway, ``repro_torch.stream.StreamExecutor``, built from the
configuration file as it states it.

Every system module gives ``build(cfg, p, device, ranks) -> System``;
a ``System`` offers a tick with ``step(items [S, B, D], ts [S, B])``
(no synchronize), reads its counters with ``counters()`` and a tick's
outputs with ``outputs(out)`` (both on the host, in the reference's
names), and frees itself with ``close()``.
"""
from __future__ import annotations

import torch

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


def build(cfg: dict, p: torch.Tensor, device, ranks=None):
    if ranks is not None:
        raise ValueError("a gateway runs on one card")
    return Gateway(cfg, p, device)

