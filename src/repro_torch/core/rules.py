"""Data-driven IF-THEN rule engine (paper IV-D2).

Port of ``repro.core.rules``.  Rules are predicates over per-item
feature tensors; for every item all conditions are evaluated and the
satisfied rule with the highest priority fires (the paper's conflict
set).  Consequences are integer action codes the pipeline maps to
reactions (store, escalate, drop, ...).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

# Built-in consequence codes (pipeline reactions)
C_NONE, C_STORE_EDGE, C_SEND_CORE, C_TRIGGER_TOPOLOGY, C_DROP, C_NOTIFY = \
    0, 1, 2, 3, 4, 5

CONSEQUENCE_NAMES = ["none", "store_edge", "send_core", "trigger_topology",
                     "drop", "notify"]


@dataclasses.dataclass(frozen=True)
class Rule:
    """IF ``condition(features) -> bool[...]`` THEN ``consequence``.

    ``feature_idx``/``op``/``value`` are the optional *tabular* form of
    the condition (set by :func:`threshold_rule`), which the fused tick
    kernel applies inline.  ``None`` for arbitrary-callable rules.
    """
    name: str
    condition: Callable[[torch.Tensor], torch.Tensor]
    consequence: int
    priority: int = 0
    payload: str | None = None
    feature_idx: int | None = None
    op: str | None = None
    value: float | None = None


class RuleEngine:
    """Vectorized conflict-set resolution.

    ``evaluate(features)`` takes [N, F] feature vectors and returns
    ([N] int32 fired-rule index or -1, [N] int32 consequence code).
    """

    def __init__(self, rules: Sequence[Rule]):
        if not rules:
            raise ValueError("need at least one rule")
        self.rules = tuple(rules)
        # Stable ordering: higher priority wins; ties -> earlier rule.
        self._order = sorted(range(len(rules)),
                             key=lambda i: (-rules[i].priority, i))
        self._table = None if any(
            r.feature_idx is None or r.op is None or r.value is None
            for r in self.rules) else tuple(
            (self.rules[i].feature_idx, self.rules[i].op,
             float(self.rules[i].value), self.rules[i].consequence)
            for i in reversed(self._order))

    def evaluate(self, features: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        n = features.shape[0]
        fired = torch.full((n,), -1, dtype=torch.int32,
                           device=features.device)
        consequence = torch.full((n,), C_NONE, dtype=torch.int32,
                                 device=features.device)
        # lowest precedence first so highest precedence overwrites; the
        # consequence rides the same sweep instead of a gather through a
        # code table (which would be a host-to-device copy per call)
        for i in reversed(self._order):
            cond = self.rules[i].condition(features).reshape(n).to(torch.bool)
            fired = torch.where(cond, i, fired)
            consequence = torch.where(cond, self.rules[i].consequence,
                                      consequence)
        return fired, consequence

    def __call__(self, features: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        return self.evaluate(features)

    def table(self) -> tuple[tuple[int, str, float, int], ...] | None:
        """The engine as a static comparison table
        ``((feature_idx, op, value, consequence), ...)`` in application
        order (lowest precedence first), or ``None`` when any rule is a
        non-tabular callable.  Built once: the rules are immutable."""
        return self._table


def threshold_rule(name: str, feature_idx: int, op: str, value: float,
                   consequence: int, priority: int = 0,
                   payload: str | None = None) -> Rule:
    """Paper-style rule: ``IF(RESULT >= 10) THEN trigger(topology)``.
    A python float threshold is compared in the features' float32."""
    ops = {
        ">=": lambda f: f[:, feature_idx] >= value,
        ">":  lambda f: f[:, feature_idx] > value,
        "<=": lambda f: f[:, feature_idx] <= value,
        "<":  lambda f: f[:, feature_idx] < value,
        "==": lambda f: f[:, feature_idx] == value,
    }
    if op not in ops:
        raise ValueError(f"unknown op {op!r}")
    return Rule(name, ops[op], consequence, priority, payload,
                feature_idx=feature_idx, op=op, value=value)


def deadline_rule(name: str, latency_idx: int, budget: float,
                  consequence: int = C_STORE_EDGE, priority: int = 10) -> Rule:
    """Quality rule: items whose processing deadline budget is exceeded
    stay at the edge (trade data quality for latency, paper IV-D2)."""
    return Rule(name, lambda f: f[:, latency_idx] > budget, consequence,
                priority)
