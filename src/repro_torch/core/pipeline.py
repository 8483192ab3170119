"""Edge/core data-driven pipelines (paper II, IV, Fig. 13-14).

Port of ``repro.core.pipeline``.  A pipeline is a sequence of stages,
each bound to a placement tier ("edge" or "core") and a processing
function; between stages the rule engine decides each item's fate --
stay, escalate to the core stage, store, or drop.  Items carry a live
mask instead of being filtered, so every stage runs on the full
fixed-shape batch and the escalated subset is a masked batch.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core import routing as RT
from repro_torch.core import rules as R


@dataclasses.dataclass(frozen=True)
class Stage:
    """One processing stage.

    fn: (params, batch [N, ...]) -> (outputs [N, ...], features [N, F])
    The features feed the rule engine that gates the *next* stage.
    """
    name: str
    fn: Callable
    placement: str = "edge"            # "edge" | "core"
    params: object = None


class PipelineResult(NamedTuple):
    outputs: torch.Tensor              # [N, ...] final outputs (masked)
    consequence: torch.Tensor          # [N] last consequence code per item
    escalated: torch.Tensor            # [N] bool reached the core tier
    stored: torch.Tensor               # [N] bool marked store-at-edge
    dropped: torch.Tensor              # [N] bool dropped by quality rules
    stage_features: tuple              # per-stage [N, F] features


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[N] mask broadcastable against ``like`` [N, ...]."""
    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1))


class DataDrivenPipeline:
    """Rule-gated multi-stage pipeline (edge tier -> rules -> core tier).

    ``core_capacity``: when set, core-placement stages run on a compact
    batch of at most that many escalated items -- the core tier is
    provisioned for the escalated fraction, not the full stream.
    """

    def __init__(self, stages: Sequence[Stage], engine: R.RuleEngine,
                 core_capacity: int | None = None):
        if not stages:
            raise ValueError("pipeline needs >= 1 stage")
        self.stages = tuple(stages)
        self.engine = engine
        self.core_capacity = core_capacity

    def __call__(self, batch: torch.Tensor) -> PipelineResult:
        return self.run(batch)

    @property
    def core_index(self) -> int | None:
        """Index of the first core-placement stage, or None."""
        for i, stage in enumerate(self.stages):
            if stage.placement == "core":
                return i
        return None

    @property
    def core_stage(self) -> Stage | None:
        i = self.core_index
        return None if i is None else self.stages[i]

    def run_core(self, batch: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Apply the core stage fn bare to an (already compacted) batch."""
        stage = self.core_stage
        if stage is None:
            raise ValueError("pipeline has no core stage")
        return stage.fn(stage.params, batch)

    def run_edge(self, batch: torch.Tensor,
                 live: torch.Tensor | None = None
                 ) -> tuple[PipelineResult, torch.Tensor]:
        """Run the stages before the first core stage -- the same
        prefix of :meth:`run` -- and stop at the escalation boundary.
        Returns (partial result, [N] bool mask of items the rules sent
        into the core stage)."""
        n = batch.shape[0]
        dev = batch.device
        live = torch.ones((n,), dtype=torch.bool, device=dev) \
            if live is None else live.to(torch.bool)
        stored = torch.zeros((n,), dtype=torch.bool, device=dev)
        dropped = torch.zeros((n,), dtype=torch.bool, device=dev)
        consequence = torch.zeros((n,), dtype=torch.int32, device=dev)
        outputs = batch
        feats_all = []
        stop = self.core_index if self.core_index is not None \
            else len(self.stages)
        for i in range(stop):
            stage = self.stages[i]
            new_out, feats = stage.fn(stage.params, outputs)
            feats_all.append(feats)
            outputs = torch.where(_rows(live, new_out), new_out, outputs)
            _, cons = self.engine.evaluate(feats)
            consequence = torch.where(live, cons, consequence)
            stored |= live & (consequence == R.C_STORE_EDGE)
            dropped |= live & (consequence == R.C_DROP)
            if i + 1 < len(self.stages):
                nxt = self.stages[i + 1]
                goes_on = consequence == R.C_SEND_CORE \
                    if nxt.placement == "core" \
                    else (consequence != R.C_DROP) \
                    & (consequence != R.C_STORE_EDGE)
                live = live & goes_on
        core_live = live if self.core_index is not None \
            else torch.zeros((n,), dtype=torch.bool, device=dev)
        return PipelineResult(outputs, consequence, core_live, stored,
                              dropped, tuple(feats_all)), core_live

    def commit_core(self, partial: PipelineResult, core_live: torch.Tensor,
                    core_out: torch.Tensor, core_feats: torch.Tensor,
                    processed: torch.Tensor) -> PipelineResult:
        """Fold remotely computed core-stage results back into a
        :meth:`run_edge` partial result: only ``core_live & processed``
        items commit outputs and re-evaluate rules."""
        commit = core_live & processed.to(torch.bool)
        outputs = torch.where(_rows(commit, core_out), core_out,
                              partial.outputs)
        _, cons = self.engine.evaluate(core_feats)
        cons = torch.where(commit, cons, partial.consequence)
        stored = partial.stored | (core_live & (cons == R.C_STORE_EDGE))
        dropped = partial.dropped | (core_live & (cons == R.C_DROP))
        return PipelineResult(outputs, cons, core_live, stored, dropped,
                              partial.stage_features + (core_feats,))

    def _apply_stage(self, stage: Stage, outputs, live, core_budget=None):
        """Run a stage; core stages with a capacity run compacted.

        Returns (outputs, features, processed): ``processed`` marks the
        items the stage actually computed (capacity overflow items are
        shed to their edge results).  ``core_budget``: optional 0-dim
        int tensor masking how many of the ``core_capacity`` slots get
        real work this call (first-come-first-kept)."""
        cap = self.core_capacity
        if stage.placement != "core":
            out, feats = stage.fn(stage.params, outputs)
            return out, feats, torch.ones_like(live)
        allowed = live
        if core_budget is not None:
            allowed = live & (torch.cumsum(live.to(torch.int32), 0,
                                           dtype=torch.int32) <= core_budget)
        if cap is None or cap >= live.shape[0]:
            out, feats = stage.fn(stage.params, outputs)
            return out, feats, allowed
        return RT.compact_apply(
            functools.partial(stage.fn, stage.params), outputs, allowed, cap)

    def run(self, batch: torch.Tensor,
            live: torch.Tensor | None = None,
            core_budget: torch.Tensor | None = None) -> PipelineResult:
        """Every stage runs on the full fixed-shape batch; rule
        consequences mask which items the next stage *commits*.

        ``live``: optional [N] bool entry mask -- rows that are False
        pass through untouched and never consume core capacity.
        ``core_budget``: optional 0-dim int tensor bounding how many
        escalated items core stages process this call."""
        partial, live = self.run_edge(batch, live)
        ci = self.core_index
        if ci is None:
            return partial
        n = batch.shape[0]
        # a core-first pipeline enters its core stage without a rule
        # transition, so nothing counts as escalated yet
        escalated = partial.escalated if ci \
            else torch.zeros((n,), dtype=torch.bool, device=batch.device)
        stored, dropped = partial.stored, partial.dropped
        consequence, outputs = partial.consequence, partial.outputs
        feats_all = list(partial.stage_features)
        for i in range(ci, len(self.stages)):
            stage = self.stages[i]
            new_out, feats, processed = self._apply_stage(
                stage, outputs, live, core_budget)
            feats_all.append(feats)
            # commit outputs only for live, actually-processed items
            commit = live & processed
            outputs = torch.where(_rows(commit, new_out), new_out, outputs)
            _, cons = self.engine.evaluate(feats)
            # unprocessed items keep their previous consequence: their
            # stage features are gather padding, not real computation
            consequence = torch.where(commit, cons, consequence)
            stored = stored | (live & (consequence == R.C_STORE_EDGE))
            dropped = dropped | (live & (consequence == R.C_DROP))
            if i < len(self.stages) - 1:
                nxt = self.stages[i + 1]
                goes_on = consequence == R.C_SEND_CORE \
                    if nxt.placement == "core" \
                    else (consequence != R.C_DROP) \
                    & (consequence != R.C_STORE_EDGE)
                if nxt.placement == "core":
                    escalated = escalated | (live & goes_on)
                live = live & goes_on
        return PipelineResult(outputs, consequence, escalated, stored,
                              dropped, tuple(feats_all))


def two_tier_pipeline(edge_fn: Callable, core_fn: Callable,
                      engine: R.RuleEngine,
                      edge_params=None, core_params=None,
                      core_capacity: int | None = None) -> DataDrivenPipeline:
    """The paper's canonical shape: edge pre-process -> rules -> core."""
    return DataDrivenPipeline(
        [Stage("edge_preprocess", edge_fn, "edge", edge_params),
         Stage("core_postprocess", core_fn, "core", core_params)],
        engine, core_capacity=core_capacity)
