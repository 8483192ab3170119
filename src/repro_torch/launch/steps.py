"""Step functions the platform serves (serverless "topologies").

Port of ``build_serve_step`` and ``build_prefill_step`` of
``repro.launch.steps``, on one device: no mesh and no sharding
constraints.  Each step runs under ``torch.inference_mode()``.
``build_train_step`` waits for the training slice (ROADMAP item 13b).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def build_prefill_step(cfg):
    """(model, batch) -> (last logits [B, V], per-layer caches)."""
    def prefill_step(model, batch):
        with torch.inference_mode():
            return T.prefill(cfg, model, batch)
    return prefill_step


def build_serve_step(cfg):
    """(model, tokens [B, 1], caches, lengths [B]) -> (logits [B, V],
    caches, lengths + 1); the caches and recurrent states are written in
    place."""
    def serve_step(model, tokens, caches, lengths):
        with torch.inference_mode():
            return T.decode_step(cfg, model, tokens, caches, lengths)
    return serve_step
