"""Step functions the platform serves (serverless "topologies"):
train_step / prefill_step / serve_step.

Port of ``repro.launch.steps`` on one device: no mesh and no sharding
constraints.  The prefill and serve steps run under
``torch.inference_mode()``.  The train step records the autograd graph
(the forward and ``microbatched_grads``), then updates the parameters
and moments in place under ``torch.no_grad()`` (``optim.update``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import optim
from repro_torch.models import transformer as T
from repro_torch.runtime.overlap import microbatched_grads


def build_train_step(cfg, opt_cfg: optim.AdamWConfig | None = None, *,
                     num_microbatches: int = 1,
                     schedule: Callable | None = None):
    """(model, opt_state, batch) -> (model, opt_state, metrics): one
    AdamW step on ``model`` (a trainable ``Transformer``), its
    parameters and ``opt_state``'s moments written in place.  ``metrics``
    holds tensors (``loss``, ``grad_norm``, ``ce``, ``aux``); nothing is
    read back to the host.  The moments are bfloat16 when the
    parameters are, float32 otherwise; ``schedule(step)`` scales the
    learning rate."""
    opt_cfg = opt_cfg or optim.AdamWConfig(
        moment_dtype=cfg.param_dtype if cfg.param_dtype == torch.bfloat16
        else torch.float32)

    def loss(m, b):
        return T.loss_fn(cfg, m, b)

    def train_step(model, opt_state, batch):
        l, aux, grads = microbatched_grads(loss, model, batch,
                                           num_microbatches)
        lr_scale = schedule(opt_state.step) if schedule is not None else 1.0
        model, opt_state, om = optim.update(grads, opt_state, model,
                                            opt_cfg, lr_scale)
        for p in model.parameters():      # the gradients are spent
            p.grad = None
        metrics = {"loss": l, "grad_norm": om["grad_norm"], **aux}
        return model, opt_state, metrics

    return train_step


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
