"""Step functions the platform serves (serverless "topologies"):
train_step / prefill_step / serve_step.

Port of ``repro.launch.steps``.  The prefill and serve steps run under
``torch.inference_mode()``.  The train step records the autograd graph
(the forward and ``microbatched_grads``), then updates the parameters
and moments in place under ``torch.no_grad()`` (``optim.update``).

Given a ``mesh`` (``launch.mesh``: the host mesh, or an abstract
production mesh for the dry run), the train and prefill steps run their
forward inside ``shardctx.activation_sharding`` as the reference's do:
the batch over the mesh's data axes, the sequence over "model" when
``sequence_shard``, MoE buckets on ``moe_compute_axes``.  The serve
step takes a mesh and runs unconstrained, as the reference's does.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch import optim
from repro_torch.launch import shardctx
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import transformer as T
from repro_torch.runtime.overlap import microbatched_grads


def _activation_ctx(cfg, mesh, sequence_shard: bool):
    """The train and prefill steps' sharding context (none without a
    mesh)."""
    if mesh is None:
        return contextlib.nullcontext()
    moe = None
    if cfg.moe is not None:
        from repro_torch.launch.sharding import moe_compute_axes
        moe = moe_compute_axes(cfg, mesh)
    return shardctx.activation_sharding(
        mesh, dp_axes(mesh),
        sequence_axis="model" if sequence_shard else None, moe_axes=moe)


def build_train_step(cfg, opt_cfg: optim.AdamWConfig | None = None, *,
                     num_microbatches: int = 1,
                     schedule: Callable | None = None,
                     mesh=None, sequence_shard: bool = False):
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
        with _activation_ctx(cfg, mesh, sequence_shard):
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


def build_prefill_step(cfg, *, mesh=None, sequence_shard: bool = False):
    """(model, batch) -> (last logits [B, V], per-layer caches)."""
    def prefill_step(model, batch):
        with torch.inference_mode(), \
                _activation_ctx(cfg, mesh, sequence_shard):
            return T.prefill(cfg, model, batch)
    return prefill_step


def build_serve_step(cfg, *, mesh=None):
    """(model, tokens [B, 1], caches, lengths [B]) -> (logits [B, V],
    caches, lengths + 1); the caches and recurrent states are written in
    place.  ``mesh`` is taken and not entered: the reference measured
    its split-KV constraints slower than unconstrained decode."""
    def serve_step(model, tokens, caches, lengths):
        with torch.inference_mode():
            return T.decode_step(cfg, model, tokens, caches, lengths)
    return serve_step
