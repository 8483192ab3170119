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

Across ranks (a ``DeviceMesh`` whose data axis spans N > 1 ranks, one a
process: ``launch.mesh.spawn``), the train step is data parallel, as
XLA runs the reference's step on its mesh: each rank takes its share of
the global batch (``sharding.batch_share``), divides its microbatch
losses by the global microbatch's label count, and the gradients are
summed over "data" in place before AdamW, so every replica takes the
same update.  The train step, and a serve step told that the requests
are split, run under ``shardctx.batch_split``: an MoE layer plans over
the global microbatch or decode step, and its load-balance loss is
this rank's share of the global one.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import optim
from repro_torch.launch import shardctx
from repro_torch.launch.mesh import all_reduce_, data_group, dp_axes
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


def sum_gradients(grads: dict, group) -> dict:
    """Sum ``grads`` over ``group`` in place, one tensor at a time in the
    mapping's order (a model's ``named_parameters()``: every rank issues
    the same sequence of all-reduces), and return them.  No second copy
    of the gradients is held."""
    for g in grads.values():
        all_reduce_(g, dist.ReduceOp.SUM, group)
    return grads


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
    learning rate.

    On a mesh of N > 1 data ranks (``launch.mesh.data_group``),
    ``batch`` is this rank's share of a global batch
    (``sharding.batch_share``): microbatch m's losses are divided by its
    count of labels >= 0 over all ranks (one all-reduce of the K
    counts), an MoE layer plans over the global microbatch and adds
    this rank's share of its load-balance loss (``shardctx.batch_split``,
    ``models.moe``), the gradients are summed over "data"
    (:func:`sum_gradients`) before ``optim.update``, and ``loss``,
    ``ce`` and ``aux`` (the last microbatch's, as the reference's
    ``microbatched_grads`` returns it) are the global batch's, equal on
    every rank, as is ``grad_norm``."""
    opt_cfg = opt_cfg or optim.AdamWConfig(
        moment_dtype=cfg.param_dtype if cfg.param_dtype == torch.bfloat16
        else torch.float32)
    group = data_group(mesh)
    split = shardctx.mesh_split(mesh)
    k = num_microbatches

    def loss(m, b):
        return T.loss_fn(cfg, m, b)

    def rank_grads(model, batch):
        """This rank's share of the global microbatches' loss and
        gradients, summed over "data"."""
        labels = batch["labels"]
        counts = (labels >= 0).reshape(k, -1).sum(1)        # [K] int64
        counts = iter(all_reduce_(counts, dist.ReduceOp.SUM, group)
                      .to(torch.float32))

        def share_loss(m, b):       # the K microbatches come in order
            return T.loss_fn(cfg, m, b, count=next(counts))

        with shardctx.batch_split(split):
            l, aux, grads = microbatched_grads(share_loss, model, batch, k)
        sum_gradients(grads, group)
        every = all_reduce_(torch.stack([l, aux["ce"], aux["aux"]]),
                            dist.ReduceOp.SUM, group)
        return every[0], {"ce": every[1], "aux": every[2]}, grads

    def train_step(model, opt_state, batch):
        with _activation_ctx(cfg, mesh, sequence_shard):
            if group is None:
                l, aux, grads = microbatched_grads(loss, model, batch, k)
            else:
                l, aux, grads = rank_grads(model, batch)
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


def build_serve_step(cfg, *, mesh=None, split_requests: bool = False):
    """(model, tokens [B, 1], caches, lengths [B]) -> (logits [B, V],
    caches, lengths + 1); the caches and recurrent states are written in
    place.  ``mesh`` is taken and not entered: the reference measured
    its split-KV constraints slower than unconstrained decode.  With
    ``split_requests`` the B rows are this rank's share of the requests
    split over ``mesh``'s data ranks (``serve.request_rows``): the step
    enters ``shardctx.batch_split`` alone, so that an MoE layer plans
    over every rank's rows (one all-gather a layer, inside the step)."""
    split = shardctx.mesh_split(mesh) if split_requests else None

    def serve_step(model, tokens, caches, lengths):
        with torch.inference_mode(), shardctx.batch_split(split):
            return T.decode_step(cfg, model, tokens, caches, lengths)
    return serve_step
