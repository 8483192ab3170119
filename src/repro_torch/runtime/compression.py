"""Gradient compression for cross-pod sync: int8 + error feedback.

Port of ``repro.runtime.compression``.  At two or more pods the
gradient all-reduce crosses the slow inter-pod links; int8 with a
per-tensor scale cuts that traffic 4x, and error feedback (the
quantization residual carried into the next step) keeps SGD's
convergence (the 1-bit Adam / EF-SGD lineage).

Trees are nested dicts of tensors.  On one card the pod axis is the
leading dim of each gradient tensor: an ``amax`` over it stands for
``pmax``, a sum over it for ``psum``.  Rounding is half-to-even
(``torch.round``), as ``jnp.round``'s.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CompressedGrad(NamedTuple):
    q: torch.Tensor             # int8 payload
    scale: torch.Tensor         # [] float32 per-tensor scale


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def quantize(g: torch.Tensor) -> CompressedGrad:
    amax = torch.amax(torch.abs(g)).to(torch.float32)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return CompressedGrad(q.to(torch.int8), scale)


def dequantize(c: CompressedGrad) -> torch.Tensor:
    return c.q.to(torch.float32) * c.scale


def compress_tree(grads: dict, errors: dict) -> tuple[dict, dict]:
    """Quantize grads + error feedback; returns (compressed, new errors)."""
    def one(g, e):
        total = g.to(torch.float32) + e
        c = quantize(total)
        return c, total - dequantize(c)

    pairs = _map(one, grads, errors)
    return (_map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs))


def decompress_tree(comp: dict) -> dict:
    return _map(dequantize, comp)


def init_errors(grads: dict) -> dict:
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


#: float32 1/127.  The reference's all-reduce runs only compiled (its
#: collectives need ``shard_map``), and XLA rewrites two of its
#: operations: the division by the constant 127 becomes a
#: multiplication by this reciprocal (``amax * (1/127)`` can differ
#: from ``amax / 127`` in the last bit), and ``total - q * scale`` one
#: fused multiply-add, rounded once.  The port computes the scale so,
#: and the residual in float64 (``q * scale`` and the difference are
#: exact there: q is an int8 value, the difference within scale / 2)
#: rounded once to float32: the same bits.  ``quantize`` keeps the
#: division and both roundings, as the reference's does outside ``jit``.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def cross_pod_allreduce(grads: dict, errors: dict) -> tuple[dict, dict]:
    """Error-feedback int8 all-reduce over the pod dim (dim 0 of every
    leaf, one row a pod).

    All pods quantize against the same scale, or the integer sum would
    mean nothing: the scale is agreed first (the ``amax`` over every
    pod's values, the reference's one scalar ``pmax``; see
    :data:`_INV_127`), then the int8 payloads are summed (its
    ``psum``).  Per-element error is at most
    scale / 2, and the residual is carried by error feedback.  Returns
    (the synced mean, each pod's row the same, the new errors), both
    ``[pods, ...]``."""
    def reduce_one(g, e):
        n = g.shape[0]
        total = g.to(torch.float32) + e
        amax = torch.amax(torch.abs(total))
        scale = torch.where(amax > 0, amax * _INV_127, 1.0)
        q = torch.clamp(torch.round(total / scale), -127, 127)
        new_e = (total.double() - q.double() * scale.double()).float()
        qs = torch.sum(q.to(torch.int32).to(torch.float32), dim=0)
        return (qs * scale / n).expand_as(total), new_e

    pairs = _map(reduce_one, grads, errors)
    return (_map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs))
