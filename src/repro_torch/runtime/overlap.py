"""Double-buffered host-to-device ingest staging (port of
``repro.runtime.overlap.IngestStager``) and microbatched gradient
accumulation (``microbatched_grads``).

``stage(items, ts)`` starts the transfer of micro-batch N+1 and hands
back the batch staged on the previous call, so batch N's copy hides
behind batch N-1's device compute.  On a CUDA device the host batch is
copied into pinned memory and sent with ``non_blocking=True`` on a
side stream; an event recorded there is what the consuming stream
waits on at hand-off.  Delivery *timing* changes, delivered *values*
do not: without int8 they are bitwise those of the direct loop.

``int8=True`` stages the payload as int8 plus one float32 scale
(per-batch amax/127, computed on the host so the f32 batch never
crosses) and dequantizes on the device at hand-off -- lossy, opt-in.

``microbatched_grads`` splits a batch into K slices run one after the
other, so activation memory is that of one slice; each backward pass
accumulates into the parameters' float32 ``.grad`` (the reference scans
the slices and sums into a second float32 copy of the gradients).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device


class IngestStager:
    """One batch of lead: ``stage`` returns ``None`` while priming,
    ``flush`` drains the final in-flight batch."""

    def __init__(self, int8: bool = False,
                 device: str | torch.device | None = None):
        self.int8 = int8
        self.device = resolve_device(device)     # None: the CUDA card
        self._pending = None
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def _send(self, host: torch.Tensor) -> torch.Tensor:
        if self._stream is None or host.is_cuda:
            return host.to(self.device)
        with torch.cuda.stream(self._stream):
            return host.pin_memory().to(self.device, non_blocking=True)

    def _put(self, items, ts, mode):
        ts_dev = self._send(torch.as_tensor(ts, dtype=torch.float32))
        if not self.int8:
            payload = self._send(torch.as_tensor(items, dtype=torch.float32))
        else:
            host = np.asarray(
                items.cpu() if isinstance(items, torch.Tensor) else items,
                np.float32)
            amax = float(np.max(np.abs(host))) if host.size else 0.0
            scale = amax / 127.0 if amax > 0 else 1.0
            q = np.clip(np.round(host / scale), -127, 127).astype(np.int8)
            payload = (self._send(torch.from_numpy(q)), scale)
        done = None
        if self._stream is not None:
            done = torch.cuda.Event()
            done.record(self._stream)
        return payload, ts_dev, mode, done

    def stage(self, items, ts, mode=0):
        """Start transferring (items, ts); return the previous batch as
        ``(items, ts, mode)`` on the device (dequantized), or ``None``
        while priming.  ``mode`` rides the double buffer with its
        batch: a replay/backfill batch is delivered as one."""
        prev, self._pending = self._pending, self._put(items, ts, mode)
        return self._deliver(prev)

    def flush(self):
        """Hand back the final in-flight batch, if any."""
        prev, self._pending = self._pending, None
        return self._deliver(prev)

    def _deliver(self, staged):
        if staged is None:
            return None
        payload, ts, mode, done = staged
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            # the side stream allocated these: keep them alive until the
            # consumer's work on them is done
            for t in (payload[0] if self.int8 else payload, ts):
                t.record_stream(consumer)
        if self.int8:
            q, scale = payload
            scale = torch.full((), scale, dtype=torch.float32,
                               device=q.device)
            return q.to(torch.float32) * scale, ts, mode
        return payload, ts, mode


def _microbatch(batch: dict, k: int, i: int) -> dict:
    """Slice ``i`` of ``k`` of every leaf of ``batch``: along axis 0,
    along axis 1 for the ``[3, B, T]`` M-RoPE position streams."""
    out = {}
    for key, a in batch.items():
        ax = 1 if key == "mrope_positions" else 0
        b = a.shape[ax]
        if b % k:
            raise ValueError(f"microbatched_grads: {key} has {b} rows on "
                             f"axis {ax}, not a multiple of {k}")
        out[key] = a.narrow(ax, i * (b // k), b // k)
    return out


def microbatched_grads(loss_fn: Callable, model: nn.Module, batch: dict,
                       num_microbatches: int):
    """Accumulate gradients over K microbatches.  ``loss_fn(model,
    batch) -> (loss, aux)``; batch leaves are split on axis 0 (axis 1
    for ``mrope_positions``), which K must divide.  Returns (loss, aux,
    grads): the mean of the K losses, the last microbatch's aux, and
    ``{name: gradient}`` over ``model.named_parameters()``, zeros for a
    parameter the loss does not reach.  K = 1: each gradient in its
    parameter's dtype.  K > 1: the float32 sum over the microbatches
    divided by K, as the reference sums.  A float32 parameter's sum is
    its ``.grad``, which each backward pass adds into (from nothing, so
    ``0 + g_1 + ... + g_K`` exactly as the reference's scan); another
    dtype's goes to a float32 buffer beside it.  The call overwrites
    every ``.grad``."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    k = num_microbatches
    loss_sum, aux, acc = None, None, {}
    for i in range(k):
        with torch.enable_grad():
            loss, aux = loss_fn(model, batch if k == 1
                                else _microbatch(batch, k, i))
        loss.backward()
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        if k > 1:
            for n, p in params.items():
                if p.dtype != torch.float32 and p.grad is not None:
                    g = p.grad.to(torch.float32)
                    acc[n] = g if n not in acc else acc[n] + g
                    p.grad = None
    grads = {}
    for n, p in params.items():
        g = acc.get(n, p.grad)
        if g is None:
            g = torch.zeros_like(p, dtype=torch.float32 if k > 1 else None)
        grads[n] = g.div_(float(k)) if k > 1 else g
    aux = {key: a.detach() for key, a in aux.items()}
    return (loss_sum if k == 1 else loss_sum / float(k)), aux, grads
