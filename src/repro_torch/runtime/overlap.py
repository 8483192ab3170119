"""Double-buffered host-to-device ingest staging (port of
``repro.runtime.overlap.IngestStager``; the training-era
``microbatched_grads`` belongs to a later slice).

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
"""
from __future__ import annotations

import numpy as np
import torch

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
