"""Device-resident ring buffer -- the memory-mapped queue (paper IV-C1).

Port of ``repro.data.ringbuffer``: a fixed-shape ``[capacity, D]``
tensor with monotone int32 head/tail counters.  Same guarantees as the
reference: accepted items persist until consumed, FIFO delivery, and
backpressure reported as an explicit accept count (never a silent
drop or an overwrite).

The reference donates its buffer to every op; here ``enqueue`` writes
into ``rb.store`` in place, so a ring handed to ``enqueue`` must not
be read again as the state before the call.  Nothing on the hot path
reads a device value on the host: counts stay 0-dim tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device


class RingBuffer(NamedTuple):
    store: torch.Tensor    # [capacity + 1, D]: the ring plus one discard row
    head: torch.Tensor     # [] int32 -- total items ever enqueued
    tail: torch.Tensor     # [] int32 -- total items ever dequeued

    @property
    def capacity(self) -> int:
        return self.store.shape[0] - 1

    @property
    def buf(self) -> torch.Tensor:
        """The ring proper, ``[capacity, D]`` (a view of ``store``)."""
        return self.store[:-1]


def create(capacity: int, item_shape: tuple, dtype=torch.float32,
           device: str | torch.device | None = None) -> RingBuffer:
    """An empty ring on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    return RingBuffer(
        store=torch.zeros((capacity + 1,) + tuple(item_shape), dtype=dtype,
                          device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
        tail=torch.zeros((), dtype=torch.int32, device=device),
    )


def enqueue(rb: RingBuffer, items: torch.Tensor,
            mask: torch.Tensor | None = None
            ) -> tuple[RingBuffer, torch.Tensor]:
    """Append up to len(items); returns (rb, n_accepted).  Items beyond
    free space are rejected (backpressure), not overwritten.

    ``mask``: optional [N] bool -- only True rows are offered.
    Masked-out rows never enter the ring and don't count against free
    space; FIFO order among offered rows is preserved (stable
    compaction).  Writes ``rb.store`` in place.
    """
    cap = rb.capacity
    n = items.shape[0]
    dev = rb.store.device
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    if mask is not None:
        m = mask.to(torch.bool)
        mi = m.to(torch.int32)
        offered = mi.sum(dtype=torch.int32)
        # O(n) stable compaction: offered rows scatter to their offered
        # rank, masked-out rows to a discard slot past the batch
        slot = torch.where(m, torch.cumsum(mi, 0, dtype=torch.int32) - 1, n)
        items = torch.zeros((n + 1,) + items.shape[1:], dtype=items.dtype,
                            device=dev).index_put_((slot.long(),), items)[:n]
    else:
        offered = torch.full((), n, dtype=torch.int32, device=dev)
    free = cap - (rb.head - rb.tail)
    n_acc = torch.minimum(offered, free)
    idx = (rb.head + ar) % cap
    accept = ar < n_acc
    # rejected rows scatter to the discard row past the ring (accepted
    # slots are distinct since n_acc <= cap; when n > cap makes idx wrap
    # onto duplicate slots only rejected rows collide, in the discard row)
    safe_idx = torch.where(accept, idx, cap)
    rb.store.index_put_((safe_idx.long(),), items.to(rb.store.dtype))
    return RingBuffer(rb.store, rb.head + n_acc, rb.tail), n_acc


def dequeue(rb: RingBuffer, n: int
            ) -> tuple[RingBuffer, torch.Tensor, torch.Tensor]:
    """Pop up to ``n`` items (fixed-shape output + valid mask)."""
    cap = rb.capacity
    avail = rb.head - rb.tail
    n_out = torch.clamp(avail, max=n)
    ar = torch.arange(n, dtype=torch.int32, device=rb.store.device)
    idx = (rb.tail + ar) % cap
    out = rb.store[idx.long()]
    valid = ar < n_out
    return RingBuffer(rb.store, rb.head, rb.tail + n_out), out, valid


def size(rb: RingBuffer) -> torch.Tensor:
    return rb.head - rb.tail


def free_space(rb: RingBuffer) -> torch.Tensor:
    """Rows the next enqueue can accept before backpressure (rows past
    it are rejected, counted, and must be re-offered)."""
    return rb.capacity - (rb.head - rb.tail)
