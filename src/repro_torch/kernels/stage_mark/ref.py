"""Plain version of the ``stage_mark`` kernel: the host's
``perf_counter`` (ns) in place of the card's ``%globaltimer``, written
into the same ring by the same rule, so that the CPU tests exercise the
tracer's bookkeeping."""
from __future__ import annotations

import time

import torch


def stage_mark_ref(ring: torch.Tensor, slot: int, tag: int = 0) -> None:
    ticks, width = ring.shape[0] - 1, ring.shape[1]
    count = int(ring[ticks, 0])
    row = ring[count % ticks]
    row[slot] = time.perf_counter_ns()
    if tag:
        row[0] = tag
        ring[ticks, 0] = count + 1
