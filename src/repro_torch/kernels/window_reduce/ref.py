"""Plain PyTorch version of the ``window_reduce`` kernel.

Same function as ``csrc/window_reduce.cu`` on the same identity-filled
block: for each kept window start ``0, S, 2S, ...`` a left-to-right
accumulation over its W rows, one strided row slice per step (the
order of ``repro.stream.windows._seq_combine``, so the result is
bitwise that of the kernel and of the JAX reference).  The CPU path of
``ops.window_reduce`` runs it; ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch

_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def sliding_reduce_ref(xp: torch.Tensor, window: int, stride: int, nw: int,
                       op: str) -> torch.Tensor:
    """[rows, D] identity-filled block -> [nw, D] window reductions."""
    combine = _COMBINE[op]
    span = (nw - 1) * stride + 1
    acc = xp[0:span:stride]
    for w in range(1, window):
        acc = combine(acc, xp[w:w + span:stride])
    return acc.contiguous()
