"""Plain PyTorch version of the ``hilbert`` kernel.

The loop of ``repro.core.sfc.xy2d``, which is the reference's oracle
for its kernel: ``order`` steps of test-bit / accumulate / reflect /
swap in uint32.  The uint32 values ride in int64 tensors, masked to
32 bits after every step that can leave them, so the result is
bitwise the reference's for any int32 input.  The CPU path of
``ops.hilbert_xy2d`` runs it; ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def hilbert_xy2d_ref(x: torch.Tensor, y: torch.Tensor,
                     order: int) -> torch.Tensor:
    """int32 x, y (any shape) -> int32 bit pattern of the uint32 index."""
    x = x.to(torch.int64) & _MASK
    y = y.to(torch.int64) & _MASK
    d = torch.zeros_like(x)
    for i in range(order - 1, -1, -1):           # s = 2^i
        s = 1 << i
        rx = ((x & s) != 0).to(torch.int64)
        ry = ((y & s) != 0).to(torch.int64)
        d = (d + ((s * s) & _MASK) * ((3 * rx) ^ ry)) & _MASK
        # rotate quadrant: if ry==0 {if rx==1 reflect; swap x,y}
        reflect = (ry == 0) & (rx == 1)
        x_r = torch.where(reflect, (s - 1 - x) & _MASK, x)
        y_r = torch.where(reflect, (s - 1 - y) & _MASK, y)
        swap = ry == 0
        x, y = torch.where(swap, y_r, x_r), torch.where(swap, x_r, y_r)
    return torch.where(d >= 1 << 31, d - (1 << 32), d).to(torch.int32)
