"""LR schedules (cosine with linear warmup, the production default).

Port of ``repro.optim.schedule``: float32 on a 0-d step tensor, the
reference's order of operations."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step: torch.Tensor, *, warmup: int, total: int,
                       floor: float = 0.1) -> torch.Tensor:
    """Multiplier in [floor, 1]; pass to AdamW ``lr_scale``."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
