"""PyTorch + CUDA port of the edge stream-analytics system in ``repro``.

The package mirrors ``repro``'s subpackage layout (``data/``,
``stream/``, ``core/``, ``obs/``, ``runtime/``, ``kernels/``,
``models/``, ``configs/``, ``optim/``, ``checkpoint/``, ``launch/``) so
every module has an obvious reference.  It imports ``torch`` and never
``jax`` or ``repro``.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``); without a card they raise instead of falling back.
Every kernel wrapper dispatches on the device of the tensor it is
given: a CUDA tensor launches the hand-written Hopper kernel (built
from ``kernels/csrc/`` at first use), a CPU tensor takes the kernel's
plain PyTorch version.
"""
from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card.  Asking for CUDA on a machine
    without a card raises: nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the "
            "CPU (the kernels' plain versions)")
    return dev


@functools.lru_cache(maxsize=64)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, copied there once.  A fresh
    copy every tick would be a host-to-device transfer that waits for
    the card.  Every caller shares the tensor: read it, never write it."""
    return torch.tensor(values, dtype=dtype, device=device)
