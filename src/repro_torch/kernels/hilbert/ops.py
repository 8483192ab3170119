"""Wrapper for the ``hilbert`` kernel: any-shape batches of points.

Contract of ``repro.kernels.hilbert.ops.hilbert_xy2d``: int32 ``x``,
``y`` of one shape -> int32 ``d`` of that shape, the bit pattern of
the uint32 Hilbert index at ``order``.  The TPU wrapper pads the
flattened batch to whole (8, 128) tiles and slices the result; the
CUDA kernel walks the flat batch with a grid-stride loop and masks its
own tail, so there is no padding here.

Dispatch follows the tensor's device: a CUDA tensor launches
``csrc/hilbert.cu`` (or raises), a CPU tensor takes the plain version in
``ref.py``.  ``hilbert_xy2d.launches`` counts kernel launches.  A launch
inside a captured CUDA graph (``runtime.capture``) is counted at each
replay: the capture records what the counters gained and adds it again.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.hilbert.ref import hilbert_xy2d_ref


def _lib() -> ctypes.CDLL:
    lib = build.library("hilbert")
    if not lib.hilbert_xy2d_i32.argtypes:
        lib.hilbert_xy2d_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.hilbert_xy2d_i32.restype = ctypes.c_int
    return lib


def hilbert_xy2d(x: torch.Tensor, y: torch.Tensor,
                 order: int = 16) -> torch.Tensor:
    """Batched Hilbert index: any-shape int32 x/y -> same-shape int32 d;
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError(f"hilbert_xy2d takes int32, got {x.dtype}, {y.dtype}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and y "
                         f"{tuple(y.shape)} on {y.device} differ")
    if not 0 <= order <= 32:
        raise ValueError(f"order must be in [0, 32], got {order}")
    with cost.counted("hilbert", cost.hilbert, x.numel(), order):
        if not x.is_cuda:
            return hilbert_xy2d_ref(x, y, order)
        return _launch(x, y, order)


def _launch(x: torch.Tensor, y: torch.Tensor, order: int) -> torch.Tensor:
    x, y = x.contiguous(), y.contiguous()
    d = torch.empty_like(x)
    if x.numel() == 0:
        return d
    lib = _lib()
    err = lib.hilbert_xy2d_i32(
        x.data_ptr(), y.data_ptr(), d.data_ptr(), x.numel(), order,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "hilbert launch")
    hilbert_xy2d.launches += 1
    return d


hilbert_xy2d.launches = 0
