"""Wrapper for the ``stage_mark`` kernel: one time stamp into a
tracer's ring (``obs.trace.Tracer(device_marks=True)``).

The ring is int64 ``[ticks + 1, width]``.  Row ``ticks`` holds at
``[0]`` the count of ticks marked so far, and a mark writes row
``count % ticks``: the time at column ``slot``; with a ``tag`` other
than 0 also the tag at column 0, and the count advances (the tick's
last mark).  Launched while a tick is captured, a mark is a node of the
CUDA graph and stamps every replay with no host work.

Dispatch follows the ring's device: a CUDA ring launches
``csrc/stage_mark.cu`` (``%globaltimer``), a CPU ring takes the plain
version (``time.perf_counter_ns()``).  The library is built and loaded
at the first mark on the card, so a run that marks nothing builds
nothing.  ``stage_mark.launches`` counts kernel launches (a replayed
launch counts at each replay, as ``runtime.capture`` adds it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stage_mark.ref import stage_mark_ref


def _lib() -> ctypes.CDLL:
    lib = build.library("stage_mark")
    if not lib.stage_mark_i64.argtypes:
        lib.stage_mark_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.stage_mark_i64.restype = ctypes.c_int
    return lib


def load() -> None:
    """Build (if stale) and load the kernel's library ahead of the first
    mark, outside any capture."""
    _lib()


def stage_mark(ring: torch.Tensor, slot: int, tag: int = 0) -> None:
    """Stamp the ring's current row at ``slot``; ``tag`` != 0 closes the
    tick (see the module docstring)."""
    if ring.dtype != torch.int64 or ring.ndim != 2 \
            or not ring.is_contiguous() or ring.shape[0] < 2:
        raise ValueError(f"a mark ring is contiguous int64 [ticks + 1, "
                         f"width], got {ring.dtype} {tuple(ring.shape)}")
    if not 1 <= slot < ring.shape[1]:
        raise ValueError(f"slot {slot} outside 1..{ring.shape[1] - 1}")
    if not ring.is_cuda:
        stage_mark_ref(ring, slot, tag)
        return
    lib = _lib()
    err = lib.stage_mark_i64(
        ring.data_ptr(), ring.shape[0] - 1, ring.shape[1], slot, tag,
        torch.cuda.current_stream(ring.device).cuda_stream)
    build.check(lib, err, "stage_mark launch")
    stage_mark.launches += 1


stage_mark.launches = 0
