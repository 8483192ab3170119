"""Wrapper for the ``window_reduce`` kernel: masking, stride, padding.

The contract of ``repro.kernels.window_reduce.ops.window_reduce``
(mask-aware sum/mean/max/min/count, any stride, partial tail windows):

* invalid rows are filled with the reduction identity before the call,
* the block is row-padded with the identity so every window start --
  partial tails included -- has all its W rows,
* mean = kernel-sum / max(count, 1); empty max/min windows are forced
  to 0, to match the framed reference exactly.

The TPU kernel computes the dense stride-1 result over a block padded
to its (8, 128) tile and the wrapper slices every S-th row; the CUDA
kernel computes the kept windows only and masks its own ragged edge,
so neither the tile padding nor the slice has a counterpart here.

Dispatch follows the tensor's device: a CUDA tensor launches
``csrc/window_reduce.cu`` (or raises), a CPU tensor takes the plain
version in ``ref.py``.  :func:`plan` sizes the ``span`` instance, which
stages K windows' rows in shared memory a block (``kernels/span.py``);
the ``simple`` instance (the first port's kernel) runs only when asked
for by name, to hold the other against it.  Each call is one launch:
``window_reduce.launches`` counts them all,
``window_reduce.simple_launches`` those of the simple instance.  A
launch inside a captured CUDA graph (``runtime.capture``) is counted at
each replay: the capture records what the counters gained and adds it
again.  Each call of :func:`sliding_reduce` reports its bytes and
operations (``kernels.cost.window_reduce``) to an active
``obs.costmodel.analyze``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, cost, span
from repro_torch.kernels.window_reduce.ref import sliding_reduce_ref

F32_MIN = torch.finfo(torch.float32).min
F32_MAX = torch.finfo(torch.float32).max
_IDENT = {"sum": 0.0, "max": F32_MIN, "min": F32_MAX}
_OP_CODE = {"sum": 0, "max": 1, "min": 2}
#: each instance's code in the launcher's interface
INSTANCES = {"simple": 0, "span": 1}


def plan(d: int, window: int, stride: int, nw: int) -> span.SpanPlan:
    """The span instance's launch of ``nw`` windows over a contiguous
    ``[rows, d]`` block: shapes only, cached."""
    return span.plan(nw, d, d, window, stride, False)


def _lib() -> ctypes.CDLL:
    lib = build.library("window_reduce")
    if not lib.window_reduce_f32.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.window_reduce_f32.argtypes = [
            p, p, ctypes.c_longlong, i, i, i, i, i, i, i, i, i,
            ctypes.c_longlong, p]
        lib.window_reduce_f32.restype = ctypes.c_int
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def sliding_reduce(xp: torch.Tensor, window: int, stride: int, nw: int,
                   op: str, *, instance: str | None = None) -> torch.Tensor:
    """[rows, D] identity-filled f32 block -> [nw, D] reductions of the
    windows starting at 0, S, 2S, ...; the kernel on a CUDA tensor
    (``instance`` names it in place of the span instance), the plain
    version on a CPU tensor."""
    rows, d = xp.shape
    if xp.dtype != torch.float32:
        raise TypeError(f"window_reduce takes float32, got {xp.dtype}")
    if rows < (nw - 1) * stride + window:
        raise ValueError(f"block of {rows} rows is short of the last window")
    if instance is not None and instance not in INSTANCES:
        raise ValueError(f"window_reduce: instance {instance!r}, want one "
                         f"of {sorted(INSTANCES)}")
    with cost.counted("window_reduce", cost.window_reduce, d, window,
                      stride, nw):
        if not xp.is_cuda:
            return sliding_reduce_ref(xp, window, stride, nw, op)
        return _launch(xp.contiguous(), window, stride, nw, op,
                       instance or "span")


def _launch(xp: torch.Tensor, window: int, stride: int, nw: int, op: str,
            how: str) -> torch.Tensor:
    d = xp.shape[1]
    out = torch.empty((nw, d), dtype=torch.float32, device=xp.device)
    if nw * d == 0:
        return out
    p = plan(d, window, stride, nw) if how == "span" \
        else span.SpanPlan(0, 0, 0, 0, 0, 0)
    lib = _lib()
    err = lib.window_reduce_f32(
        xp.data_ptr(), out.data_ptr(), nw, d, window, stride, _OP_CODE[op],
        INSTANCES[how], p.k, p.tile_rows, p.pad, p.threads, p.smem_bytes,
        _stream(xp.device))
    build.check(lib, err, f"window_reduce {how} launch")
    window_reduce.launches += 1
    if how == "simple":
        window_reduce.simple_launches += 1
    return out


def window_reduce(x: torch.Tensor, valid: torch.Tensor, window: int,
                  stride: int, *, reducer: str = "sum", partial: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware windowed reduction: [T, D] -> ([NW, D], [NW] int32
    count).  Same contract as ``stream.windows.sliding_window``."""
    if not (0 < stride <= window):
        raise ValueError(f"need 0 < stride <= window, got {stride}, {window}")
    # imported here: stream.windows imports this module
    from repro_torch.stream.windows import _frame, num_windows
    t, d = x.shape
    nw = num_windows(t, window, stride, partial)
    valid = valid.to(torch.bool)
    # count via the shared framing ([T]-sized work, plain torch)
    _, mask = _frame(valid[:, None], valid, window, stride, partial)
    count = mask.sum(1, dtype=torch.int32)

    op = "sum" if reducer in ("sum", "mean", "count") else reducer
    if op not in _IDENT:
        raise ValueError(f"unknown reducer {reducer!r}")
    if reducer == "count":
        return count.to(x.dtype)[:, None].expand(nw, d).clone(), count

    xf = torch.where(valid[:, None], x.to(torch.float32), _IDENT[op])
    reach = (nw - 1) * stride + window       # last row any window touches
    if reach > t:
        xf = torch.cat([xf, xf.new_full((reach - t, d), _IDENT[op])])
    out = sliding_reduce(xf, window, stride, nw, op)
    if reducer == "mean":
        out = out / torch.clamp(count, min=1).to(torch.float32)[:, None]
    if op in ("max", "min"):
        out = torch.where(count[:, None] > 0, out, 0.0)
    return out.to(x.dtype), count


window_reduce.launches = 0
window_reduce.simple_launches = 0
