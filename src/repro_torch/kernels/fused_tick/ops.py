"""Wrapper for the ``fused_tick`` kernel: the executor's whole
window / features / rules contract over one ring-row block.

Contract of ``repro.kernels.fused_tick.ops.fused_tick``:

* input is the executor's carry-continuous block ``seq``
  (``[T, meta_cols + D]`` rows of ``ts | ingest_wall | features``);
  the columns past the event timestamp ride one sweep, so the lineage
  birth ``min`` of the wall column costs no extra framing,
* complete windows only: ``NW = (T - window)//stride + 1``,
* returns ``(agg [NW, D] mean aggregate, wcount [NW] int32, feats
  [NW, 5] rule features of the signal column, w_birth [NW] oldest
  ingest stamp, cons [NW] int32 consequences, C_NONE below
  min_count)``.

The CUDA kernel reads ``seq`` in place (row stride and a one-column
offset), computes only the kept windows, and writes these outputs
itself, so the TPU wrapper's padding and slicing have no counterpart.
Dispatch follows the tensor's device: a CUDA tensor launches
``csrc/fused_tick.cu`` (or raises), a CPU tensor takes ``ref.py``.
:func:`plan` sizes the ``span`` instance, which stages K windows' rows
in shared memory a block (``kernels/span.py``); the ``simple`` instance
(the first port's kernel) runs only when asked for by name, to hold the
other against it.  Each call is one launch: ``fused_tick.launches``
counts them all, ``fused_tick.simple_launches`` those of the simple
instance.  A launch inside a captured CUDA graph (``runtime.capture``)
is counted at each replay: the capture records what the counters gained
and adds it again.  Each call reports its bytes and operations
(``kernels.cost.fused_tick``) to an active ``obs.costmodel.analyze``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, cost, span
from repro_torch.kernels.fused_tick.ref import fused_tick_ref

MAX_RULES = 16                    # RuleTable capacity in csrc/fused_tick.cu
_CMP_CODE = {">=": 0, ">": 1, "<=": 2, "<": 3, "==": 4}
#: each instance's code in the launcher's interface
INSTANCES = {"simple": 0, "span": 1}


def plan(t: int, ld: int, window: int, stride: int) -> span.SpanPlan:
    """The span instance's launch over a ``[t, ld]`` row block (columns
    1 .. ld-1 reduced, a row mask): shapes only, cached."""
    return span.plan((t - window) // stride + 1, ld - 1, ld, window, stride,
                     True)


class _RuleRow(ctypes.Structure):
    _fields_ = [("feature", ctypes.c_int), ("op", ctypes.c_int),
                ("value", ctypes.c_float), ("code", ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    lib = build.library("fused_tick")
    if not lib.fused_tick_f32.argtypes:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_tick_f32.argtypes = [
            p, ctypes.c_longlong, p, ctypes.c_longlong, i, i, i, i, i, p, i,
            ctypes.c_float, p, p, p, p, p, i, i, i, i, i, ctypes.c_longlong,
            p]
        lib.fused_tick_f32.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def _rule_rows(table):
    """The table as a ctypes ``RuleRow`` array, built once per table
    (the launcher copies it into the kernel's by-value argument)."""
    if len(table) > MAX_RULES:
        raise ValueError(f"fused_tick takes at most {MAX_RULES} rules, "
                         f"got {len(table)}")
    rows = (_RuleRow * len(table))()
    for k, (fi, op, value, code) in enumerate(table):
        if not 0 <= fi < 5 or op not in _CMP_CODE:
            raise ValueError(f"bad rule row {(fi, op, value, code)}")
        # ctypes.c_float rounds the python float to float32: the kernel
        # compares in float, as the JAX reference does
        rows[k] = _RuleRow(fi, _CMP_CODE[op], value, code)
    return rows


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(seq, valid, window, stride, rows, min_count, meta_cols, nw, d,
            instance=None):
    if seq.dtype != torch.float32:
        raise TypeError(f"fused_tick takes float32 rows, got {seq.dtype}")
    seq = seq.contiguous()
    # the kernel reads the bool mask's bytes as they are: no
    # conversion kernel on the tick
    valid = valid.to(torch.bool).contiguous().view(torch.uint8)
    dev = seq.device
    l = seq.shape[1] - 1
    agg = torch.empty((nw, d), dtype=torch.float32, device=dev)
    feats = torch.empty((nw, 5), dtype=torch.float32, device=dev)
    wcount = torch.empty((nw,), dtype=torch.int32, device=dev)
    w_birth = torch.empty((nw,), dtype=torch.float32, device=dev)
    cons = torch.empty((nw,), dtype=torch.int32, device=dev)
    how = instance or "span"
    p = plan(seq.shape[0], seq.shape[1], window, stride) if how == "span" \
        else span.SpanPlan(0, 0, 0, 0, 0, 0)
    lib = _lib()
    err = lib.fused_tick_f32(
        seq.data_ptr(), seq.shape[1], valid.data_ptr(), nw, l, meta_cols - 1,
        d, window, stride, ctypes.addressof(rows), len(rows),
        float(min_count), agg.data_ptr(), feats.data_ptr(), wcount.data_ptr(),
        w_birth.data_ptr(), cons.data_ptr(), INSTANCES[how], p.k,
        p.tile_rows, p.pad, p.threads, p.smem_bytes, _stream(dev))
    build.check(lib, err, f"fused_tick {how} launch")
    fused_tick.launches += 1
    if how == "simple":
        fused_tick.simple_launches += 1
    return agg, wcount, feats, w_birth, cons


def fused_tick(seq: torch.Tensor, seq_valid: torch.Tensor, window: int,
               stride: int, *, table, min_count: int = 1,
               meta_cols: int = 2, instance: str | None = None):
    """Fused window + features + rules over one ring-row block; the
    kernel on a CUDA tensor (``instance`` names it in place of the span
    instance), the plain version on a CPU tensor."""
    if table is None:
        raise ValueError(
            "fused tick needs a tabular RuleEngine (threshold_rule-style "
            "rules only): RuleEngine.table() returned None -- use the "
            "staged path (StreamConfig(fused=False)) for callable rules")
    if not (0 < stride <= window):
        raise ValueError(f"need 0 < stride <= window, got {stride}, {window}")
    if instance is not None and instance not in INSTANCES:
        raise ValueError(f"fused_tick: instance {instance!r}, want one of "
                         f"{sorted(INSTANCES)}")
    table = tuple(tuple(r) for r in table)
    rows = _rule_rows(table)                    # validates on every device
    t = seq.shape[0]
    d = seq.shape[1] - meta_cols
    nw = (t - window) // stride + 1             # complete windows only
    if nw < 1:
        raise ValueError(f"need t >= window, got {t} < {window}")
    with cost.counted("fused_tick", cost.fused_tick, t, seq.shape[1] - 1,
                      d, nw, window):
        if seq.is_cuda:
            return _launch(seq, seq_valid, window, stride, rows, min_count,
                           meta_cols, nw, d, instance)
        return fused_tick_ref(seq, seq_valid, window, stride, table,
                              min_count=min_count, meta_cols=meta_cols)


fused_tick.launches = 0
fused_tick.simple_launches = 0
