"""Fixed-shape window operators for edge stream analytics.

Port of ``repro.stream.windows``.  Every operator is a function of
fixed-shape tensors; ragged reality (partial tail windows, underruns,
late data) rides boolean masks, not shapes.

Conventions
-----------
* A stream block is ``x: [T, D]`` samples with ``valid: [T]`` bool.
* Window starts are ``0, stride, 2*stride, ...`` -- ``ceil(T / stride)``
  windows (``partial=True``, tails masked) or complete windows only
  (``partial=False``, the executor's framing).
* Reducers are mask-aware: ``sum``/``mean``/``max``/``min``/``count``
  built in, or any callable ``(vals [N, W, D], mask [N, W]) -> [N, D]``.

The built-in reducers of :func:`sliding_window` go through
``kernels.window_reduce`` on every device: its hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor.  Sums accumulate left
to right (:func:`_seq_combine`): ``torch.sum`` over a dimension adds in
another order and would not be bitwise the reference.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.kernels.window_reduce import window_reduce

Reducer = Union[str, Callable]

#: feature columns produced by :func:`window_features`
F_MEAN, F_MAX, F_MIN, F_SUM, F_COUNT = range(5)

F32_MIN = torch.finfo(torch.float32).min
F32_MAX = torch.finfo(torch.float32).max


def window_feature_names() -> tuple[str, ...]:
    return ("mean", "max", "min", "sum", "count")


def num_windows(t: int, window: int, stride: int,
                partial: bool = True) -> int:
    """Windows over a [T] block: ceil(T/stride) with ``partial``, else
    only those fully inside [0, T)."""
    if t <= 0 or stride <= 0:
        raise ValueError(f"need t > 0 and stride > 0, got {t}, {stride}")
    if partial:
        return -(-t // stride)
    if t < window:
        raise ValueError(f"partial=False needs t >= window, got {t} < {window}")
    return (t - window) // stride + 1


def _frame(x: torch.Tensor, valid: torch.Tensor, window: int, stride: int,
           partial: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, D] -> ([NW, W, D] values, [NW, W] mask); tail padded invalid."""
    t = x.shape[0]
    nw = num_windows(t, window, stride, partial)
    reach = (nw - 1) * stride + window          # last row any window touches
    pad = max(0, reach - t)
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    starts = torch.arange(nw, device=x.device) * stride
    idx = starts[:, None] + torch.arange(window, device=x.device)[None, :]
    return x[idx], valid[idx]


def _seq_combine(masked: torch.Tensor, combine) -> torch.Tensor:
    """Reduce [N, W, D] over dim 1 by sequential left-to-right
    accumulation -- the op order of the window kernels."""
    acc = masked[:, 0]
    for w in range(1, masked.shape[1]):
        acc = combine(acc, masked[:, w])
    return acc


def sliding_window(x: torch.Tensor, valid: torch.Tensor, window: int,
                   stride: int, *, reducer: Reducer = "mean",
                   partial: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window reduction over a stream block.

    x: [T, D]; valid: [T] bool.  Returns (out [NW, D], count [NW]
    int32); fully-masked windows give 0 rows and count 0.  Built-in
    reducers run ``kernels.window_reduce`` (the Hopper kernel on a CUDA
    tensor); callables run on the framed block.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be [T, D], got {tuple(x.shape)}")
    if not (0 < stride <= window):
        raise ValueError(f"need 0 < stride <= window, got {stride}, {window}")
    valid = valid.to(torch.bool)
    if not callable(reducer):
        return window_reduce(x, valid, window, stride, reducer=reducer,
                             partial=partial)
    vals, mask = _frame(x, valid, window, stride, partial)
    return reducer(vals, mask), mask.sum(1, dtype=torch.int32)


def tumbling_window(x: torch.Tensor, valid: torch.Tensor, window: int, *,
                    reducer: Reducer = "mean"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Non-overlapping windows (stride == window); partial tail masked."""
    return sliding_window(x, valid, window, window, reducer=reducer)


def window_features(x: torch.Tensor, valid: torch.Tensor, window: int,
                    stride: int, partial: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-window rule-engine features over the *first* data column.

    Returns ([NW, 5] features -- mean, max, min, sum, count of
    ``x[:, 0]`` -- and [NW] int32 count).  The sum, max and min are
    three ``sliding_window`` reductions of the signal column (the
    window kernel on the card); max and min do not depend on the
    order, and the sum adds left to right as the reference does.
    """
    sig = x[:, :1]                               # [T, 1] signal column
    s, count = sliding_window(sig, valid, window, stride, reducer="sum",
                              partial=partial)
    mx, _ = sliding_window(sig, valid, window, stride, reducer="max",
                           partial=partial)
    mn, _ = sliding_window(sig, valid, window, stride, reducer="min",
                           partial=partial)
    cf = torch.clamp(count, min=1).to(x.dtype)[:, None]
    feats = torch.cat([s / cf, mx, mn, s, count.to(x.dtype)[:, None]],
                      dim=-1)
    return feats, count


def session_window(x: torch.Tensor, valid: torch.Tensor, ts: torch.Tensor,
                   gap: float, *, reducer: Reducer = "mean"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gap-based session windows on fixed shapes.

    x: [T, D]; valid: [T] bool; ts: [T] event timestamps; a new session
    starts wherever the time since the previous valid sample exceeds
    ``gap``.  Row ``k`` of the output is the k-th session by start time.

    Returns (out [T, D] reduced aggregates, count [T] int32 samples per
    session -- 0 past the last session, closed [T] bool -- sessions
    already followed by a gap inside this block).  Segment sums use
    ``index_add_``, which on a CUDA tensor adds in no fixed order:
    bitwise equality with the reference holds on the CPU.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be [T, D], got {tuple(x.shape)}")
    t = x.shape[0]
    dev = x.device
    valid = valid.to(torch.bool)
    fts = ts.to(torch.float32)
    order = torch.argsort(torch.where(valid, fts, float("inf")), stable=True)
    xs, vs, tss = x[order], valid[order], fts[order]
    prev = torch.cat([torch.full((1,), float("-inf"), device=dev), tss[:-1]])
    prev_valid = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                            vs[:-1]])
    new_sess = vs & ((tss - prev > gap) | ~prev_valid)
    sid = torch.cumsum(new_sess.to(torch.int32), 0, dtype=torch.int32) - 1
    seg = torch.where(vs, sid, t).long()        # invalid -> dropped segment

    def segment_sum(v):                         # segment t is dropped
        out = v.new_zeros((t + 1,) + v.shape[1:])
        return out.index_add_(0, seg, v)[:t]

    count = segment_sum(vs.to(torch.int32))
    if callable(reducer):
        member = (seg[None, :] == torch.arange(t, device=dev)[:, None]) \
            & vs[None, :]
        out = reducer(xs[None].expand((t,) + xs.shape), member)
    elif reducer == "count":
        out = count.to(x.dtype)[:, None].expand(t, x.shape[1]).clone()
    elif reducer in ("sum", "mean"):
        out = segment_sum(torch.where(vs[:, None], xs, 0.0))
        if reducer == "mean":
            out = out / torch.clamp(count, min=1)[:, None].to(x.dtype)
    elif reducer in ("max", "min"):
        fill = F32_MIN if reducer == "max" else F32_MAX
        src = torch.where(vs[:, None], xs, fill)
        r = x.new_zeros((t + 1,) + x.shape[1:]).scatter_reduce_(
            0, seg[:, None].expand_as(src),
            src, "amax" if reducer == "max" else "amin", include_self=False)
        out = torch.where(count[:, None] > 0, r[:t], 0.0)
    else:
        raise ValueError(f"unknown reducer {reducer!r}")
    n_sess = new_sess.sum(dtype=torch.int32)
    closed = torch.arange(t, dtype=torch.int32, device=dev) < n_sess - 1
    return out, count, closed


def apply_watermark(ts: torch.Tensor, valid: torch.Tensor,
                    max_ts: torch.Tensor, lateness: float,
                    exempt: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Event-time watermark with bounded lateness.

    Samples older than ``max_ts - lateness`` (the watermark as of the
    block's arrival) are late and masked out.  ``exempt`` rows skip the
    late test and do not advance the max (replay/backfill).  Returns
    (valid', n_late, new_max_ts).
    """
    valid = valid.to(torch.bool)
    live = valid if exempt is None else valid & ~exempt
    info = torch.finfo(ts.dtype) if ts.dtype.is_floating_point \
        else torch.iinfo(ts.dtype)         # integer tick timestamps work too
    late = live & (ts < max_ts - lateness)
    new_max = torch.maximum(max_ts, torch.where(live, ts, info.min).amax())
    return valid & ~late, late.sum(dtype=torch.int32), new_max
