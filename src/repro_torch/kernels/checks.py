"""Each hand-written kernel held against its plain version, bitwise.

One copy of the comparisons that ``chip_smoke.py`` (phase 2) and
``tests/test_torch_card.py`` run on the card.  Each check takes the
full-width block ``(t, d, window, stride)`` of a tick and adds ragged
small shapes; every block carries NaN rows and a run of invalid rows
long enough to empty whole windows.  On a CUDA device each kernel
call is also held against the same call on the CPU, and must raise
its wrapper's launch count by one.  Both checks return the largest
finite absolute difference seen (0.0 when bitwise equal).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_tick import fused_tick, fused_tick_ref
from repro_torch.kernels.window_reduce import (sliding_reduce,
                                               sliding_reduce_ref,
                                               window_reduce)
from repro_torch.kernels.window_reduce.ops import _IDENT
from repro_torch.testing import assert_bitwise

#: (t, d, window, stride, partial) besides the full-width block
WINDOW_REDUCE_RAGGED = ((37, 3, 8, 3, True), (1000, 5, 16, 16, True),
                        (9, 1, 8, 8, True), (9, 130, 8, 8, True))
#: (t, d, window, stride) besides the full-width block
FUSED_TICK_RAGGED = ((40, 3, 16, 8), (33, 1, 8, 5), (16, 130, 8, 8))

#: every comparison op, a value that is not exact in float32 (0.7), and
#: all five feature columns, lowest precedence first
TICK_TABLE = ((4, "<", 6.0, 1), (0, ">=", 0.7, 2), (2, "<=", -0.7, 4),
              (3, ">", 2.5, 5), (1, "==", 0.0, 3), (1, ">", 1.3, 3))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not both.any():
        return 0.0
    return float((a - b).abs()[both].max())


def block(gen, t, d, device, nan_rows=3, dead=(10, 80)):
    """[T, D] normals with NaN rows and a stretch of invalid rows long
    enough to empty whole windows."""
    x = torch.randn((t, d), generator=gen, device=device)
    x[torch.randint(0, t, (nan_rows,), generator=gen, device=device),
      d // 2] = float("nan")
    valid = torch.rand((t,), generator=gen, device=device) < 0.8
    valid[dead[0]:min(t, dead[1])] = False
    return x, valid


def _counted(fn, counter, x: torch.Tensor, what: str):
    """``fn()``, checking that it launched the kernel once on a CUDA
    tensor (and not at all on a CPU one)."""
    before = counter.launches
    out = fn()
    if counter.launches != before + int(x.is_cuda):
        raise AssertionError(f"{what}: {counter.launches - before} kernel "
                             f"launches, want {int(x.is_cuda)}")
    return out


def check_window_reduce(device, t, d, window, stride) -> float:
    """The ``window_reduce`` kernel against ``sliding_reduce_ref`` for
    sum/max/min, and the wrapper's five reducers against the CPU."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(1)
    err = 0.0
    for t, d, w, s, partial in ((t, d, window, stride, False),
                                *WINDOW_REDUCE_RAGGED):
        x, valid = block(gen, t, d, dev)
        if dev.type == "cuda":
            for reducer in ("sum", "mean", "max", "min", "count"):
                got = window_reduce(x, valid, w, s, reducer=reducer,
                                    partial=partial)
                cpu = window_reduce(x.cpu(), valid.cpu(), w, s,
                                    reducer=reducer, partial=partial)
                for a, b, name in zip(got, cpu, ("out", "count")):
                    assert_bitwise(a, b, f"window_reduce {reducer} {t}x{d} "
                                         f"{name} card vs CPU")
        nw = -(-t // s) if partial else (t - w) // s + 1
        reach = (nw - 1) * s + w
        for op in ("sum", "max", "min"):
            xf = torch.where(valid[:, None], x, _IDENT[op])
            if reach > t:
                xf = torch.cat([xf, xf.new_full((reach - t, d), _IDENT[op])])
            k = _counted(lambda: sliding_reduce(xf, w, s, nw, op),
                         window_reduce, xf, f"window_reduce {op} {t}x{d}")
            p = sliding_reduce_ref(xf, w, s, nw, op)
            assert_bitwise(k, p, f"window_reduce kernel {op} {t}x{d}")
            err = max(err, max_abs_err(k, p))
    return err


def check_fused_tick(device, t, d, window, stride) -> float:
    """The ``fused_tick`` kernel against ``fused_tick_ref`` (and the
    CPU) with :data:`TICK_TABLE` and ``min_count`` 1 and 5; ``d`` is the
    feature count, the block has ``2 + d`` columns."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(2)
    err, fired = 0.0, set()
    for t, d, w, s in ((t, d, window, stride), *FUSED_TICK_RAGGED):
        x, valid = block(gen, t, d + 1, dev)
        seq = torch.cat([torch.arange(t, device=dev, dtype=torch.float32)
                         [:, None], x], dim=1)
        for min_count in (1, 5):
            k = _counted(lambda: fused_tick(seq, valid, w, s,
                                            table=TICK_TABLE,
                                            min_count=min_count),
                         fused_tick, seq, f"fused_tick {t}x{d}")
            p = fused_tick_ref(seq, valid, w, s, TICK_TABLE,
                               min_count=min_count)
            c = fused_tick(seq.cpu(), valid.cpu(), w, s, table=TICK_TABLE,
                           min_count=min_count)
            for name, a, b, h in zip(("agg", "wcount", "feats", "w_birth",
                                      "cons"), k, p, c):
                assert_bitwise(a, b, f"fused_tick kernel {t}x{d} {name}")
                assert_bitwise(a, h, f"fused_tick {t}x{d} {name} card vs CPU")
                err = max(err, max_abs_err(a, b))
            fired.update(torch.unique(k[4]).tolist())
    if len(fired) < 4:
        raise AssertionError(f"fused_tick: consequences {sorted(fired)}, "
                             "table untested")
    return err
