"""What each hand kernel's function must do: its bytes and operations.

One source for two readers: ``chip_smoke.py`` computes each kernel's
least time on the card from these counts (bytes over the memory rate
against operations over the peak rate of their type), and every kernel
wrapper reports them to an active ``obs.costmodel.analyze`` pass
(:func:`counted`), which cannot see inside a kernel launched through
``ctypes``.

Bytes count each input read once and each output written once.
Operations count the work the function needs on these inputs, not the
instructions a kernel compiles to.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.obs import costmodel

_NULL_CTX = contextlib.nullcontext()

#: One step of the Hilbert loop as the reference writes it
#: (``repro.core.sfc.xy2d``), the step's constants (s, s*s, s - 1) taken
#: out and no loop overhead: the two bit tests (an and and a compare
#: each: 4); d += s*s * ((3*rx) ^ ry) (a multiply, an xor, a multiply by
#: the power of two s*s, an add: 4); the reflect test (ry == 0) &
#: (rx == 1) (3; the swap reuses ry == 0); the reflect, two subtractions
#: and two selects (4); the swap, two selects (2).
HILBERT_OPS_PER_STEP = 17


def counted(name: str, counts, *args):
    """Context for one kernel wrapper's call: with an analysis active,
    it records ``counts(*args)`` (``(bytes, operations)``) as the call's
    cost and pauses the analysis's own counting inside (the plain
    version's torch ops on the CPU, the launch's allocations on the
    card), so a call costs the same on both devices.  Without one it is
    a shared null context."""
    an = costmodel.active()
    if an is None:
        return _NULL_CTX
    with an.pause():                     # the count's own torch ops
        nbytes, ops = counts(*args)
    return an.kernel(name, nbytes, ops)


def window_reduce(d: int, window: int, stride: int, nw: int
                  ) -> tuple[int, int]:
    """``nw`` sliding reductions of ``window`` rows at ``stride`` over a
    ``[rows, d]`` float32 block: the rows the windows reach are read,
    ``[nw, d]`` written; a window takes ``window - 1`` adds (or
    compares) a column."""
    reach = (nw - 1) * stride + window
    return 4 * (reach * d + nw * d), nw * d * (window - 1)


def fused_tick(t: int, cols: int, d: int, nw: int, window: int
               ) -> tuple[int, int]:
    """The fused tick over a ``[t, 1 + cols]`` float32 row block and its
    ``[t]`` bool mask: ``cols`` columns read (the ingest stamp and the
    ``d`` features), the mask, and ``[nw, d]`` aggregates, ``[nw, 5]``
    features and three ``[nw]`` outputs written; a window takes four
    operations a row a column (sum, max, min and the mask's select)."""
    return 4 * t * cols + t + 4 * nw * (d + 5 + 3), nw * cols * window * 4


def hilbert(n: int, order: int) -> tuple[int, int]:
    """``n`` int32 points (x, y) read, ``n`` indices written; ``order``
    loop steps a point."""
    return 12 * n, n * order * HILBERT_OPS_PER_STEP


def armatch_ops(data: torch.Tensor, interests: torch.Tensor) -> int:
    """int32 operations the match of ``data`` ``[M, 128]`` against
    ``interests`` ``[N, 128]`` needs on these inputs.  Only used slots
    are tested, and what depends on one slot alone is decoded once a
    slot, not once a pair:

    - a (used interest slot, used data slot) pair tests the attribute
      (two xors, two ands, an or, a compare to zero: 6) and ORs into the
      interest slot's ``sat`` (1); unless the interest slot is NONE it
      ANDs in a value test (1) whose own cost follows the interest
      slot's kind: EXACT two compares and two ands (4), PREFIX two xors,
      two ands, an or, a compare and an and (7), RANGE two compares and
      two ands (4), ANY none (the data slot's kind is decoded once).
      An interest slot of another kind never matches: no pair is tested;
    - a (data row, used interest slot) pair ANDs that slot's ``sat`` into
      the result (1); a (data row, interest) pair ANDs in "the interest
      has a used slot" (1);
    - decoding: three kind tests a used data slot (EXACT, NUM, not
      NONE), two a used interest slot (used, kind).

    The kernel tests all 8 x 8 slot pairs of every (row, interest) pair
    whatever is used, so this is the least work, not the kernel's.  It
    reads the profiles' used and kind lanes: a host transfer."""
    from repro_torch.core import profiles as P
    per_kind = {P.VK_NONE: 7, P.VK_EXACT: 12, P.VK_PREFIX: 15,
                P.VK_ANY: 8, P.VK_RANGE: 12}
    d = data.reshape(-1, P.MAX_SLOTS, P.SLOT_WIDTH)
    p = interests.reshape(-1, P.MAX_SLOTS, P.SLOT_WIDTH)
    u_d = int((d[..., P.L_USED] > 0).sum())
    p_used = p[..., P.L_USED] > 0
    u_p = int(p_used.sum())
    kind = p[..., P.L_VKIND]
    slot_pairs = sum(cost * int((p_used & (kind == k)).sum())
                     for k, cost in per_kind.items())
    m, n = d.shape[0], p.shape[0]
    return u_d * slot_pairs + m * u_p + m * n + 3 * u_d + 2 * u_p


def armatch(data: torch.Tensor, interests: torch.Tensor
            ) -> tuple[int, int]:
    """``[M, 128]`` and ``[N, 128]`` int32 profiles read, ``[M, N]``
    int32 written; :func:`armatch_ops` operations."""
    m, n = data.shape[0], interests.shape[0]
    return 4 * 128 * (m + n) + 4 * m * n, armatch_ops(data, interests)


def decode_attn(b: int, h: int, hkv: int, d: int, s: int, elem: int
                ) -> tuple[int, int]:
    """GQA decode of ``[b, h, d]`` queries over ``[b, s, hkv, d]`` K and
    V caches of ``elem``-byte elements and ``[b]`` int32 lengths: both
    caches and the queries read, ``[b, h, d]`` written; two products of
    ``d`` multiply-adds a (query head, cache row)."""
    return (2 * b * s * hkv * d * elem + 2 * b * h * d * elem + 4 * b,
            4 * b * h * s * d)
