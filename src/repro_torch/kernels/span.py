"""The launch plan of the span kernels (``csrc/span.cuh``): the span
instances of ``window_reduce`` and ``fused_tick`` stage K consecutive
kept windows' rows in shared memory and run the (window, column) chains
out of it.

:func:`plan` decides K, the grid, the threads, the rows staged at once,
the bank pad and the shared-memory bytes from shapes alone -- it reads
nothing from the card, so a tick that launches a span kernel keeps no
host sync -- and is cached, so a tick pays for it once a shape.  The
layout it sizes is the one ``span.cuh`` documents; the constants below
are that header's (``tests/test_torch_tick_plan.py`` holds them to it).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

#: threads a warp (``kWarp``)
WARP = 32
#: threads a block at most (``kMaxThreads``, the kernels' launch bounds)
MAX_THREADS = 256
#: shared memory a block can have on sm_90, 227 KB (``kSmemMax``), and
#: what it has without asking for more (``kSmemDefault``)
SMEM_MAX = 232448
SMEM_DEFAULT = 48 * 1024
#: floats reserved ahead of a tile for its 16-byte head (``kHeadFloats``)
HEAD_FLOATS = 4
#: blocks a launch aims for: two on each of an H100's 132 SMs, near enough
TARGET_BLOCKS = 256
#: shared memory a block stages at most, unless one row needs more: the
#: tick's spans take about 21 KB, and a tile this size leaves room for
#: four blocks an SM
TILE_BYTES = SMEM_DEFAULT
#: shared-memory banks of four bytes
BANKS = 32


class SpanPlan(NamedTuple):
    k: int              # kept windows a block
    blocks: int         # ceil(nw / k)
    threads: int        # whole warps, at most MAX_THREADS
    tile_rows: int      # rows staged at once (the whole span when it fits)
    pad: int            # floats after each group of `stride` staged rows
    smem_bytes: int     # dynamic shared memory a block


def tile_floats(rows: int, ld: int, stride: int, pad: int) -> int:
    """Floats of a staged tile, head and pads included, rounded to 16
    bytes (``span::tile_floats``)."""
    n = HEAD_FLOATS + rows * ld + pad * -(-rows // stride)
    return (n + 3) & ~3


def smem_bytes(rows: int, ld: int, stride: int, pad: int, mask: bool) -> int:
    """Bytes of a tile of ``rows`` rows, and of its mask words: one a 32
    rows, and one more (``span::smem_bytes``)."""
    words = (rows + 31) // 32 + 1 if mask else 0
    return 4 * (tile_floats(rows, ld, stride, pad) + words)


def bank_cost(k: int, chains_per_window: int, ld: int, stride: int,
              pad: int, threads: int) -> int:
    """Shared-memory wavefronts of one sweep step over a block's first
    ``threads`` chains: for each warp, the most lanes that read one bank
    (every lane reads another address).  Window ``kk``'s column ``j``
    lies ``kk * (stride * ld + pad) + j`` floats from window 0's column
    0, whatever the step."""
    chains = min(k * chains_per_window, threads)
    cost = 0
    for w0 in range(0, chains, WARP):
        banks: dict[int, int] = {}
        for c in range(w0, min(w0 + WARP, chains)):
            kk, j = divmod(c, chains_per_window)
            b = (kk * (stride * ld + pad) + j) % BANKS
            banks[b] = banks.get(b, 0) + 1
        cost += max(banks.values())
    return cost


@functools.lru_cache(maxsize=256)
def plan(nw: int, chains_per_window: int, ld: int, window: int, stride: int,
         mask: bool) -> SpanPlan:
    """The launch of ``nw`` kept windows (starts 0, S, 2S, ...) of
    ``window`` rows over a row-major block of row stride ``ld`` floats,
    ``chains_per_window`` columns a window, with or without a row mask.

    * K: enough blocks to fill the card (``nw // TARGET_BLOCKS``, 8 at
      the tick's 2,048 windows, whatever the width: at d = 1 a block's
      8 chains take one warp, and 256 blocks wait on 256 copies of 1 KB
      where 64 of 4 KB took longer), at most ``MAX_THREADS`` chains a
      block where a window has fewer columns, and a span that fits
      ``TILE_BYTES`` where one window's does;
    * the pad (0, 4, ..., 28 floats a group) with the fewest bank
      conflicts in a step, the smallest of equals;
    * the whole span staged at once where it fits ``TILE_BYTES``, else
      tiles of whole stride groups (or of rows, when one group is too
      large); raises if a single row does not fit the SM."""
    if nw < 1 or chains_per_window < 1 or not 0 < stride <= window \
            or ld < chains_per_window:
        raise ValueError(f"span plan: nw {nw}, {chains_per_window} chains "
                         f"a window, ld {ld}, window {window}, "
                         f"stride {stride}")
    l = chains_per_window
    k = max(nw // TARGET_BLOCKS, 1)
    k = min(k, max(1, MAX_THREADS // l), nw)
    while k > 1 and smem_bytes((k - 1) * stride + window, ld, stride, 28,
                               mask) > TILE_BYTES:
        k -= 1
    threads = min(-(-k * l // WARP) * WARP, MAX_THREADS)
    pad = min(range(0, 32, 4),
              key=lambda p: (bank_cost(k, l, ld, stride, p, threads), p))
    rows = (k - 1) * stride + window
    tile = rows
    if smem_bytes(rows, ld, stride, pad, mask) > TILE_BYTES:
        lo, hi = 1, rows            # the most rows that fit, or 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if smem_bytes(mid, ld, stride, pad, mask) <= TILE_BYTES:
                lo = mid
            else:
                hi = mid - 1
        tile = lo - lo % stride if lo >= stride else lo
    smem = smem_bytes(tile, ld, stride, pad, mask)
    if smem > SMEM_MAX:
        raise ValueError(f"span plan: a row of {ld} floats needs {smem} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    return SpanPlan(k=k, blocks=-(-nw // k), threads=threads, tile_rows=tile,
                    pad=pad, smem_bytes=smem)
