"""Hilbert space-filling-curve content routing (paper §IV-B, Fig. 2).

Port of ``repro.core.sfc``.  Profiles map to points of a
``2^order x 2^order`` grid, and points to the 1-D Hilbert index that
addresses Rendezvous Points.  Every function is bitwise the
reference's.

The reference computes in uint32.  Here a uint32 value is carried in
an int64 tensor, in ``[0, 2^32)``: shifts are then logical (an int32
``>>`` would be arithmetic), sums are masked back to 32 bits, and a
product with a 32-bit constant is split in 16-bit halves
(:func:`_mul32`) so that it never overflows the int64 before the mask.
Public functions take and return int32 tensors (uint32 bit patterns).

:func:`xy2d` dispatches on the tensor's device through
``kernels.hilbert.hilbert_xy2d``: a CUDA tensor launches the
``hilbert`` kernel, a CPU tensor runs the plain loop.  :func:`d2xy`
has no kernel and is plain torch.  :func:`interest_regions` is
host-side in the reference and returns numpy here too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import profiles as P
from repro_torch.kernels.hilbert import hilbert_xy2d

DEFAULT_ORDER = 16  # 2^16 x 2^16 grid -> 32-bit curve index

_MASK = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> its uint32 value (mod 2^32) as int64."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 value held in int64 -> the int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """``u * c mod 2^32`` for u in [0, 2^32) and a constant c < 2^32,
    without an int64 overflow: u * c_hi * 2^16 only matters mod 2^16."""
    lo, hi = c & 0xFFFF, c >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & _MASK


# ---------------------------------------------------------------------------
# 32-bit integer hash (the reference's uint32 math)
# ---------------------------------------------------------------------------

def _fmix(u: torch.Tensor) -> torch.Tensor:
    u = u ^ (u >> 16)
    u = _mul32(u, 0x85EBCA6B)
    u = u ^ (u >> 13)
    u = _mul32(u, 0xC2B2AE35)
    return u ^ (u >> 16)


def _combine(ua: torch.Tensor | int, ub: torch.Tensor) -> torch.Tensor:
    """``hash_combine`` on uint32 values (``ub`` is mixed here)."""
    ua = torch.as_tensor(ua, dtype=torch.int64, device=ub.device)
    return ua ^ ((_fmix(ub) + 0x9E3779B9 + ((ua << 6) & _MASK) + (ua >> 2))
                 & _MASK)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer; int32 in/out, wrap-around multiplies."""
    return _i32(_fmix(_u32(x)))


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-sensitive combiner (boost-style)."""
    return _i32(_combine(_u32(a), _u32(b)))


# ---------------------------------------------------------------------------
# Hilbert curve: (x, y) <-> d
# ---------------------------------------------------------------------------

def xy2d(x: torch.Tensor, y: torch.Tensor,
         order: int = DEFAULT_ORDER) -> torch.Tensor:
    """Hilbert index of grid points.  x, y: int32 in [0, 2^order);
    returns the int32 bit pattern of the uint32 index."""
    return hilbert_xy2d(x, y, order)


def d2xy(d: torch.Tensor, order: int = DEFAULT_ORDER
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`xy2d`."""
    t = _u32(d)
    x = torch.zeros_like(t)
    y = torch.zeros_like(t)
    for i in range(order):                        # s = 1, 2, 4, ...
        s = 1 << i
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        reflect = (ry == 0) & (rx == 1)
        x_r = torch.where(reflect, (s - 1 - x) & _MASK, x)
        y_r = torch.where(reflect, (s - 1 - y) & _MASK, y)
        swap = ry == 0
        x, y = torch.where(swap, y_r, x_r), torch.where(swap, x_r, y_r)
        x = (x + s * rx) & _MASK
        y = (y + s * ry) & _MASK
        t = t // 4
    return _i32(x), _i32(y)


# ---------------------------------------------------------------------------
# Profile -> point / regions on the curve
# ---------------------------------------------------------------------------

def profile_point(prof: torch.Tensor, order: int = DEFAULT_ORDER
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map encoded profiles [..., PROFILE_WIDTH] to 2-D grid coordinates.

    Dimension x = hash of the attribute keywords ("topic" axis).
    Dimension y = value axis: the first numeric value maps monotonically
    (so RANGE interests cover contiguous y intervals); keyword values
    map by hash.
    """
    prof = torch.as_tensor(prof).to(torch.int32)
    slots = prof.reshape(prof.shape[:-1] + (P.MAX_SLOTS, P.SLOT_WIDTH))
    used = slots[..., P.L_USED] > 0
    low = (1 << order) - 1
    # x: combine attr words of used slots (order-insensitive: sum of mixes)
    attr_mix = _fmix(_combine(_u32(slots[..., P.L_ATTR_A]),
                              _u32(slots[..., P.L_ATTR_B])))
    x_hash = torch.where(used, attr_mix, 0).sum(-1) & _MASK
    x = _i32(_fmix(x_hash) & low)
    # y: first numeric slot -> monotone map; else hash of value words
    vkind = slots[..., P.L_VKIND]
    is_num = (vkind == P.VK_NUM) & used
    has_num = is_num.any(-1)
    ar = torch.arange(P.MAX_SLOTS, device=prof.device)
    first_num = torch.where(is_num, ar, P.MAX_SLOTS).amin(-1)
    first_num = torch.where(has_num, first_num, 0)    # argmax of no True
    v_num = slots[..., P.L_V_A].gather(-1, first_num[..., None])[..., 0]
    y_num = _i32(_u32(v_num) & low)
    val_mix = _fmix(_combine(_u32(slots[..., P.L_V_A]),
                             _u32(slots[..., P.L_V_B])))
    y_hash = torch.where(used & (vkind != P.VK_NONE), val_mix, 0) \
        .sum(-1) & _MASK
    # fold the attribute hash in so value-less profiles still disperse on y
    y_hash = _combine(0x1B873593, _combine(x_hash, y_hash))
    y_hashed = _i32(_fmix(y_hash) & low)
    return x, torch.where(has_num, y_num, y_hashed)


def profile_index(prof: torch.Tensor,
                  order: int = DEFAULT_ORDER) -> torch.Tensor:
    """Simple-profile routing: profile -> Hilbert index (paper Fig 2a)."""
    x, y = profile_point(prof, order)
    return xy2d(x, y, order)


def interest_regions(prof_np: np.ndarray, order: int = DEFAULT_ORDER,
                     granularity: int = 4) -> np.ndarray:
    """Complex-profile routing (paper Fig 2b): wildcard/range interests
    cover a rectangle in (x, y) space; decompose it into Hilbert-curve
    segments at cell granularity ``2^(order-granularity)``.

    Returns [n_segments, 2] int64 (lo, hi) half-open index intervals,
    merged where adjacent.  Host-side (subscription time, not the data
    path): runs on CPU tensors.
    """
    prof_np = np.asarray(prof_np, np.int32)
    slots = prof_np.reshape(P.MAX_SLOTS, P.SLOT_WIDTH)
    used = slots[:, P.L_USED] > 0
    x, y = (int(v) for v in profile_point(torch.from_numpy(prof_np), order))
    x &= (1 << order) - 1
    # y interval: RANGE slot -> [lo, hi]; ANY/wildcard value -> full axis
    y_lo, y_hi = y & ((1 << order) - 1), y & ((1 << order) - 1)
    full_y = False
    for i in range(P.MAX_SLOTS):
        if not used[i]:
            continue
        vk = slots[i, P.L_VKIND]
        if vk == P.VK_RANGE:
            y_lo = int(slots[i, P.L_V_A]) & ((1 << order) - 1)
            y_hi = int(slots[i, P.L_V_B]) & ((1 << order) - 1)
        elif vk in (P.VK_ANY, P.VK_PREFIX):
            full_y = True
        if slots[i, P.L_AMASK_A] == 0 and slots[i, P.L_AMASK_B] == 0:
            full_y = True  # wildcard attribute -> whole axis
    if full_y:
        y_lo, y_hi = 0, (1 << order) - 1
    # decompose [x]x[y_lo, y_hi] into grid cells of side 2^(order - granularity)
    cell = 1 << max(order - granularity, 0)
    xs = np.array([x // cell], dtype=np.int64)
    ys = np.arange(y_lo // cell, y_hi // cell + 1, dtype=np.int64)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    # a whole cell is one contiguous Hilbert segment of length cell^2 at the
    # cell's own order (order - log2(cell)) scaled by cell^2
    sub_order = order - int(np.log2(cell)) if cell > 1 else order
    d_cell = xy2d(
        torch.from_numpy((gx.ravel() % (1 << sub_order)).astype(np.int32)),
        torch.from_numpy((gy.ravel() % (1 << sub_order)).astype(np.int32)),
        sub_order).numpy().astype(np.int64)
    seg_len = int(cell) * int(cell)
    lo = (d_cell.astype(np.uint64).astype(np.int64)) * seg_len
    segs = np.stack([lo, lo + seg_len], axis=1)
    segs = segs[np.argsort(segs[:, 0])]
    # merge adjacent
    merged = [segs[0]]
    for s in segs[1:]:
        if s[0] <= merged[-1][1]:
            merged[-1] = np.array([merged[-1][0], max(merged[-1][1], s[1])])
        else:
            merged.append(s)
    return np.stack(merged)


def index_to_rank(idx: torch.Tensor, num_ranks: int,
                  order: int = DEFAULT_ORDER) -> torch.Tensor:
    """Uniform partition of the curve index space across RP ranks, in
    the reference's uint32 arithmetic (its wrap included)."""
    u = _u32(idx)
    bits = 2 * order
    if bits <= 16:
        return _i32(_mul32(u, num_ranks) >> bits)
    # hi/lo split keeps floor(u * R / 2^bits) exact in uint32:
    # u = hi*2^h + lo  =>  floor(u*R/2^bits) = (hi*R + (lo*R >> h)) >> (bits - h)
    h = bits - 16
    hi, lo = u >> h, u & ((1 << h) - 1)
    rank = ((_mul32(hi, num_ranks) + (_mul32(lo, num_ranks) >> h))
            & _MASK) >> 16
    return _i32(rank)
