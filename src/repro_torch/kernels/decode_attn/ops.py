"""Wrapper for the ``decode_attn`` kernel: one new token a sequence
against its KV cache (GQA flash-decode).

Contract of ``repro.kernels.decode_attn.ops.decode_attention``: q
``[B, H, D]``, the caches ``[B, S, Hkv, D]``, ``lengths`` ``[B]``
valid cache rows (read as at most S), ``H = Hkv * G``; query head ``h``
attends to KV head ``h // G``.  Returns ``[B, H, D]`` in q's dtype,
computed in float32 with q scaled by ``1/sqrt(D)``; a row of length 0
gives zeros.  The TPU wrapper swaps the caches to ``[B, Hkv, S, D]``
and pads S to whole 512-row blocks behind a 0/-inf bias row, two
copies of the cache a call.  The CUDA kernel reads the caches in
place, in their own layout (any strides, D contiguous), and masks by
``lengths`` itself: no bias tensor, no padding, no copy.

Dispatch follows the tensor's device: a CUDA tensor launches
``csrc/decode_attn.cu`` (or raises), a CPU tensor takes the plain
version in ``ref.py``.  :func:`plan` picks the kernel's instance from
the shapes, strides, dtype and alignment alone, never from ``lengths``,
so a call reads nothing back from the card.  Each call is one launch:
``decode_attention.launches`` counts them all,
``decode_attention.generic_launches`` those that took the generic
instance.  A launch inside a captured CUDA graph (``runtime.capture``)
is counted at each replay: the capture records what the counters gained
and adds it again.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

#: the generic instance's limits (csrc/decode_attn.cu): float32
#: accumulators of a block's G query rows, 16 a thread of 256, and the
#: head width
MAX_GROUP_WIDTH = 16 * 256
MAX_HEAD_DIM = 256
#: the fast instances (csrc/decode_attn.cu, whose launcher checks the
#: same limits): head widths compiled for each dtype, the most query rows
#: a KV head (two MMA tiles of 8), the cache rows a warp takes at a time
#: (S is dealt to the splits in units of that a warp of the block, or
#: one tile at bf16 D 256: :func:`unit_rows`), and the most splits a
#: (b, KV head): they run as one thread-block cluster, and 8 is the
#: portable cluster size
FAST_HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
                  torch.float32: (16, 32, 64, 128)}
MAX_FAST_GROUP = 16
SUB_ROWS = 16
MAX_SPLITS = 8
#: the bf16 D 256 instance (``kD256Warps``, ``kD256Stages`` in the
#: source): 8 warps in two groups of 4 that take every other 16-row
#: tile, and a ring of 6 tiles of K and V
D256_WARPS = 8
D256_STAGES = 6
#: the most shared memory a block may have on an H100
SMEM_MAX = 232448
#: the H100's SM count, for a plan made without a card
H100_SMS = 132
#: clusters of n = 1 .. 8 blocks of the bf16 D 256 instance (one block
#: an SM) that an H100 holds at once, as ``cudaOccupancyMaxActiveClusters``
#: gives them on an NVIDIA H100 80GB HBM3 (``tools/decode_attn_explore.py``):
#: its GPCs leave no room for a 16th cluster of 7 or 8
H100_D256_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)


def unit_rows(dtype: torch.dtype, d: int) -> int:
    """Cache rows of a unit of the splits: :data:`SUB_ROWS` a warp of
    the block (bf16 8 warps, float32 4; their rings fill most of an SM's
    shared memory, one block an SM), but one tile of :data:`SUB_ROWS` at
    bf16 D 256, whose groups of warps take every other tile."""
    if dtype == torch.bfloat16:
        return SUB_ROWS if d == 256 else SUB_ROWS * 8
    return SUB_ROWS * 4


def d256_smem_bytes() -> int:
    """Shared memory a block of the bf16 D 256 instance asks for, as
    ``D256Smem`` in the source sums it: 1,024 bytes to align the ring,
    the ring (K and V, 16 rows of 256 bf16 a tile, swizzled), q (16 rows
    of 256 + 8 bf16), the block's partial (m and l, 16 floats each, acc
    16 rows of 260 floats), an 8-byte mbarrier a ring slot and the
    inbox's (rounded to 16 bytes), the score shares (a float4 a lane,
    n-tile and warp, two buffers) and the inbox of the splits' partials
    (m and l for 8 splits, and each split's slice of acc at the split
    count that needs the most).  It does not depend on the plan."""
    row = 2 * (256 + 8)
    inbox = 2 * MAX_SPLITS * 16 + max(n * 16 * 4 * -(-64 // n)
                                      for n in range(2, MAX_SPLITS + 1))
    return (1024 + D256_STAGES * 2 * SUB_ROWS * 2 * 256 + 16 * row
            + 4 * 16 * (2 + 256 + 4) + 8 * (D256_STAGES + 2)
            + 16 * 2 * D256_WARPS * 2 * 32 + 4 * inbox)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How one call runs: ``instance`` is ``"generic"`` or
    ``"<bf16|f32>_d<D>"``; ``n_split`` blocks a (b, KV head), one
    cluster, which share S's units of :func:`unit_rows` rows evenly
    (:func:`split_starts`) and fold their partials in the cluster's
    shared memory: the call needs no scratch in device memory."""
    instance: str
    n_split: int


def plan(b: int, h: int, hkv: int, d: int, s: int,
         k_strides: tuple[int, ...], v_strides: tuple[int, ...],
         dtype: torch.dtype, aligned: bool = True,
         sms: int = H100_SMS,
         d256_clusters: tuple[int, ...] = H100_D256_CLUSTERS) -> Plan:
    """The launch plan of a call with q ``[b, h, d]`` and caches
    ``[b, s, hkv, d]`` of element strides ``k_strides`` /
    ``v_strides`` (the first three; D is contiguous) on a card of
    ``sms`` SMs; ``aligned`` says the caches' base addresses are
    16-byte aligned.  A fast instance needs D among
    :data:`FAST_HEAD_DIMS`, G at most :data:`MAX_FAST_GROUP`, and
    16-byte base and strides (its copies move 16 bytes); anything else
    takes the generic instance.  The split count fills one wave of one
    block an SM, at most one split a unit (:func:`unit_rows`) and
    :data:`MAX_SPLITS`; at bf16 D 256 it is the most splits whose
    ``b x hkv`` clusters the card holds at once (``d256_clusters[n -
    1]`` clusters of ``n``): a cluster that has to wait for another to
    leave doubles the call."""
    g = h // hkv
    strides_ok = all(st * dtype.itemsize % 16 == 0
                     for st in (*k_strides[:3], *v_strides[:3]))
    if d in FAST_HEAD_DIMS.get(dtype, ()) and g <= MAX_FAST_GROUP \
            and aligned and strides_ok:
        units = max(1, -(-s // unit_rows(dtype, d)))
        n_split = max(1, min(units, MAX_SPLITS, sms // (b * hkv)))
        if dtype == torch.bfloat16 and d == 256:
            n_split = max((n for n in range(1, min(units, MAX_SPLITS) + 1)
                           if b * hkv <= d256_clusters[n - 1]), default=1)
        name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        return Plan(f"{name}_d{d}", n_split)
    return Plan("generic", 1)


def split_starts(s: int, n_split: int, unit: int) -> list[int]:
    """The first cache row of each split, and S: split ``i`` takes the
    units of ``unit`` rows ``[i * units // n, (i + 1) * units // n)``."""
    units = max(1, -(-s // unit))
    return [min(i * units // n_split * unit, s) for i in range(n_split)] \
        + [s]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _d256_clusters(index: int) -> tuple[int, ...]:
    """:data:`H100_D256_CLUSTERS` as card ``index`` gives them."""
    with torch.cuda.device(index):
        return tuple(kernel_attrs(torch.bfloat16, 256, MAX_FAST_GROUP,
                                  Plan("bf16_d256", n))["clusters"]
                     for n in range(1, MAX_SPLITS + 1))


def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attn")
    if not lib.decode_attn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attn.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                    ll, ll, ll, ll, ll, ll,
                                    ctypes.c_float, i, i, i, p]
        lib.decode_attn.restype = ctypes.c_int
        lib.decode_attn_attrs.argtypes = [i, i, i, i, i,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.decode_attn_attrs.restype = ctypes.c_int
    return lib


def kernel_attrs(dtype: torch.dtype, d: int, g: int, how: Plan) -> dict:
    """What the card's compiler made of the kernel that ``how`` launches
    at head width ``d`` and ``g`` query rows a KV head: its registers a
    thread and local (spill) bytes a thread (``cudaFuncGetAttributes``),
    its warps a block, the dynamic shared memory a block asks for, and
    the clusters of ``how.n_split`` blocks the card holds at once
    (``cudaOccupancyMaxActiveClusters``).  Needs the card."""
    lib = _lib()
    out = (ctypes.c_int * 5)()
    err = lib.decode_attn_attrs(_DTYPES[dtype], d, g,
                                0 if how.instance == "generic" else 1,
                                how.n_split, out)
    build.check(lib, err, f"decode_attn attributes ({how.instance})")
    return dict(registers=out[0], local_bytes=out[1], warps=out[2],
                smem_bytes=out[3], clusters=out[4])


def _check(q, k_cache, v_cache, lengths, hkv) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}; "
                         "want [B, H, D] and [B, S, Hkv, D]")
    b, h, d = q.shape
    if k_cache.shape[0] != b or k_cache.shape[2] != hkv \
            or k_cache.shape[3] != d or h % hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} against "
                         f"caches {tuple(k_cache.shape)} with "
                         f"{hkv} KV heads")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"decode_attention lengths: want int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype} differ")
    if len({t.device for t in (q, k_cache, v_cache, lengths)}) != 1:
        raise ValueError("decode_attention: tensors on several devices")


def plan_for(q: torch.Tensor, k_cache: torch.Tensor,
             v_cache: torch.Tensor, num_kv_heads: int) -> Plan:
    """:func:`plan` for these tensors."""
    b, h, d = q.shape
    aligned = k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0
    sms, clusters = H100_SMS, H100_D256_CLUSTERS
    if q.is_cuda:
        index = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        sms = _sms(index)
        if q.dtype == torch.bfloat16 and d == 256:
            clusters = _d256_clusters(index)
    return plan(b, h, num_kv_heads, d, k_cache.shape[1], k_cache.stride(),
                v_cache.stride(), q.dtype, aligned, sms, clusters)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     num_kv_heads: int) -> torch.Tensor:
    """q [B, H, D], caches [B, S, Hkv, D], int32 lengths [B] -> [B, H, D];
    the kernel on CUDA tensors, the plain version on CPU ones."""
    hkv = num_kv_heads
    _check(q, k_cache, v_cache, lengths, hkv)
    b, h, d = q.shape
    with cost.counted("decode_attn", cost.decode_attn, b, h, hkv, d,
                      k_cache.shape[1], k_cache.element_size()):
        return _dispatch(q, k_cache, v_cache, lengths, hkv)


def _dispatch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              lengths: torch.Tensor, hkv: int) -> torch.Tensor:
    b, h, d = q.shape
    g = h // hkv
    scale = 1.0 / (d ** 0.5)
    if not q.is_cuda:
        out = decode_attn_ref(q.reshape(b, hkv, g, d),
                              k_cache.transpose(1, 2),
                              v_cache.transpose(1, 2), lengths, scale=scale)
        return out.reshape(b, h, d)
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention kernel: float32 or bfloat16, "
                        f"got {q.dtype}")
    if d > MAX_HEAD_DIM or g * d > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention kernel: D = {d}, G x D = "
                         f"{g * d}; at most {MAX_HEAD_DIM} and "
                         f"{MAX_GROUP_WIDTH}")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("decode_attention kernel: the caches' last dim "
                         "must be contiguous")
    how = plan_for(q, k_cache, v_cache, hkv)
    q, lengths = q.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    generic = how.instance == "generic"
    lib = _lib()
    err = lib.decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, k_cache.shape[1], hkv, g, d,
        *k_cache.stride()[:3], *v_cache.stride()[:3], scale,
        _DTYPES[q.dtype], 0 if generic else 1, how.n_split,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, f"decode_attn launch ({how.instance})")
    decode_attention.launches += 1
    decode_attention.generic_launches += generic
    return out


decode_attention.launches = 0
decode_attention.generic_launches = 0
