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
#: (S is dealt to the splits in units of that a warp of the block), and
#: the most splits a (b, KV head): they run as one thread-block cluster,
#: and 8 is the portable cluster size
FAST_HEAD_DIMS = {torch.bfloat16: (16, 32, 64, 128, 256),
                  torch.float32: (16, 32, 64, 128)}
MAX_FAST_GROUP = 16
SUB_ROWS = 16
MAX_SPLITS = 8
#: the H100's SM count, for a plan made without a card
H100_SMS = 132


def warps(dtype: torch.dtype, d: int) -> int:
    """Warps a block of the fast instance: bf16 8 (4 at D 256, where 8
    warps' rings overflow shared memory), float32 4.  Their rings fill
    most of an SM's shared memory: one block an SM."""
    if dtype == torch.bfloat16:
        return 8 if d <= 128 else 4
    return 4


def max_splits(dtype: torch.dtype, d: int) -> int:
    """:data:`MAX_SPLITS`, but 4 at bf16 D 256, so that the first
    block's inbox of the splits' partials fits beside its ring."""
    return 4 if dtype == torch.bfloat16 and d > 128 else MAX_SPLITS


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How one call runs: ``instance`` is ``"generic"`` or
    ``"<bf16|f32>_d<D>"``; ``n_split`` blocks a (b, KV head), one
    cluster, which share S's units of :data:`SUB_ROWS` rows a warp
    evenly (:func:`split_starts`) and fold their partials in the
    cluster's shared memory: the call needs no scratch in device
    memory."""
    instance: str
    n_split: int


def plan(b: int, h: int, hkv: int, d: int, s: int,
         k_strides: tuple[int, ...], v_strides: tuple[int, ...],
         dtype: torch.dtype, aligned: bool = True,
         sms: int = H100_SMS) -> Plan:
    """The launch plan of a call with q ``[b, h, d]`` and caches
    ``[b, s, hkv, d]`` of element strides ``k_strides`` /
    ``v_strides`` (the first three; D is contiguous) on a card of
    ``sms`` SMs; ``aligned`` says the caches' base addresses are
    16-byte aligned.  A fast instance needs D among
    :data:`FAST_HEAD_DIMS`, G at most :data:`MAX_FAST_GROUP`, and
    16-byte base and strides (its copies move 16 bytes); anything else
    takes the generic instance.  The split count fills one wave of one
    block an SM, at most one split a unit and :func:`max_splits`."""
    g = h // hkv
    strides_ok = all(st * dtype.itemsize % 16 == 0
                     for st in (*k_strides[:3], *v_strides[:3]))
    if d in FAST_HEAD_DIMS.get(dtype, ()) and g <= MAX_FAST_GROUP \
            and aligned and strides_ok:
        units = max(1, -(-s // (SUB_ROWS * warps(dtype, d))))
        n_split = max(1, min(units, max_splits(dtype, d), sms // (b * hkv)))
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


def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attn")
    if not lib.decode_attn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attn.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                    ll, ll, ll, ll, ll, ll,
                                    ctypes.c_float, i, i, i, p]
        lib.decode_attn.restype = ctypes.c_int
    return lib


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
    sms = _sms(q.device.index if q.device.index is not None
               else torch.cuda.current_device()) if q.is_cuda else H100_SMS
    return plan(b, h, num_kv_heads, d, k_cache.shape[1], k_cache.stride(),
                v_cache.stride(), q.dtype, aligned, sms)


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
