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
version in ``ref.py``.  ``decode_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attn.ref import decode_attn_ref

#: the kernel's limits (csrc/decode_attn.cu): float32 accumulators of a
#: block's G query rows, 16 a thread of 256, and the head width
MAX_GROUP_WIDTH = 16 * 256
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attn")
    if not lib.decode_attn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attn.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                    ll, ll, ll, ll, ll, ll,
                                    ctypes.c_float, i, p]
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     num_kv_heads: int) -> torch.Tensor:
    """q [B, H, D], caches [B, S, Hkv, D], int32 lengths [B] -> [B, H, D];
    the kernel on CUDA tensors, the plain version on CPU ones."""
    hkv = num_kv_heads
    _check(q, k_cache, v_cache, lengths, hkv)
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
    q, lengths = q.contiguous(), lengths.contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.decode_attn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, k_cache.shape[1], hkv, g, d,
        *k_cache.stride()[:3], *v_cache.stride()[:3], scale,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "decode_attn launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
