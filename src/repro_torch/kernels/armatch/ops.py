"""Wrapper for the ``armatch`` kernel: data profiles x interests.

Contract of ``repro.kernels.armatch.ops.armatch``: ``[M, 128]`` int32
data profiles against ``[N, 128]`` int32 interest profiles -> ``[M,
N]`` int32 0/1 matches.  The TPU wrapper pads both sides with all-zero
profiles to whole 128 x 128 tiles and transposes the interests; the
CUDA kernel takes both tables as they are, row-major, masks its own
ragged edges, and sizes its tile to ``N``, so ``N = 1`` (one query
against a store) launches no padded tile.

Dispatch follows the tensor's device: a CUDA tensor launches
``csrc/armatch.cu`` (or raises), a CPU tensor takes the plain version
in ``ref.py``.  ``armatch.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import profiles as P
from repro_torch.kernels import build
from repro_torch.kernels.armatch.ref import armatch_ref


def _lib() -> ctypes.CDLL:
    lib = build.library("armatch")
    if not lib.armatch_i32.argtypes:
        p = ctypes.c_void_p
        lib.armatch_i32.argtypes = [p, p, p, ctypes.c_longlong,
                                    ctypes.c_longlong, p]
        lib.armatch_i32.restype = ctypes.c_int
    return lib


def armatch(data: torch.Tensor, interests: torch.Tensor) -> torch.Tensor:
    """[M, PROFILE_WIDTH] data x [N, PROFILE_WIDTH] interests -> [M, N]
    int32; the kernel on a CUDA tensor, the plain version on a CPU one."""
    for name, t in (("data", data), ("interests", interests)):
        if t.dtype != torch.int32 or t.dim() != 2 \
                or t.shape[1] != P.PROFILE_WIDTH:
            raise ValueError(f"armatch {name}: want int32 [*, "
                             f"{P.PROFILE_WIDTH}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if data.device != interests.device:
        raise ValueError(f"armatch: data on {data.device}, interests on "
                         f"{interests.device}")
    if not data.is_cuda:
        return armatch_ref(data, interests)
    data, interests = data.contiguous(), interests.contiguous()
    m, n = data.shape[0], interests.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=data.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    err = lib.armatch_i32(data.data_ptr(), interests.data_ptr(),
                          out.data_ptr(), m, n,
                          torch.cuda.current_stream(data.device).cuda_stream)
    build.check(lib, err, "armatch launch")
    armatch.launches += 1
    return out


armatch.launches = 0
