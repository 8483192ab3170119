"""Wrapper for the ``armatch`` kernel: data profiles x interests.

Contract of ``repro.kernels.armatch.ops.armatch``: ``[M, 128]`` int32
data profiles against ``[N, 128]`` int32 interest profiles -> ``[M,
N]`` int32 0/1 matches.  The TPU wrapper pads both sides with all-zero
profiles to whole 128 x 128 tiles and transposes the interests; the
CUDA kernel takes both tables as they are, row-major, and masks its own
ragged edges.

Dispatch follows the tensor's device: a CUDA tensor launches
``csrc/armatch.cu`` (or raises), a CPU tensor takes the plain version in
``ref.py``.  :func:`plan` picks the kernel's instance from N alone:
``narrow`` streams the data rows once for a few interests (a query
against a store, a registry lookup), ``wide`` keeps each data row
decoded in registers across many interests (the notify match).  The
``simple`` instance (the first port's kernel) runs only when asked for
by name, to hold the others against it.  Each call is one launch:
``armatch.launches`` counts them all, ``armatch.simple_launches`` those
of the simple instance.  A launch inside a captured CUDA graph
(``runtime.capture``) is counted at each replay: the capture records
what the counters gained and adds it again.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import profiles as P
from repro_torch.kernels import build, cost
from repro_torch.kernels.armatch.ref import armatch_ref

#: the widest N the narrow instance takes: its interests' decoded slots
#: sit in shared memory beside its ring of row tiles, and its 32 results
#: a row gather in one register (``kNarrowMaxN`` in ``csrc/armatch.cu``)
NARROW_MAX_N = 32
#: each instance's code in the launcher's interface
INSTANCES = {"simple": 0, "narrow": 1, "wide": 2}


def plan(m: int, n: int) -> str:
    """The instance a ``[m, 128] x [n, 128]`` call launches: ``narrow``
    up to :data:`NARROW_MAX_N` interests, where the data rows' bytes bound
    the call, else ``wide``, where its operations do."""
    del m       # the data side streams through either instance alike
    return "narrow" if n <= NARROW_MAX_N else "wide"


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lib() -> ctypes.CDLL:
    lib = build.library("armatch")
    if not lib.armatch_i32.argtypes:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.armatch_i32.argtypes = [p, p, p, ll, ll, ctypes.c_int,
                                    ctypes.c_int, p]
        lib.armatch_i32.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel reads
    16 bytes at a time): a copy only for a view that starts elsewhere."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def armatch(data: torch.Tensor, interests: torch.Tensor,
            instance: str | None = None) -> torch.Tensor:
    """[M, PROFILE_WIDTH] data x [N, PROFILE_WIDTH] interests -> [M, N]
    int32; the kernel on a CUDA tensor, the plain version on a CPU one.
    ``instance`` names the kernel's instance instead of :func:`plan`."""
    for name, t in (("data", data), ("interests", interests)):
        if t.dtype != torch.int32 or t.dim() != 2 \
                or t.shape[1] != P.PROFILE_WIDTH:
            raise ValueError(f"armatch {name}: want int32 [*, "
                             f"{P.PROFILE_WIDTH}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if data.device != interests.device:
        raise ValueError(f"armatch: data on {data.device}, interests on "
                         f"{interests.device}")
    if instance is not None and instance not in INSTANCES:
        raise ValueError(f"armatch: instance {instance!r}, want one of "
                         f"{sorted(INSTANCES)}")
    if instance == "narrow" and interests.shape[0] > NARROW_MAX_N:
        raise ValueError(f"armatch: the narrow instance takes at most "
                         f"{NARROW_MAX_N} interests, got "
                         f"{interests.shape[0]}")
    with cost.counted("armatch", cost.armatch, data, interests):
        if not data.is_cuda:
            return armatch_ref(data, interests)
        return _launch(data, interests, instance)


def _launch(data: torch.Tensor, interests: torch.Tensor,
            instance: str | None) -> torch.Tensor:
    data, interests = _aligned(data), _aligned(interests)
    m, n = data.shape[0], interests.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=data.device)
    if m == 0 or n == 0:
        return out
    how = instance or plan(m, n)
    lib = _lib()
    err = lib.armatch_i32(data.data_ptr(), interests.data_ptr(),
                          out.data_ptr(), m, n, INSTANCES[how],
                          _sms(data.device.index or 0),
                          _stream(data.device))
    build.check(lib, err, f"armatch {how} launch")
    armatch.launches += 1
    if how == "simple":
        armatch.simple_launches += 1
    return out


armatch.launches = 0
armatch.simple_launches = 0
