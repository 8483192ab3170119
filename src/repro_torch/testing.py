"""Parity helpers for holding the port against its reference.

Numpy and torch only, so any test or script may use them.  Arrays may
be numpy arrays, torch tensors (any device) or anything ``np.asarray``
accepts (a JAX array, say).

* :func:`assert_bitwise` -- float32 values compared through their
  int32 bit patterns (so ``-0.0 != 0.0``), integers and bools by value.
  NaN payloads are the one exception: IEEE 754 leaves the payload of a
  propagated NaN to the implementation (x86 keeps the operand's, a
  CUDA card writes its canonical ``0x7fffffff``), so a NaN matches any
  NaN at the same position and nothing else.
* :func:`assert_close` -- ``allclose`` with a :class:`Tolerance` that
  names why the two sides may differ.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Tolerance(NamedTuple):
    reason: str
    rtol: float
    atol: float


#: ``tanh`` and float32 matrix products are rounded differently by the
#: card's and the CPU's math libraries (a few ulp per op, compounded
#: over the core stand-in's 8 layers).
DEVICE_MATH = Tolerance("tanh/matmul rounding differs between CPU and "
                        "CUDA libraries", 1e-5, 1e-5)


def to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_bitwise(actual, expected, err_msg: str = "") -> None:
    a, e = to_numpy(actual), to_numpy(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{err_msg}: shape {a.shape} != {e.shape}")
    if a.dtype.kind == "f" or e.dtype.kind == "f":
        if a.dtype != np.float32 or e.dtype != np.float32:
            raise AssertionError(
                f"{err_msg}: dtype {a.dtype} vs {e.dtype}, need float32")
        nan_a, nan_e = np.isnan(a), np.isnan(e)
        np.testing.assert_array_equal(nan_a, nan_e,
                                      err_msg=f"{err_msg}: NaN positions")
        bits_a = np.where(nan_a, 0, a.view(np.int32))
        bits_e = np.where(nan_e, 0, e.view(np.int32))
        bad = bits_a != bits_e
        if bad.any():
            i = tuple(np.argwhere(bad)[0])
            raise AssertionError(
                f"{err_msg}: {int(bad.sum())} of {a.size} values differ in "
                f"their bits, first at {i}: {a[i]!r} vs {e[i]!r}")
        return
    np.testing.assert_array_equal(a, e, err_msg=err_msg)


def assert_close(actual, expected, tol: Tolerance, err_msg: str = "") -> None:
    np.testing.assert_allclose(
        to_numpy(actual), to_numpy(expected), rtol=tol.rtol, atol=tol.atol,
        err_msg=f"{err_msg} ({tol.reason})")
