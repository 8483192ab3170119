"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, which is loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes).  Libraries
land in ``build/repro_torch_kernels/`` at the root of the checkout,
named by a hash of their source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and an
unchanged one is not.

Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc``.  ``build_all()`` starts one ``nvcc`` per
source at once; ``library(name)`` builds on first use.

``builds`` counts compilations in this process, so a caller can tell
that a step paid for a build (the executor withholds such a step's wall
time from its latency histogram).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: ``sm_90a`` keeps Hopper-only instructions available; no
#: ``--use_fast_math``: the kernels' divisions must round as IEEE 754
#: says (``-prec-div=true``, nvcc's default) and denormals stay.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

SOURCES = ("window_reduce", "fused_tick", "hilbert", "armatch",
           "decode_attn")

builds = 0
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels are built on the machine with the card")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> list[Path]:
    """Compile every stale library, one ``nvcc`` per source, all started
    together; raises with the compiler's output if any build fails."""
    global builds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    nvcc = _nvcc() if todo else None
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)        # atomic: a concurrent loader never
        builds += 1                 # sees a half-written library
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return [_target(n) for n in names]


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        path, = build_all((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher (a
    refused launch never runs, and no later synchronize reports it)."""
    if err:
        msg = lib.repro_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
