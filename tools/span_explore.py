#!/usr/bin/env python3
"""Where the stream tick's span kernels spend a call, on one CUDA card.

    python3 tools/span_explore.py

Exploration, not a check: it times the span instances of
``window_reduce`` (the staged tick's ``[T x 16]`` and ``[T x 1]`` calls)
and ``fused_tick`` (the fused tick's ``[T x 18]`` block) at the tick's
shapes, each call's device time from a ``torch.profiler`` trace as
``chip_smoke.py`` takes it, and prints one line a measurement:

* the plan: K windows a block and the bank pad, through the compiled
  library with other launch parameters than ``ops.plan`` picks (each
  result held bitwise against the plain version first);
* the copy: the TMA's bulk copies against the cp.async path that
  unaligned tiles take, forced for every tile;
* the phases, by subtraction: the kernel without its sweep, without its
  copy, and without either (launch, setup, mask and epilogue).

The variants are built from ``src/repro_torch/kernels/csrc/`` with one
line edited each, into ``build/span_explore/`` (git-ignored).  Without a
CUDA card it exits 1.
"""
from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "span_explore"
T, W, S, D = 65568, 64, 32, 16
REPS = 200

#: one-line edits of the sources, by variant
ALIGNED = "  if (h == 0 && group % 4 == 0 && n % 4 == 0) {"
NO_COPY = ("  const int h = head(g);\n",
           "  if (n >= 0) return false;\n  const int h = head(g);\n")
EDITS = {
    "cp.async copy": [(ALIGNED,
                       ALIGNED.replace("(h == 0", "(false && h == 0"))],
    "no sweep": [("      if (active && lo < hi)\n",
                  "      if (false && active && lo < hi)\n")],
    "no copy": [NO_COPY],
    "neither": [NO_COPY, ("      if (active && lo < hi)\n",
                          "      if (false && active && lo < hi)\n")],
}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variants(build) -> dict:
    """{(kernel, variant): CDLL}, built in parallel."""
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    procs = []
    for name in ("window_reduce", "fused_tick"):
        for tag, edits in EDITS.items():
            files = {f.name: f.read_text()
                     for f in [csrc / f"{name}.cu", *csrc.glob("*.cuh")]}
            for old, new in edits:
                if not any(old in text for text in files.values()):
                    raise RuntimeError(f"{name} {tag}: {old!r} not found")
                files = {k: v.replace(old, new) for k, v in files.items()}
            where = OUT / f"{name}-{tag.replace(' ', '_')}"
            where.mkdir(parents=True, exist_ok=True)
            for k, v in files.items():
                (where / k).write_text(v)
            so = where / f"{name}.so"
            procs.append(((name, tag), so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                 str(where / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log.decode()}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("span_explore: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import rules as R
    from repro_torch.kernels import build, span
    from repro_torch.kernels.fused_tick import ops as fops
    from repro_torch.kernels.fused_tick.ref import fused_tick_ref
    from repro_torch.kernels.window_reduce import ops as wops
    from repro_torch.kernels.window_reduce.ref import sliding_reduce_ref
    from repro_torch.testing import assert_bitwise
    cs = _smoke()
    build.build_all(("window_reduce", "fused_tick"))
    libs = _variants(build)
    libs[("window_reduce", "")] = wops._lib()
    libs[("fused_tick", "")] = fops._lib()
    p, i = ctypes.c_void_p, ctypes.c_int
    for (name, _), lib in libs.items():
        if name == "window_reduce":
            lib.window_reduce_f32.argtypes = [p, p, ctypes.c_longlong, i, i, i,
                                              i, i, i, i, i, i,
                                              ctypes.c_longlong, p]
        else:
            lib.fused_tick_f32.argtypes = [
                p, ctypes.c_longlong, p, ctypes.c_longlong, i, i, i, i, i, p,
                i, ctypes.c_float, p, p, p, p, p, i, i, i, i, i,
                ctypes.c_longlong, p]
    print(f"card: {cs._card_line()}")
    cs._prime_profiler("cuda")
    dev, stream = torch.device("cuda"), torch.cuda.current_stream().cuda_stream
    nw = (T - W) // S + 1
    gen = torch.Generator(dev).manual_seed(3)
    blocks = {16: torch.randn((T, D), generator=gen, device=dev),
              1: torch.randn((T, 1), generator=gen, device=dev)}
    seq = torch.cat([torch.arange(T, dtype=torch.float32, device=dev)[:, None],
                     torch.randn((T, 1 + D), generator=gen, device=dev)], 1)
    valid = torch.rand((T,), generator=gen, device=dev) < 0.95
    table = tuple(tuple(r) for r in cs._engine(R).table())
    rows = fops._rule_rows(table)

    def wr(lib, x, k, pad, instance=1):
        d = x.shape[1]
        tile = (k - 1) * S + W
        threads = min(-(-k * d // 32) * 32, span.MAX_THREADS)
        smem = span.smem_bytes(tile, d, S, pad, False)
        out = torch.empty((nw, d), device=dev)

        def call():
            err = lib.window_reduce_f32(x.data_ptr(), out.data_ptr(), nw, d, W,
                                        S, 0, instance, k, tile, pad, threads,
                                        smem, stream)
            if err:
                raise RuntimeError(f"window_reduce launch: error {err}")
        return call, (out,)

    def ft(lib, k, pad, instance=1):
        ld, tile = 2 + D, (k - 1) * S + W
        threads = min(-(-k * (ld - 1) // 32) * 32, span.MAX_THREADS)
        smem = span.smem_bytes(tile, ld, S, pad, True)
        outs = (torch.empty((nw, D), device=dev),
                torch.empty((nw,), dtype=torch.int32, device=dev),
                torch.empty((nw, 5), device=dev),
                torch.empty((nw,), device=dev),
                torch.empty((nw,), dtype=torch.int32, device=dev))
        agg, wcount, feats, w_birth, cons = outs

        def call():
            err = lib.fused_tick_f32(
                seq.data_ptr(), ld, valid.data_ptr(), nw, ld - 1, 1, D, W, S,
                ctypes.addressof(rows), len(rows), 1.0, agg.data_ptr(),
                feats.data_ptr(), wcount.data_ptr(), w_birth.data_ptr(),
                cons.data_ptr(), instance, k, tile, pad, threads, smem,
                stream)
            if err:
                raise RuntimeError(f"fused_tick launch: error {err}")
        return call, outs

    def timed(what, call, outs, want, kernel):
        call()
        torch.cuda.synchronize()
        if want is not None:
            for a, b in zip(outs, want):
                assert_bitwise(a, b, what)
        us = cs._timed(call, REPS, "explore", kernel=kernel)[0] * 1e3
        print(f"{what}: {us:.4f} us")

    for d, x in blocks.items():
        want = (sliding_reduce_ref(x, W, S, nw, "sum"),)
        p0 = wops.plan(d, W, S, nw)
        tag = f"window_reduce [{T} x {d}] sum"
        for k in (4, 8, 16, 32):
            for pad in sorted({0, p0.pad}):
                timed(f"{tag} span K={k} pad={pad}",
                      *wr(libs[("window_reduce", "")], x, k, pad), want,
                      "window_reduce_kernel_span")
        timed(f"{tag} simple", *wr(libs[("window_reduce", "")], x, 8, 0, 0),
              want, "window_reduce_kernel_simple")
        for tag2 in EDITS:
            timed(f"{tag} span at the plan (K={p0.k} pad={p0.pad}), {tag2}",
                  *wr(libs[("window_reduce", tag2)], x, p0.k, p0.pad),
                  want if tag2 == "cp.async copy" else None,
                  "window_reduce_kernel_span")
    want = fused_tick_ref(seq, valid, W, S, table)
    p0 = fops.plan(T, 2 + D, W, S)
    tag = f"fused_tick [{T} x {2 + D}]"
    for k in (4, 8, 15):
        timed(f"{tag} span K={k} pad=0", *ft(libs[("fused_tick", "")], k, 0),
              want, "fused_tick_kernel_span")
    timed(f"{tag} simple", *ft(libs[("fused_tick", "")], 8, 0, 0), want,
          "fused_tick_kernel_simple")
    for tag2 in EDITS:
        timed(f"{tag} span at the plan (K={p0.k} pad={p0.pad}), {tag2}",
              *ft(libs[("fused_tick", tag2)], p0.k, p0.pad),
              want if tag2 == "cp.async copy" else None,
              "fused_tick_kernel_span")
    return 0


if __name__ == "__main__":
    sys.exit(main())
