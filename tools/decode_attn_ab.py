#!/usr/bin/env python3
"""The ``decode_attn`` kernel of this checkout against the same kernel
built from another source, on one CUDA card.

    python3 tools/decode_attn_ab.py OTHER_CSRC [--reps 200] [--rounds 3]

``OTHER_CSRC`` is a ``csrc/`` directory holding another
``decode_attn.cu`` (say the parent commit's, unpacked under ``build/``).
Both are compiled with ``kernels.build``'s flags; the other one into
``build/decode_attn_ab/``.  For each of ``chip_smoke.py``'s phase-2
decode_attn cases (``checks.check_decode_attn``'s serve, edge, ragged,
strided and unaligned shapes, float32 and bfloat16, seeded alike) it
prints whether the two kernels' outputs are bitwise equal, and fails if
any differs.  Then it times both at the two serve caches of the kernels
line (rows 5 and 5b: Yi-6B's ``bf16_d128`` and RecurrentGemma-2B's
``bf16_d256``, every row full but a length-0 one), L2 warm: the mean
device time of the kernel over ``--reps`` back-to-back calls, from a
``torch.profiler`` trace (the launch rate, not the kernel, bounds a
host clock here), in turns (this, other, other, this) for
``--rounds`` rounds, and prints each side's median microseconds a call
and the change, beside the card's name and power limit.  Without a
CUDA card it exits 1.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, checks  # noqa: E402
from repro_torch.kernels.decode_attn import ops  # noqa: E402

#: (b, h, hkv, d, s): the Yi-6B and RecurrentGemma-2B serve caches
ROWS = {"5 bf16_d128": (16, 32, 4, 128, 1088),
        "5b bf16_d256": (16, 10, 1, 256, 1088)}
#: Mixtral-8x7B's serve cache, the third serve shape of phase 2
MIXTRAL = (16, 32, 8, 128, 96)
#: seconds a capture idles after its tracer starts and before it stops:
#: without it a capture can miss launches (chip_smoke.py's SETTLE_S)
SETTLE_S = 0.05


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def other_lib(csrc: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "decode_attn_ab" / "other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(csrc / "decode_attn.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.decode_attn.argtypes = ops._lib().decode_attn.argtypes
    lib.decode_attn.restype = ctypes.c_int
    return lib


def call(lib, q, k, v, lengths, hkv) -> torch.Tensor:
    """One launch of ``lib``'s kernel as ``ops._dispatch`` makes it."""
    b, h, d = q.shape
    how = ops.plan_for(q, k, v, hkv)
    out = torch.empty_like(q)
    err = lib.decode_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, k.shape[1], hkv, h // hkv, d, *k.stride()[:3],
        *v.stride()[:3], 1.0 / d ** 0.5, ops._DTYPES[q.dtype],
        0 if how.instance == "generic" else 1, how.n_split,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attn launch: CUDA error {err}")
    return out


def inputs(gen, dtype, b, h, hkv, d, s, kind, dev):
    """``checks.check_decode_attn``'s tensors for one case."""
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    width = {"strided": d + 16, "unaligned": d + 1}.get(kind, d)
    k, v = (torch.randn((b, s, hkv, width), generator=gen,
                        device=dev).to(dtype)[..., :d] for _ in range(2))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    how = ops.plan_for(q, k, v, hkv)
    if kind == "full":
        lengths.fill_(s)
    elif kind == "edges":
        lengths = checks.split_edge_lengths(
            b, s, how.n_split, ops.SUB_ROWS * ops.warps(dtype, d)).to(dev)
    if kind != "ragged":
        lengths[0] = 0
    return q, k, v, lengths


def compare(this, other, dev) -> int:
    gen = torch.Generator(dev).manual_seed(6)
    cases = [*((full, kind) for full in (*ROWS.values(), MIXTRAL)
               for kind in ("full", "edges")),
             *((s, "ragged") for s in checks.DECODE_ATTN_SHAPES
               + checks.DECODE_ATTN_HEADS),
             ((3, 8, 2, 32, 70), "strided"), ((3, 8, 2, 32, 70), "unaligned")]
    differ = 0
    for dtype in checks.DECODE_ATTN_TOL:
        for (b, h, hkv, d, s), kind in cases:
            q, k, v, lengths = inputs(gen, dtype, b, h, hkv, d, s, kind, dev)
            a, o = call(this, q, k, v, lengths, hkv), \
                call(other, q, k, v, lengths, hkv)
            same = torch.equal(a.view(torch.uint8), o.view(torch.uint8))
            differ += not same
            print(f"{dtype} {(b, h, hkv, d, s)} {kind} "
                  f"{ops.plan_for(q, k, v, hkv).instance}: "
                  f"{'bitwise equal' if same else 'DIFFERENT'}")
    return differ


def prime(dev) -> None:
    """A throw-away capture: a process's first can miss the device ops
    launched while its tracer starts."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(16):
            x = x + 1
        torch.cuda.synchronize()


def timed(lib, args, reps: int) -> float:
    """Mean device microseconds of the kernel over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    call(lib, *args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)            # the device tracer is up
        for _ in range(reps):
            call(lib, *args)
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)            # every record has landed
    path = ROOT / "build" / "decode_attn_ab" / "trace.json"
    prof.export_chrome_trace(str(path))
    durs = [e["dur"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "kernel" and "decode_attn" in e["name"]]
    if len(durs) != reps:
        raise RuntimeError(f"{len(durs)} decode_attn kernels traced, "
                           f"want {reps}")
    return sum(durs) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attn_ab: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    this, other = ops._lib(), other_lib(args.other)
    print(f"card: {card()}")
    differ = compare(this, other, dev)
    gen = torch.Generator(dev).manual_seed(9)
    prime(dev)
    for row, (b, h, hkv, d, s) in ROWS.items():
        q, k, v, lengths = inputs(gen, torch.bfloat16, b, h, hkv, d, s,
                                  "full", dev)
        t = {"this": [], "other": []}
        for _ in range(args.rounds):
            for side in ("this", "other", "other", "this"):
                lib = this if side == "this" else other
                t[side].append(timed(lib, (q, k, v, lengths, hkv),
                                     args.reps))
        a, o = statistics.median(t["this"]), statistics.median(t["other"])
        print(f"row {row} {(b, h, hkv, d, s)} n_split "
              f"{ops.plan_for(q, k, v, hkv).n_split}: this {a:.3f} us, "
              f"other {o:.3f} us a call (median of {2 * args.rounds} runs "
              f"of {args.reps}), change {(a / o - 1) * 100:+.2f}%; "
              f"this {t['this']}, other {t['other']}")
    print(f"{differ} case(s) differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
