#!/usr/bin/env python3
"""The ``decode_attn`` kernel of this checkout against the same kernel
built from another source, on one CUDA card.

    python3 tools/decode_attn_ab.py OTHER_CSRC [--reps 200] [--rounds 3]

``OTHER_CSRC`` is the ``csrc/`` directory of another checkout of the
port (say the parent commit's, unpacked under ``build/``): its
``decode_attn.cu`` is compiled with ``kernels.build``'s flags into
``build/decode_attn_ab/``, and each side launches with its own tree's
plan (the other tree's ``kernels/decode_attn/ops.py``, beside its
``csrc/``, loaded as a module of its own).  For each of ``chip_smoke.py``'s
phase-2 decode_attn cases (``checks.check_decode_attn``'s serve, edge,
ragged, strided and unaligned shapes, float32 and bfloat16, seeded
alike) it prints whether the two kernels' outputs are bitwise equal; a
case that takes the bf16 D 256 instance, whose design differs, is held
within the bf16 tolerance instead, beside each side's largest
difference from ``checks.decode_attn_f64``.  It fails if a case
differs.  Then it times both at the three serve caches of the kernel
table (rows 5 and 5b: Yi-6B's ``bf16_d128``, RecurrentGemma-2B's
``bf16_d256``; and Mixtral-8x7B's ``f32_d128`` in float32), every row
full but a length-0 one, L2 warm: the mean device time of the kernel
over ``--reps`` back-to-back calls, from a ``torch.profiler`` trace
(the launch rate, not the kernel, bounds a host clock here), in turns
(this, other, other, this) for ``--rounds`` rounds, and prints each
side's median microseconds a call, the change, the byte bound and
``scaled_dot_product_attention``'s time on the same inputs, beside the
card's name and power limit.  Without a CUDA card it exits 1.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, checks, cost  # noqa: E402
from repro_torch.kernels.decode_attn import ops  # noqa: E402

#: (b, h, hkv, d, s) of the Yi-6B, RecurrentGemma-2B and Mixtral-8x7B
#: serve caches, phase 2's serve shapes
YI, RG, MIXTRAL = ((16, 32, 4, 128, 1088), (16, 10, 1, 256, 1088),
                   (16, 32, 8, 128, 96))
#: the kernel table's rows timed here: shape and dtype
ROWS = {"5 bf16_d128": (*YI, torch.bfloat16),
        "5b bf16_d256": (*RG, torch.bfloat16),
        "5 f32_d128 (Mixtral)": (*MIXTRAL, torch.float32)}
#: seconds a capture idles after its tracer starts and before it stops:
#: without it a capture can miss launches (chip_smoke.py's SETTLE_S)
SETTLE_S = 0.05
#: the card's memory rate, for the byte bound (chip_smoke.PEAK_BYTES_S)
PEAK_BYTES_S = 3.35e12


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


class Side:
    """One tree's kernel library and its launch plan."""

    def __init__(self, name: str, lib: ctypes.CDLL, plan_for):
        self.name, self.lib, self.plan_for = name, lib, plan_for

    def call(self, q, k, v, lengths, hkv, n_split=None) -> torch.Tensor:
        """One launch as that tree's ``ops._dispatch`` makes it (or at
        ``n_split`` splits, as ``tools/decode_attn_explore.py`` asks)."""
        b, h, d = q.shape
        how = self.plan_for(q, k, v, hkv)
        out = torch.empty_like(q)
        err = self.lib.decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, k.shape[1], hkv, h // hkv, d, *k.stride()[:3],
            *v.stride()[:3], 1.0 / d ** 0.5, ops._DTYPES[q.dtype],
            0 if how.instance == "generic" else 1, n_split or how.n_split,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name} decode_attn launch: CUDA error "
                               f"{err}")
        return out


def other_side(csrc: Path) -> Side:
    out = ROOT / "build" / "decode_attn_ab" / "other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(csrc / "decode_attn.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    lib.decode_attn.argtypes = ops._lib().decode_attn.argtypes
    lib.decode_attn.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        "other_decode_attn_ops", csrc.parent / "decode_attn" / "ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return Side("other", lib, mod.plan_for)


def inputs(gen, dtype, b, h, hkv, d, s, kind, dev):
    """``checks.check_decode_attn``'s tensors for one case: a list of
    lengths (one a call; the split edges take as many calls as reach
    every edge of this tree's plan)."""
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    width = {"strided": d + 16, "unaligned": d + 1}.get(kind, d)
    k, v = (torch.randn((b, s, hkv, width), generator=gen,
                        device=dev).to(dtype)[..., :d] for _ in range(2))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    how = ops.plan_for(q, k, v, hkv)
    rounds = [lengths]
    if kind == "full":
        lengths.fill_(s)
    elif kind == "edges":
        unit = ops.unit_rows(dtype, d)
        rounds = [checks.split_edge_lengths(b, s, how.n_split, unit,
                                            p).to(dev)
                  for p in range(checks.edge_parts(b, s, how.n_split, unit))]
    if kind != "ragged":
        rounds[0][0] = 0
    return q, k, v, rounds


def compare(this: Side, other: Side, dev) -> int:
    gen = torch.Generator(dev).manual_seed(6)
    cases = [*((full, kind) for full in (YI, RG, MIXTRAL)
               for kind in ("full", "edges")),
             *((s, "ragged") for s in checks.DECODE_ATTN_SHAPES
               + checks.DECODE_ATTN_HEADS),
             ((3, 8, 2, 32, 70), "strided"), ((3, 8, 2, 32, 70), "unaligned")]
    differ = 0
    for dtype, tol in checks.DECODE_ATTN_TOL.items():
        for (b, h, hkv, d, s), kind in cases:
            q, k, v, rounds = inputs(gen, dtype, b, h, hkv, d, s, kind, dev)
            instance = ops.plan_for(q, k, v, hkv).instance
            for lengths in rounds:
                a, o = this.call(q, k, v, lengths, hkv), \
                    other.call(q, k, v, lengths, hkv)
                what = f"{dtype} {(b, h, hkv, d, s)} {kind} {instance}"
                if instance == "bf16_d256":
                    try:
                        err = checks.max_err_within(a, o, tol, what)
                        verdict = f"within {tol} (max {err:.3e})"
                    except AssertionError as e:
                        verdict, differ = f"DIFFERENT: {e}", differ + 1
                    off = checks.f64_errors(q, k, v, lengths, hkv, this=a,
                                            other=o)
                    print(f"{what}: {verdict}; from float64 {off}")
                    continue
                same = torch.equal(a.view(torch.uint8), o.view(torch.uint8))
                differ += not same
                print(f"{what}: {'bitwise equal' if same else 'DIFFERENT'}")
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


def timed(fn, reps: int, kernel: str | None = "decode_attn",
          exact: bool = True) -> float:
    """Mean device microseconds a call of ``fn`` over ``reps`` calls:
    the kernels named ``kernel`` (exactly one a call, or with ``exact``
    false the mean of those the trace holds, at least half), or every
    device kernel of the window when ``kernel`` is None."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(SETTLE_S)            # the device tracer is up
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)            # every record has landed
    path = ROOT / "build" / "decode_attn_ab" / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    durs = [e["dur"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "kernel"
            and (kernel is None or kernel in e["name"])]
    if kernel is not None and (len(durs) != reps if exact
                               else 2 * len(durs) < reps):
        raise RuntimeError(f"{len(durs)} {kernel} kernels traced, "
                           f"want {reps}")
    return sum(durs) / (reps if kernel is None else len(durs))


def sdpa(q, k, v, lengths):
    """``scaled_dot_product_attention`` on the same cache views, with the
    length mask and ``enable_gqa`` (chip_smoke.py's yardstick)."""
    import torch.nn.functional as F
    s = k.shape[1]
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0]


def time_rows(this: Side, other: Side, dev, reps: int, rounds: int) -> None:
    gen = torch.Generator(dev).manual_seed(9)
    prime(dev)
    for row, (b, h, hkv, d, s, dtype) in ROWS.items():
        q, k, v, (lengths,) = inputs(gen, dtype, b, h, hkv, d, s, "full",
                                     dev)
        args = (q, k, v, lengths, hkv)
        t = {"this": [], "other": []}
        for _ in range(rounds):
            for side in ("this", "other", "other", "this"):
                lib = this if side == "this" else other
                t[side].append(timed(lambda: lib.call(*args), reps))
        library = timed(sdpa(q, k, v, lengths), reps, kernel=None)
        nbytes, _ = cost.decode_attn(b, h, hkv, d, s, k.element_size())
        bound = nbytes / PEAK_BYTES_S * 1e6
        a, o = statistics.median(t["this"]), statistics.median(t["other"])
        print(f"row {row} {(b, h, hkv, d, s)} {dtype}: this "
              f"{this.plan_for(q, k, v, hkv)} {a:.3f} us, other "
              f"{other.plan_for(q, k, v, hkv)} {o:.3f} us a call (median "
              f"of {2 * rounds} runs of {reps}), change "
              f"{(a / o - 1) * 100:+.2f}%; bound {bound:.3f} us (bytes: "
              f"{nbytes}), share this {bound / a:.4f}, other "
              f"{bound / o:.4f}; SDPA {library:.3f} us; this {t['this']}, "
              f"other {t['other']}")


def attrs_line() -> str:
    """The registers, local bytes and warps of this tree's instances at
    the three serve caches."""
    parts = []
    for row, (b, h, hkv, d, s, dtype) in ROWS.items():
        st = (s * hkv * d, hkv * d, d)
        how = ops.plan(b, h, hkv, d, s, st, st, dtype,
                       sms=ops._sms(torch.cuda.current_device()))
        got = ops.kernel_attrs(dtype, d, h // hkv, how)
        parts.append(f"{row}: {how} {got}")
    return "; ".join(parts)


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
    this, other = Side("this", ops._lib(), ops.plan_for), \
        other_side(args.other)
    print(f"card: {card()}")
    print(f"this tree's instances: {attrs_line()}")
    differ = compare(this, other, dev)
    time_rows(this, other, dev, args.reps, args.rounds)
    print(f"{differ} case(s) differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
