#!/usr/bin/env python3
"""Where the ``decode_attn`` bf16 D 256 instance spends a call, on one
CUDA card.

    python3 tools/decode_attn_explore.py [--reps 200]

Exploration, not a check: at RecurrentGemma-2B's serve cache (16
requests, 10 query heads on one KV head of 256, 1,088 rows, every row
full but a length-0 one) it times the instance's kernel, each call's
device time from a ``torch.profiler`` trace (``tools/decode_attn_ab.py``'s
``timed``), and prints one line a measurement:

* the plan: this checkout's library at 1, 2 and 4 to 8 splits, at 16
  requests and at 8 (fewer clusters), with the clusters the card holds
  at once (``ops.kernel_attrs``); each result first held against the
  plain version within the bf16 tolerance;
* the phases, by subtraction, from variants built with a few lines
  edited into ``build/decode_attn_explore/`` (git-ignored), each at 6
  and 8 splits: the kernel without its products (waits for every tile,
  computes nothing), and without its copies (computes on whatever the
  ring holds);
* the staging: every tile by cp.async in place of the TMA's tensor
  copies, boxes of one 64-column block (2 KB) in place of a whole tile's
  (8 KB), rings of 4 and 8 tiles, and the warps in one group; each held
  against the kernel as built within the bf16 tolerance;
* the fixed costs: the kernel that returns at once, and without tiles
  (with and without q's loads), at 1 and 6 splits;
* the timeline: a variant that stamps ``%globaltimer`` at each step of
  each block (``TIMELINE``), at 6 splits.

The card's name and power limit head the output.  Without a CUDA card
it exits 1.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "decode_attn_explore"
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, checks, cost  # noqa: E402
from repro_torch.kernels.decode_attn import ops  # noqa: E402
from repro_torch.kernels.decode_attn.ref import decode_attn_ref  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
#: RecurrentGemma-2B's serve cache (b, h, hkv, d, s)
RG = (16, 10, 1, 256, 1088)

WAIT = "    ptx::mbar_wait(bars + slot, (t / kD256Stages) & 1);\n"
REFILL = "    if (t + kD256Stages < n) {    // refill this slot once"
FILL = ("  for (int t = group; t < min(n, kD256Stages); t += kD256Groups) "
        "issue(t);\n")
ISSUE = "      issue(t + kD256Stages);\n"
TMA_K = "        ptx::tma_load_5d(slot, &kmap, 0, row0, 0, h, b, bar);\n"
TMA_V = ("        ptx::tma_load_5d(slot + kHalf, &vmap, 0, row0, 0, h, b, "
         "bar);\n")
#: boxes of one column block (16 rows by 64 columns, 2 KB) in place of a
#: whole tile's: the map's dimensions (64 columns, 4 column blocks, hkv,
#: s, b), four copies of K's and four of V's a tile
BOXES = """\
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          ptx::tma_load_5d(slot + cb * 2048, &kmap, 0, cb, h, row0, b, bar);
          ptx::tma_load_5d(slot + kHalf + cb * 2048, &vmap, 0, cb, h, row0,
                           b, bar);
        }
"""
MAP = """\
  const cuuint64_t dim[5] = {64, (cuuint64_t)s, kD256 / 64, (cuuint64_t)hkv,
                             (cuuint64_t)b};
  const cuuint64_t stride[4] = {(cuuint64_t)ss * 2, 128, (cuuint64_t)sh * 2,
                                (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {64, kSub, kD256 / 64, 1, 1};
"""
MAP_BLOCKS = """\
  const cuuint64_t dim[5] = {64, kD256 / 64, (cuuint64_t)hkv, (cuuint64_t)s,
                             (cuuint64_t)b};
  const cuuint64_t stride[4] = {128, (cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                (cuuint64_t)sb * 2};
  const cuuint32_t box[5] = {64, 1, 1, kSub, 1};
"""
STAGES = "constexpr int kD256Stages = 6;"
GROUPS = "constexpr int kD256Groups = 2;"
TILES = ("  const int n = end > start ? (end - start + kSub - 1) / kSub : 0;"
         "  // tiles\n")
#: the timeline variant: thread 0 of the block (of each group, for its
#: tiles) stamps %globaltimer (ns) at each step into a shared array,
#: written over ``out`` at the end in place of the result (32 u64 a block):
#: 0 start, 1 length read, 30 past the block barrier after the mbarriers'
#: initialization, 2 first copies issued, 3 q staged, 4 + t tile
#: t landed (t < 16), 20 to 22 tile 0's bytes announced, its K and its
#: V box issued, 23 tile 2 issued, 24 + j group j done with its tiles,
#: 26 the block folded, 27 the inbox full, 29 end
STAMP = ("  if ({who}) tl_[{k}] = gt_();\n")
TIMELINE = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  // the mbarriers first",
     "  __shared__ unsigned long long tl_[32];\n"
     "  auto gt_ = [] { unsigned long long x; asm volatile("
     "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(x)); return x; };\n"
     "  if (threadIdx.x < 32) tl_[threadIdx.x] = 0;\n"
     + STAMP.format(who="threadIdx.x == 0", k=0)
     + "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  // the mbarriers first"),
    ("  block_rows<kSub>(a, bh, split, start, end);\n"
     "  const int group = warp / kGroupWarps, gw = warp % kGroupWarps;\n",
     "  block_rows<kSub>(a, bh, split, start, end);\n"
     "  const int group = warp / kGroupWarps, gw = warp % kGroupWarps;\n"
     + STAMP.format(who="tid == 0 && end >= 0", k=1)),
    ("  __syncthreads();                // the ring's mbarriers are "
     "initialized\n",
     "  __syncthreads();                // the ring's mbarriers are "
     "initialized\n" + STAMP.format(who="tid == 0", k=30)),
    (FILL, FILL + STAMP.format(who="tid == 0", k=2)),
    ("        ptx::mbar_arrive_expect_tx(bar, 2 * kHalf);\n",
     "        ptx::mbar_arrive_expect_tx(bar, 2 * kHalf);\n"
     + STAMP.format(who="t == 0", k=20)),
    (TMA_K, TMA_K + STAMP.format(who="t == 0", k=21)),
    (TMA_V, TMA_V + STAMP.format(who="t == 0", k=22)
     + STAMP.format(who="t == 2", k=23)),
    ("    sq16[i / D * kRow + i % D] = qv[j];\n  }\n  __syncthreads();\n",
     "    sq16[i / D * kRow + i % D] = qv[j];\n  }\n  __syncthreads();\n"
     + STAMP.format(who="tid == 0", k=3)),
    (WAIT, WAIT + "  " + STAMP.format(who="gtid == 0 && t < 16", k="4 + t")),
    ("  // the block's partial: m [kMaxG], l [kMaxG], acc [kMaxG][kAccRow] at",
     STAMP.format(who="gtid == 0", k="24 + group")
     + "  // the block's partial: m [kMaxG], l [kMaxG], acc [kMaxG][kAccRow] "
     "at"),
    ("  // the splits' fold: block `split` folds",
     STAMP.format(who="tid == 0", k=26)
     + "  // the splits' fold: block `split` folds"),
    ("  T* out = static_cast<T*>(a.out) + (long long)bh * a.g * D;\n"
     "  for (int i = tid; i < a.g * nc; i += kThreads) {\n",
     STAMP.format(who="tid == 0", k=27)
     + "  T* out = static_cast<T*>(a.out) + (long long)bh * a.g * D;\n"
     "  for (int i = tid; i < a.g * nc; i += kThreads) {\n"),
    ("    store4(out + gi * D + (c0 + cc) * 4, o, sum);\n  }\n}\n",
     "  }\n" + STAMP.format(who="tid == 0", k=29)
     + "  __syncthreads();\n  if (tid < 32) reinterpret_cast<unsigned long "
     "long*>(a.out)[blockIdx.x * 32 + tid] = tl_[tid];\n}\n"),
]
#: edits of decode_attn.cu, by variant
EDITS = {
    # the products skipped (n is never negative), the copies kept
    "no products": [(WAIT, WAIT + "    if (n < 0) {\n"),
                    (REFILL, "    }\n" + REFILL)],
    "no copies": [(WAIT, ""), (FILL, ""), (ISSUE, "")],
    "cp.async copies": [("    if (tma && row0 + kSub <= end) {",
                         "    if (false && tma && row0 + kSub <= end) {")],
    "2 KB boxes": [(TMA_K + TMA_V, BOXES), (MAP, MAP_BLOCKS)],
    "empty": [(TILES, TILES + "  if (n >= 0) return;\n")],
    "no tiles": [(TILES, "  const int n = 0;\n")],
    "no tiles, no q": [(TILES, "  const int n = 0;\n"),
                       ("? qg[i] : (uint16_t)0;", "? 0 : (uint16_t)0;")],
    "1 group": [(GROUPS, GROUPS.replace("= 2;", "= 1;"))],
    "4 stages": [(STAGES, STAGES.replace("= 6;", "= 4;"))],
    "8 stages": [(STAGES, STAGES.replace("= 6;", "= 8;"))],
}
#: the variants that compute the same function, held to the kernel
CHECKED = ("cp.async copies", "2 KB boxes", "1 group", "4 stages",
           "8 stages")
#: split counts a variant is timed at, 6 unless named here
SPLITS = {"empty": (1, 6), "no tiles": (1, 6), "no tiles, no q": (1, 6)}


def _ab():
    spec = importlib.util.spec_from_file_location(
        "decode_attn_ab", ROOT / "tools" / "decode_attn_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(ab, fn, reps: int) -> float:
    """``decode_attn_ab.timed``; if the trace missed a launch (a capture
    can), the mean of the launches it holds."""
    return ab.timed(fn, reps, exact=False)


def variant(name: str, edits) -> ctypes.CDLL:
    """The library built from decode_attn.cu with ``edits`` applied."""
    src = (CSRC / "decode_attn.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the edit {old!r} does not match "
                               "once")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    cu = OUT / f"{tag}.cu"
    cu.write_text(src)
    so = OUT / f"{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC),
                    "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.decode_attn.argtypes = ops._lib().decode_attn.argtypes
    lib.decode_attn.restype = ctypes.c_int
    lib.decode_attn_attrs.argtypes = ops._lib().decode_attn_attrs.argtypes
    lib.decode_attn_attrs.restype = ctypes.c_int
    return lib


def clusters(lib, n: int) -> int:
    """Clusters of ``n`` blocks of ``lib``'s bf16 D 256 instance (G 10)
    the card holds at once."""
    out = (ctypes.c_int * 5)()
    err = lib.decode_attn_attrs(1, 256, 10, 1, n, out)
    if err:
        raise RuntimeError(f"decode_attn_attrs: CUDA error {err}")
    return out[4]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--variant", action="append", default=None,
                    help="time only these variants (default: every one)")
    ap.add_argument("--splits", type=int, nargs="*", default=list(range(1, 9)),
                    help="the plan sweep's split counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attn_explore: no CUDA card", file=sys.stderr)
        return 1
    ab = _ab()
    dev = torch.device("cuda")
    print(f"card: {ab.card()}")
    this = ab.Side("this", ops._lib(), ops.plan_for)
    gen = torch.Generator(dev).manual_seed(9)
    tol = checks.DECODE_ATTN_TOL[torch.bfloat16]
    ab.prime(dev)
    for b in (16,):
        _, h, hkv, d, s = RG
        q, k, v, (lengths,) = ab.inputs(gen, torch.bfloat16, b, h, hkv, d,
                                        s, "full", dev)
        plain = decode_attn_ref(q.reshape(b, hkv, h // hkv, d),
                                k.transpose(1, 2), v.transpose(1, 2),
                                lengths, scale=d ** -0.5).reshape(b, h, d)
        nbytes, _ = cost.decode_attn(b, h, hkv, d, s, 2)
        bound = nbytes / ab.PEAK_BYTES_S * 1e6
        for n in args.splits:
            args_ = (q, k, v, lengths, hkv)
            err = checks.max_err_within(this.call(*args_, n_split=n), plain,
                                        tol, f"b {b} n_split {n}")
            us = timed(ab, lambda: this.call(*args_, n_split=n), args.reps)
            attrs = ops.kernel_attrs(torch.bfloat16, d, h // hkv,
                                     ops.Plan("bf16_d256", n))
            print(f"plan b {b} n_split {n}: {us:.3f} us ({b * n} blocks, "
                  f"{attrs['clusters']} clusters of {n} at once; share "
                  f"{bound / us:.4f} of {bound:.3f} us; max abs err vs "
                  f"plain {err:.3e})")
    b, h, hkv, d, s = RG
    q, k, v, (lengths,) = ab.inputs(gen, torch.bfloat16, b, h, hkv, d, s,
                                    "full", dev)
    nbytes, _ = cost.decode_attn(b, h, hkv, d, s, 2)
    bound = nbytes / ab.PEAK_BYTES_S * 1e6
    base = {n: timed(ab, lambda: this.call(q, k, v, lengths, hkv,
                                           n_split=n), args.reps)
            for n in (1, 6)}
    print(f"variant as built: {base}")
    for name, edits in EDITS.items():
        if args.variant is not None and name not in args.variant:
            continue
        lib = variant(name, edits)
        side = ab.Side(name, lib, ops.plan_for)
        for n in SPLITS.get(name, (6,)):
            err = checks.max_err_within(
                side.call(q, k, v, lengths, hkv, n_split=n),
                this.call(q, k, v, lengths, hkv, n_split=n), tol,
                name) if name in CHECKED else None
            us = timed(ab, lambda: side.call(q, k, v, lengths, hkv,
                                             n_split=n), args.reps)
            print(f"variant {name} n_split {n}: {us:.3f} us "
                  f"({us - base[n]:+.3f} us against the kernel as built; "
                  f"share {bound / us:.4f}; {clusters(lib, n)} clusters at "
                  f"once; max abs err against the kernel {err})")
    timeline(ab, q, k, v, lengths, hkv)
    return 0


def timeline(ab, q, k, v, lengths, hkv, n: int = 6) -> None:
    """The timeline variant's stamps at ``n`` splits, the second of two
    calls: each step's time after the first block's start, mean, least
    and most over the blocks that reach it (microseconds)."""
    side = ab.Side("timeline", variant("timeline", TIMELINE), ops.plan_for)
    for _ in range(2):
        out = side.call(q, k, v, lengths, hkv, n_split=n)
    torch.cuda.synchronize()
    blocks = q.shape[0] * hkv * n
    st = out.view(torch.int64).flatten()[:blocks * 32].view(blocks, 32)
    st = st.cpu().double()
    t0 = st[:, 0].min()
    names = {0: "start", 1: "length read", 30: "mbarriers ready",
             20: "tile 0 announced", 21: "tile 0 K box issued",
             22: "tile 0 V box issued", 23: "tile 2 issued",
             2: "first copies issued",
             3: "q staged", **{4 + t: f"tile {t} landed" for t in range(16)},
             24: "group 0 done", 25: "group 1 done", 26: "block folded",
             27: "inbox full", 29: "end"}
    for key, name in names.items():
        got = st[:, key][st[:, key] > 0]
        if len(got):
            rel = (got - t0) / 1e3
            print(f"timeline n_split {n} {name}: mean {rel.mean():.3f} us, "
                  f"least {rel.min():.3f}, most {rel.max():.3f} "
                  f"({len(got)} blocks)")


if __name__ == "__main__":
    sys.exit(main())
