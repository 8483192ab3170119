#!/usr/bin/env python3
"""How far the float32 ``decode_attn`` kernel stays inside its check's
tolerance, on one CUDA card.

    python3 tools/decode_attn_margin.py [--seeds 6] [--repeats 300]

Exploration, not a check: at the Yi-6B serve step's full cache (B 16,
32 heads on 4 KV heads of 128, S 1,088, every row full but a length-0
one), in float32, for each seed it prints one line: the instance
planned, the largest difference from the same attention in float64
(``checks.decode_attn_f64``) of the kernel, of the plain version on the
card and of the plain version on the CPU, the ratio of the largest
kernel-to-CPU difference to ``checks.DECODE_ATTN_TOL`` as the check
applies it (absolute plus relative), and how many of ``--repeats``
further calls on the same inputs gave other bits than the first.  Then
it runs ``checks.check_decode_attn`` itself at chip_smoke.py's serve
shapes ``--checks`` times and prints how many raised.  Without a CUDA
card it exits 1.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build, checks  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn_ref  # noqa: E402
from repro_torch.kernels.decode_attn.ops import plan_for  # noqa: E402

#: (b, h, hkv, d, s) of the Yi-6B serve step, RecurrentGemma-2B's and
#: Mixtral's (chip_smoke.py phase 2)
SERVE = (16, 32, 4, 128, 1088)
OTHERS = ((16, 10, 1, 256, 1088), (16, 32, 8, 128, 96))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def margin(seed: int, repeats: int) -> str:
    b, h, hkv, d, s = SERVE
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
            for _ in range(2))
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    lengths[0] = 0
    out = decode_attention(q, k, v, lengths, num_kv_heads=hkv)
    plain = decode_attn_ref(q.reshape(b, hkv, h // hkv, d), k.transpose(1, 2),
                            v.transpose(1, 2), lengths,
                            scale=1.0 / d ** 0.5).reshape(b, h, d)
    differ = sum(not torch.equal(out, decode_attention(
        q, k, v, lengths, num_kv_heads=hkv)) for _ in range(repeats))
    cpu = decode_attention(q.cpu(), k.cpu(), v.cpu(), lengths.cpu(),
                           num_kv_heads=hkv)
    off = checks.f64_errors(q, k, v, lengths, hkv, kernel=out, plain=plain,
                            cpu=cpu)
    tol = checks.DECODE_ATTN_TOL[torch.float32]
    ratio = float(((out.cpu() - cpu).abs() / (tol + tol * cpu.abs())).max())
    return (f"seed {seed} {plan_for(q, k, v, hkv)}: largest difference "
            f"from float64 {off}; kernel vs CPU at {ratio:.4f} of the "
            f"tolerance; {differ} of {repeats} repeats gave other bits")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=300)
    ap.add_argument("--checks", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_attn_margin: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["decode_attn"])
    print(f"card: {card()}; float32 at {SERVE}", flush=True)
    for seed in range(args.seeds):
        print(margin(seed, args.repeats), flush=True)
    raised = 0
    for _ in range(args.checks):
        try:
            checks.check_decode_attn("cuda", SERVE, *OTHERS)
        except AssertionError as e:
            raised += 1
            print(f"check_decode_attn raised: {e}", flush=True)
    print(f"check_decode_attn at {(SERVE, *OTHERS)}: {raised} of "
          f"{args.checks} runs raised; card: {card()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
