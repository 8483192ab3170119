#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 12 (vi) alone, in a chosen compute dtype,
printing its statistics instead of checking them, on every CUDA card of
the machine (one NCCL rank a card).

    python3 tools/moe_serve_ranks.py [--compute bfloat16]

Exploration, not a check: Mixtral-8x7B at full width cut to 8 layers
(``chip_smoke.RANK_MOE_SERVE``, its compute dtype replaced by
``--compute``) serves 16 requests a rank through ``launch/serve``, each
rank's MoE layers planning over every rank's rows; then one card serves
all of them in one run on the ranks' path (their ids teacher-forced,
``chip_smoke.phase12_moe_reference``).  It prints how many generated
ids the card would not pick and by what margin over the largest logit,
each rank's final logits' difference, the late step's expert flips and
logit difference (``chip_smoke.moe_serve_stats``), and the MoE calls
whose global plan differs from the per-rank plans.  In bfloat16 the
ranks' 16-row GEMMs round otherwise than the card's 64-row ones and
greedy decoding turns that into other ids: why phase 12 checks (vi) in
float32.  Without a CUDA card it exits 1.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def rank_serve(rank: int, device, compute: str) -> dict:
    """(vi)'s served run on one rank (``launch.mesh.spawn``)."""
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    return C.rank_moe_serve(C.RANK_MOE_SERVE._replace(compute=compute),
                            device, make_host_mesh(device=device))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compute", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_serve_ranks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    sz = C.RANK_MOE_SERVE._replace(compute=args.compute)
    runs = M.spawn(rank_serve, C.phase12_ranks(), "cuda", args.compute)
    ref = C.phase12_moe_reference(sz, "cuda", runs)
    st = C.moe_serve_stats(ref, runs)
    margins = [t[2] for t in st["ties"]]
    print(f"{sz.arch}, {sz.layers} layers, {args.compute}, "
          f"{sz.requests} requests a rank over {len(runs)} rank(s): "
          f"{len(st['ties'])} of {st['generated']} generated ids the card "
          f"would not pick on the ranks' path (largest margin "
          f"{max(margins, default=0.0):.4e} of the largest logit; "
          f"{sum(m > C.SERVE_KERNEL_VS_PLAIN for m in margins)} over "
          f"{C.SERVE_KERNEL_VS_PLAIN}); final logits apart by rank "
          f"{[f'{x:.4e}' for x in st['final']]}; late step: "
          f"{len(st['flips'])} expert flip(s), {len(st['moved'])} moved, "
          f"the rest's logits {st['late']:.4e}; MoE calls planned "
          f"otherwise than per rank {ref['differing']} of {ref['calls']} "
          f"({ref['dropping']} drop a choice); {C._card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
