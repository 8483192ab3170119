"""The readings the limits of ``correct`` are set from, on the card:
the precision control's (the reference in the program's place, its core
in TF32) at a cell's own size, one line a seed.  The program's readings
are the compared numbers that every run of ``run.py`` prints.

    python3 perfbench/readings.py --workload <cell> --ticks <n> \
        --seeds <a> <b> <c>
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ticks", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    from perfbench.pb import spec
    from perfbench.pb.feed import Feed, Sampler
    from perfbench.reference import compare as RC
    from perfbench.reference import stream as RS
    from perfbench.systems import stream as ST
    cell = spec.cell(ROOT, args.workload)
    cfg = cell["config"]
    torch.backends.cuda.matmul.allow_tf32 = False
    shards = ST.all_shards(cfg)
    for seed in args.seeds:
        t0 = time.perf_counter()
        p = torch.as_tensor(ST.core_weights(cfg, seed), device="cuda")
        feed = Feed(cell["traffic"], cfg, range(shards), seed, "cuda")
        ref = RS.Stream(cfg, p.double(), "cuda")
        sampled = Sampler(seed, cfg["check_one_in"])
        want = {t for t in range(args.ticks) if sampled(t)}
        done = ref.run(feed, args.ticks, want)
        line = {"workload": args.workload, "seed": seed,
                "ticks": args.ticks,
                "emulated_tf32": RC.control_numbers(cfg, done, p),
                "card_tf32": RC.control_numbers(cfg, done, p, hardware=True),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        del feed, ref, done
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
