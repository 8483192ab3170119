"""A cell on several cards: one process a card (the program's
``launch.mesh.spawn``: NCCL between the cards), each rank holding its
run of the fleet's shards and measuring it as a one-card run does.  The
ranks close the window together: every 8 ticks rank 0 broadcasts (over
the world's NCCL group, between two ticks) whether its clock has passed
the window's length.  The process that starts the ranks touches no
card."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

#: ticks between two of rank 0's decisions whether the window is over
STOP_EVERY = 8
#: seconds after which a rank that has not finished prints every
#: thread's stack and exits (a rank stuck in a collective would
#: otherwise hold the others forever)
WATCHDOG_S = 300
#: seconds a rank may take to tear its process group down
TEARDOWN_S = 60


def _rank(rank: int, device, root: str, name: str, seed: int,
          seconds: float, trace: bool, t_start: float, resize,
          patch) -> dict:
    import faulthandler

    import torch
    import torch.distributed as dist

    from perfbench.pb import runner, spec
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    calls = [0]

    def stop(elapsed: float) -> bool:
        calls[0] += 1
        if calls[0] % STOP_EVERY:
            return False
        flag.fill_(int(rank == 0 and elapsed >= seconds))
        dist.broadcast(flag, 0)
        return bool(flag.item())

    def say(what: str) -> None:
        print(f"rank {rank}: {what} at {time.perf_counter() - t_start:.1f} s",
              file=sys.stderr, flush=True)
    cell = spec.cell(Path(root), name)
    if resize is not None:
        resize(cell)
    run = runner.measure(cell, seed, seconds, trace, device, t_start,
                         ranks=True, stop=stop,
                         scratch=Path(root) / "build" / "perfbench",
                         patch=patch, say=say)
    run["foreign"] = foreign_modules()
    if device.type == "cuda":
        run["kind"] = torch.cuda.get_device_name(device)
        torch.cuda.synchronize(device)
    dist.barrier()
    say("done")
    # the ranks' teardown (the process group's) gets the watchdog too
    faulthandler.dump_traceback_later(TEARDOWN_S, exit=True)
    return run


def foreign_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in sys.modules} & bad)


def measure(root: Path, name: str, n: int, seed: int, seconds: float,
            trace: bool, t_start: float, device: str = "cuda",
            resize=None, patch=None) -> dict:
    """Every rank's run, merged (``merge``, the numbers by the system's
    ``merge_numbers``).
    ``resize(cell)``: a module-level function that shrinks the cell in
    place, ``patch``: one that breaks the program (the harness's own
    tests on the CPU)."""
    import faulthandler

    from perfbench.pb import spec
    from repro_torch.launch import mesh as M
    system = spec.cell(root, name)["system"]
    faulthandler.dump_traceback_later(WATCHDOG_S + TEARDOWN_S + 30,
                                      exit=True)
    try:
        runs = M.spawn(_rank, n, device, str(root), name, seed, seconds,
                       trace, t_start, resize, patch)
    finally:
        faulthandler.cancel_dump_traceback_later()
    return merge(runs, trace, system.merge_numbers)


def merge(runs: list, trace: bool, merge_numbers) -> dict:
    """The ranks' runs as one: rank 0's window and trace, the fullest
    card's peak, the slowest rank's ticks, the ranks' mean busy and
    traced seconds and collective bytes, every rank's checks (merged by
    the system's ``merge_numbers``)."""
    run = dict(runs[0])
    run["peak_bytes"] = max(r["peak_bytes"] for r in runs)
    run["rank_tick_s"] = np.max([r["tick_s"] for r in runs], axis=0).tolist()
    run["collective_bytes"] = float(np.mean(
        [r["collective_bytes"] for r in runs]))
    if trace:
        run["traced_s"] = tuple(float(np.mean([r["graphed"][k] for r in runs]))
                                for k in ("busy_s", "window_s"))
    run["numbers"] = merge_numbers([r["numbers"] for r in runs])
    run["foreign"] = sorted({m for r in runs for m in r["foreign"]})
    return run
