"""End-to-end training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi_6b \
        --smoke --steps 50 --batch 8 --seq 128 [--device cpu]

Port of ``repro.launch.train`` on one device (the mesh and the
shardings wait for ROADMAP item 14): a trainable model (the port's
seeded random init unless the caller hands one in) and AdamW state,
the ``SyntheticTokens`` stream behind a ``Prefetcher``, the train step
of ``launch.steps`` under the reference's cosine schedule, checkpoints
every ``ckpt_every`` steps in the reference's format (the reference's
``(params, AdamWState)`` tree, ``convert.train_state_tree``), resume
from the latest one, and the health and straggler bookkeeping.  A
resumed run continues the token stream at its step (the reference's
loop restarts the stream from its first batch).  A non-finite loss
raises.  Runs on the CUDA card unless the caller asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import convert, optim, resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.data import Prefetcher, SyntheticTokens
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.runtime import HealthMonitor, StragglerDetector


class TrainResult(NamedTuple):
    losses: list                # each step's loss (host floats)
    grad_norms: list            # each step's global gradient norm
    secs: list                  # wall seconds of each step, synchronised
    model: T.Transformer
    opt_state: optim.AdamWState
    start_step: int             # the step resumed from (0: a fresh run)
    checkpoints: list           # the steps kept in ``ckpt_dir``


def run(cfg, steps: int, batch: int, seq: int, *, microbatches: int = 1,
        lr: float = 3e-4, ckpt_dir: str | None = None, ckpt_every: int = 10,
        resume: bool = False, device: str | torch.device | None = None,
        model: T.Transformer | None = None) -> TrainResult:
    """Train ``cfg`` for steps ``[start, steps)`` on ``batch`` x ``seq``
    tokens a step.  ``ckpt_dir`` (``None``: no checkpoints) is written
    every ``ckpt_every`` steps; ``resume`` restores its latest step
    first, in place of ``model``'s weights.  Every step is timed with a
    synchronize on the card; the loss and grad norm are read after the
    step's time is taken."""
    dev = resolve_device(device)
    if model is None:
        model = T.init_params(cfg, seed=0, device=dev, trainable=True)
    opt_cfg = optim.AdamWConfig(lr=lr)
    opt_state = optim.init(model, opt_cfg)

    cm = CheckpointManager(ckpt_dir) if ckpt_dir is not None else None
    start = 0
    if resume and cm is not None and cm.latest_step() is not None:
        (params, ref_state), start = cm.restore(
            convert.train_state_tree(cfg, model, opt_state))
        model = convert.train_model_from_numpy(cfg, params, dev)
        opt_state = convert.adamw_state_from_numpy(cfg, model, ref_state, dev)
        del params, ref_state
        print(f"resumed from step {start}")

    def sched(s):
        return cosine_with_warmup(s, warmup=10, total=steps * 10)

    step_fn = steps_mod.build_train_step(
        cfg, opt_cfg, num_microbatches=microbatches, schedule=sched)

    source = SyntheticTokens(cfg.vocab, seq, batch)
    data = Prefetcher((source.batch_at(s) for s in range(start, steps)),
                      depth=2, device=dev)
    health = HealthMonitor(num_ranks=1)
    stragglers = StragglerDetector(num_ranks=1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses, gnorms, secs = [], [], []
    try:
        for step, b in zip(range(start, steps), data):
            if cfg.vlm:
                bs, s = b["tokens"].shape
                b["vision_embeds"] = torch.zeros(
                    (bs, s, cfg.d_model), dtype=cfg.compute_dtype, device=dev)
                b["vision_mask"] = torch.zeros((bs, s), dtype=torch.bool,
                                               device=dev)
            sync()
            t0 = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, b)
            sync()
            dt = time.perf_counter() - t0
            loss = float(metrics["loss"])
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            secs.append(dt)
            health.heartbeat(0)
            stragglers.observe(np.full(1, dt))
            if step % 5 == 0 or step == steps - 1:
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"gnorm {gnorms[-1]:.3f}  {dt * 1e3:.0f} ms")
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {step}")
            if cm is not None and (step + 1) % ckpt_every == 0:
                cm.save(step + 1,
                        convert.train_state_tree(cfg, model, opt_state))
    finally:
        data.close()
    return TrainResult(losses, gnorms, secs, model, opt_state, start,
                       cm.all_steps() if cm is not None else [])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args()

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"arch: {cfg.name}  device: {resolve_device(args.device)}")
    t0 = time.time()
    res = run(cfg, args.steps, args.batch, args.seq,
              microbatches=args.microbatches, lr=args.lr,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              resume=args.resume, device=args.device)
    print(f"done: {args.steps - res.start_step} steps in "
          f"{time.time() - t0:.1f}s; checkpoints at {args.ckpt_dir}: "
          f"{res.checkpoints}")


if __name__ == "__main__":
    main()
