"""Disaster-recovery pipeline on PyTorch (paper §II + §V-B, Fig. 13-14).

The twin of ``disaster_recovery.py`` over ``repro_torch``: drone LiDAR
frames stream through the device ring buffer into a two-tier pipeline;
an "edge" model pre-processes every frame, the rule engine escalates
damaged-looking frames to the "core" model and stores the rest, and
frames of pathological variance are dropped.  The models are reduced
configs from the zoo (edge = RecurrentGemma-class hybrid, whose local
attention is the full-sequence path here, core = Yi-class dense).

    PYTHONPATH=src python examples/disaster_recovery_torch.py \\
        [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.configs.registry import smoke_config
from repro_torch.core import pipeline as pipe
from repro_torch.core import rules
from repro_torch.data.ringbuffer import create as rb_create
from repro_torch.data.ringbuffer import dequeue, enqueue
from repro_torch.models import transformer as T

SEQ = 32          # patch tokens per LiDAR frame
BATCH = 8         # frames per pipeline batch
N_FRAMES = 64

edge_cfg = smoke_config("recurrentgemma_2b")
core_cfg = smoke_config("yi_34b")


def make_stage(cfg, model):
    def fn(p, frames):       # frames: [N, SEQ] token ids (as float)
        tokens = frames.to(torch.int32) % cfg.vocab
        logits, _, _ = T.forward(cfg, model, {"tokens": tokens})
        # "damage score": mean surprisal of the frame under the model
        logp = torch.log_softmax(logits.float(), dim=-1)
        score = -torch.mean(torch.max(logp, dim=-1).values, dim=-1)   # [N]
        lat = torch.var(frames.float(), dim=-1, unbiased=False)  # proxy
        return frames, torch.stack([score, lat], dim=-1)
    return fn


engine = rules.RuleEngine([
    # content rule: high damage score (frame surprisal) -> core post-process
    rules.threshold_rule("damage", 0, ">=", 3.19, rules.C_SEND_CORE,
                         priority=1),
    # quality rule: pathological variance -> drop (deadline trade-off)
    rules.threshold_rule("quality", 1, ">=", 7000.0, rules.C_DROP,
                         priority=5),
])


def main(device=None, params=None) -> dict:
    """Streams the frames on ``device`` (``None``: the card).
    ``params``: (edge, core) weights as the reference's ``init_params``
    trees of numpy arrays (``None``: the port's seeded init, seeds 0 and
    1).  Returns the counts and each frame's edge features and
    decision."""
    dev = resolve_device(device)
    if params is None:
        edge_model = T.init_params(edge_cfg, seed=0, device=dev)
        core_model = T.init_params(core_cfg, seed=1, device=dev)
    else:
        edge_model = convert.model_from_numpy(edge_cfg, params[0], dev)
        core_model = convert.model_from_numpy(core_cfg, params[1], dev)
    dr_pipeline = pipe.two_tier_pipeline(
        make_stage(edge_cfg, edge_model), make_stage(core_cfg, core_model),
        engine)

    # ---- stream frames through the device ring buffer -------------------
    queue = rb_create(capacity=128, item_shape=(SEQ,), dtype=torch.float32,
                      device=dev)
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 255, (N_FRAMES, SEQ)).astype(np.float32)

    t0 = time.time()
    escalated = stored = dropped = 0
    features, decisions = [], []
    with torch.inference_mode():
        for i in range(0, N_FRAMES, BATCH):
            queue, n = enqueue(queue, torch.as_tensor(frames[i:i + BATCH],
                                                      device=dev))
            queue, batch, valid = dequeue(queue, BATCH)
            res = dr_pipeline.run(batch)
            esc = res.escalated.cpu().numpy()
            drop = res.dropped.cpu().numpy()
            escalated += int(np.sum(esc))
            dropped += int(np.sum(drop))
            stored += int(np.sum(~esc & ~drop))
            features.append(res.stage_features[0].float().cpu().numpy())
            decisions.append(np.where(drop, "dropped",
                                      np.where(esc, "escalated", "stored")))
    dt = time.time() - t0

    print(f"{N_FRAMES} frames in {dt:.2f}s ({N_FRAMES / dt:.0f} frames/s)")
    print(f"  escalated to core: {escalated}")
    print(f"  stored at edge:    {stored}")
    print(f"  dropped (quality): {dropped}")
    assert escalated + stored + dropped == N_FRAMES
    return {"escalated": escalated, "stored": stored, "dropped": dropped,
            "features": np.concatenate(features),
            "decisions": np.concatenate(decisions).tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    main(ap.parse_args().device)
