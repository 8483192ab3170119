"""Streaming training fed by the AR data plane, on PyTorch ("functions
follow data").

The twin of ``federated_stream_train.py`` over ``repro_torch``: a
training topology is stored as a function profile; producers post token
batches tagged with content profiles; the SFC layer routes each batch
to its owner RP shard (the ``hilbert`` kernel on the card); the rule
engine gates which batches enter the optimizer; training consumes from
the device ring buffer.  The registry resolves the train topology; the
port captures only fixed-shape inference steps as CUDA graphs, so the
resolved entry's function -- the train step -- runs eagerly, as
``launch.train`` runs it.

    PYTHONPATH=src python examples/federated_stream_train_torch.py \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import convert, optim, resolve_device
from repro_torch.configs.registry import smoke_config
from repro_torch.core import profiles as P
from repro_torch.core import routing, rules, serverless
from repro_torch.core.overlay import Overlay
from repro_torch.data.ringbuffer import create as rb_create
from repro_torch.data.ringbuffer import dequeue, enqueue
from repro_torch.data.ringbuffer import size as q_size
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T

SEQ, BATCH, STEPS = 64, 8, 15
cfg = smoke_config("mixtral_8x7b")   # MoE: routing twice (data + experts)


def main(device=None, params=None) -> dict:
    """Trains on the stream on ``device`` (``None``: the card).
    ``params``: the reference's ``init_params`` tree of numpy arrays
    (``None``: the port's seeded init).  Returns the admission counts
    and the losses."""
    dev = resolve_device(device)
    # --- platform bootstrap ----------------------------------------------
    ov = Overlay.from_mesh_shape(4, 4, capacity=2)
    table = torch.as_tensor(ov.routing_table(granularity=6), device=dev)
    registry = serverless.FunctionRegistry(dev)
    model = T.init_params(cfg, seed=0, device=dev, trainable=True) \
        if params is None else convert.train_model_from_numpy(cfg, params,
                                                              dev)
    opt_cfg = optim.AdamWConfig(lr=1e-3)
    opt_state = optim.init(model, opt_cfg)
    registry.store_function("train:mixtral", P.profile("train", cfg.name),
                            steps_mod.build_train_step(cfg, opt_cfg))

    # data-quality gate (paper §IV-D2): only well-formed batches train
    engine = rules.RuleEngine([
        rules.threshold_rule("too_short", 0, "<", SEQ // 2, rules.C_DROP,
                             priority=5),
        rules.threshold_rule("admit", 0, ">=", SEQ // 2, rules.C_STORE_EDGE),
    ])

    queue = rb_create(capacity=64, item_shape=(SEQ + 1,), dtype=torch.int32,
                      device=dev)
    rng = np.random.default_rng(0)
    producer_profile = P.profile("tokens", "web", lang="en")

    # --- producers post; platform routes; training consumes ----------------
    losses, admitted, rejected, ranks = [], 0, 0, []
    [(entry, _)] = registry.start_function(
        P.ProfileBuilder().add_single("train").build())
    step_fn = entry.fn
    for step in range(STEPS):
        # producer side: a batch of documents with varying quality
        docs = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
        doc_lens = rng.integers(SEQ // 4, SEQ + 1, BATCH)
        feats = torch.as_tensor(doc_lens, dtype=torch.float32,
                                device=dev)[:, None]
        _, consequence = engine(feats)
        keep = consequence.cpu().numpy() != rules.C_DROP
        admitted += int(keep.sum())
        rejected += int((~keep).sum())

        # route the admitted docs to their RP shard (content-based dispatch)
        prof_batch = torch.as_tensor(np.stack([producer_profile] * BATCH),
                                     device=dev)
        ranks.append(routing.rank_of_message(prof_batch, table))
        queue, _ = enqueue(queue, torch.as_tensor(docs[keep], device=dev))

        # consumer side: train only when a full batch is queued
        if int(q_size(queue)) < BATCH:
            continue
        queue, batch_tok, valid = dequeue(queue, BATCH)
        batch = {"tokens": batch_tok[:, :-1], "labels": batch_tok[:, 1:]}
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))

    print(f"admitted {admitted}, rejected {rejected} (quality rules)")
    print(f"train steps: {len(losses)}; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss should decrease"
    return {"admitted": admitted, "rejected": rejected, "losses": losses,
            "ranks": torch.stack(ranks).cpu().numpy()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    main(ap.parse_args().device)
