"""Edge stream analytics on PyTorch: windowed anomaly detection on a
sensor feed.

The twin of ``edge_stream_analytics.py`` over ``repro_torch``: sensors
on a bridge stream acceleration tuples to an edge RP, which keeps
sliding windows over the feed (the ``window_reduce`` kernel on the
card), runs the IF-THEN rule engine on each window's features and
escalates only the anomalous windows -- a vibration burst -- to the
capacity-bounded core tier.  Each tick is one compile-once step (a CUDA
graph on the card).

    PYTHONPATH=src python examples/edge_stream_analytics_torch.py \\
        [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pipeline as pipe
from repro_torch.core import rules
from repro_torch.stream import (StreamConfig, StreamExecutor,
                                window_feature_names)

D = 3              # accel_rms, strain, temperature
BATCH = 64         # sensor tuples per micro-batch
STEPS = 30
QUAKE = range(12, 18)     # steps during which the burst happens


def edge_fn(params, batch):
    """Edge pre-processing: pass window records through, expose the
    window features (cols 0:5) to the rule engine."""
    return batch, batch[:, :5]


def core_fn(params, batch):
    """Core damage model stand-in: a deliberate heavyweight transform
    that only ever sees the escalated (compacted) windows."""
    h = batch
    for _ in range(16):
        h = torch.tanh(h @ params)
    return h, batch[:, :5]


def main(device=None) -> dict:
    """Streams the feed on ``device`` (``None``: the card); returns the
    metric counters and the escalated windows of each step."""
    dev = resolve_device(device)
    cfg = StreamConfig(micro_batch=BATCH, window=32, stride=16,
                       capacity=8 * BATCH, lateness=16.0)
    # IF(window max accel >= 3.0) THEN escalate; quiet windows with few
    # samples are stored at the edge for later batch upload.
    engine = rules.RuleEngine([
        rules.threshold_rule("burst", 1, ">=", 3.0, rules.C_SEND_CORE,
                             priority=2),
        rules.threshold_rule("thin_window", 4, "<", 8.0,
                             rules.C_STORE_EDGE, priority=1),
    ])
    core_p = torch.as_tensor(
        np.random.default_rng(0).standard_normal((5 + D, 5 + D)) * 0.2,
        dtype=torch.float32, device=dev)
    pl = pipe.two_tier_pipeline(edge_fn, core_fn, engine, core_params=core_p,
                                core_capacity=2)
    ex = StreamExecutor(cfg, engine, pl, device=dev)
    state = ex.init_state(D)

    rng = np.random.default_rng(42)
    t0 = 0.0
    escalated = {}
    print(f"features per window: {window_feature_names()}")
    for step in range(STEPS):
        accel = np.abs(rng.standard_normal(BATCH)).astype(np.float32) * 0.5
        if step in QUAKE:
            accel += rng.gamma(4.0, 1.5, BATCH).astype(np.float32)
        items = np.stack([accel,
                          rng.standard_normal(BATCH).astype(np.float32),
                          np.full(BATCH, 21.5, np.float32)], axis=1)
        ts = t0 + np.arange(BATCH, dtype=np.float32)
        # one straggler tuple re-delivered from far in the past:
        if step == 20:
            ts[0] -= 500.0
        t0 += BATCH
        state, out = ex.step(state, torch.as_tensor(items, device=dev),
                             torch.as_tensor(ts, device=dev))
        esc = out.escalated.cpu().numpy()
        if esc.any():
            mx = out.features.cpu().numpy()[:, 1]
            escalated[step] = np.nonzero(esc)[0].tolist()
            print(f"step {step:2d}: escalated windows "
                  f"{escalated[step]} (max accel "
                  f"{', '.join(f'{v:.1f}' for v in mx[esc])})")

    m = state.metrics.as_dict()        # one host pull for all counters
    print(f"\n{m['items_offered']} tuples offered, "
          f"{m['items_rejected']} rejected (backpressure), "
          f"{m['items_late']} late-dropped")
    print(f"{m['windows_emitted']} windows -> "
          f"{m['windows_escalated']} escalated to core "
          f"({m['core_overflow']} hit the core capacity limit), "
          f"{m['windows_stored']} stored at edge")
    print(f"step function traced {ex.trace_count} time(s)")
    return {"metrics": m, "escalated": escalated,
            "trace_count": ex.trace_count}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    main(ap.parse_args().device)
