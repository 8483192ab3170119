"""Quickstart: the R-Pulsar programming model in one file, on PyTorch.

The twin of ``quickstart.py`` over ``repro_torch``: register a sensor
(resource profile), declare a consumer interest, store a processing
function, and let an IF-THEN rule trigger it on matching data.  The
match and the query run the ``armatch`` kernel on the card, the routing
the ``hilbert`` kernel.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import profiles as P
from repro_torch.core import routing, rules, serverless, sfc, store
from repro_torch.core.overlay import Overlay
from repro_torch.kernels.armatch import armatch


def main(device=None) -> dict:
    """Runs the walk-through on ``device`` (``None``: the card) and
    returns its result numbers."""
    dev = resolve_device(device)

    # --- 1. Overlay bootstrap: 16 RPs on a 4x4 grid (paper Fig. 1) -------
    ov = Overlay.from_mesh_shape(4, 4, capacity=2, replication=2)
    table = torch.as_tensor(ov.routing_table(granularity=6), device=dev)
    regions = sum(1 for _ in ov.leaves())
    print(f"overlay: {regions} regions, routing table {table.shape[0]} cells")

    # --- 2. Producer: a drone with a LiDAR camera (paper Listing 1) ------
    drone = P.ProfileBuilder().add_single("Drone").add_single("LiDAR") \
        .add_num("lat", 40).add_num("long", -74).build()
    P.ARMessage(profile=drone, action=P.A_NOTIFY_INTEREST,
                location=(40.0583, -74.4056))

    # --- 3. Consumer interest: "Drone" + "Li*" (paper Listing 2) ---------
    interest = P.ProfileBuilder().add_single("Drone").add_single("Li*") \
        .build()

    # content-based matching (associative selection), the armatch kernel:
    def prof(rows):
        return torch.as_tensor(np.stack(rows).astype(np.int32), device=dev)

    match = armatch(prof([drone]), prof([interest]))
    matches = bool(match[0, 0])
    print("drone profile matches interest:", matches)

    # --- 4. Routing: profile -> SFC point -> RP (paper Fig. 2) -----------
    idx = sfc.profile_index(prof([drone]))
    rank = int(routing.rank_of_message(prof([drone]), table)[0])
    hilbert = int(idx[0]) & 0xffffffff
    print(f"profile -> hilbert index {hilbert:#010x} "
          f"-> RP rank {rank} (master {ov.master_of(rank)})")

    # --- 5. Store + associative query (paper Listing 3 / Fig. 5-7) -------
    st = store.init_store(capacity=64, value_dim=4, device=dev)
    st = store.store(st, prof([drone] * 4),
                     torch.arange(16, dtype=torch.float32,
                                  device=dev).reshape(4, 4))
    vals, hits, n = store.query_match(st, prof([interest])[0], max_results=4)
    print(f"wildcard query hits: {int(n)}")

    # --- 6. Rule-driven trigger (paper Listings 4-5) ---------------------
    registry = serverless.FunctionRegistry(dev)
    post_proc = P.profile("post_processing_func")
    registry.store_function("post_processing_func", post_proc,
                            lambda x: torch.tanh(x))
    engine = rules.RuleEngine([
        rules.threshold_rule("IF(RESULT >= 10)", 0, ">=", 10.0,
                             rules.C_TRIGGER_TOPOLOGY, priority=1,
                             payload="post_processing_func"),
    ])
    features = torch.tensor([[12.0], [3.0]], device=dev)
    fired, consequence = engine(features)
    triggered = []
    for i, c in enumerate(consequence.cpu().numpy()):
        if c == rules.C_TRIGGER_TOPOLOGY:
            hit = registry.start_function(
                P.ProfileBuilder().add_single("post_proc*").build())
            triggered.append(hit[0][0].name)
            print(f"item {i}: rule fired -> triggered {hit[0][0].name}")
        else:
            triggered.append(None)
            print(f"item {i}: no action")
    stats = registry.statistics()
    print("registry stats:", stats)
    return {"regions": regions, "cells": int(table.shape[0]),
            "matches": matches, "hilbert": hilbert, "rank": rank,
            "master": ov.master_of(rank), "query_hits": int(n),
            "triggered": triggered, "stats": stats}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    main(ap.parse_args().device)
