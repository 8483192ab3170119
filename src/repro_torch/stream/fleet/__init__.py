"""The edge fleet's data plane: S stream shards in ``(region, edge)``
layout ticking on one card (port of ``repro.stream.fleet``; its control
plane, ``control.py``, is not ported yet)."""
from repro_torch.stream.fleet.executor import (  # noqa: F401
    FleetConfig,
    FleetExecutor,
    FleetMetrics,
    FleetState,
)
from repro_torch.stream.fleet.federation import (  # noqa: F401
    FederationStats,
    LineageTaps,
    TieredStats,
    allreduce_metrics,
    federate_escalations,
    federate_escalations_tiered,
    fleet_watermark,
    layered_min_ref,
    tiered_watermark,
    tiered_watermark_ref,
)
from repro_torch.stream.fleet.routing import (  # noqa: F401
    TieredExchange,
    fog_recv_occupancy,
    region_survivor_counts,
)
