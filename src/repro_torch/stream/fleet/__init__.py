"""The edge fleet: S stream shards in ``(region, edge)`` layout ticking
on one card, and the host-side control plane that keeps them correct
through stalls and churn (port of ``repro.stream.fleet``)."""
from repro_torch.stream.fleet.control import (  # noqa: F401
    Churn,
    ControlDecision,
    Fault,
    FaultInjector,
    FaultSchedule,
    FleetController,
)
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
