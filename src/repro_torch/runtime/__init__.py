"""Runtime: health and failover, elastic scaling, stragglers, ingest
overlap (port of ``repro.runtime``; gradient compression and
``microbatched_grads`` belong to later slices)."""
from repro_torch.runtime.elastic import (ElasticBudget, rebuild_overlay,  # noqa: F401
                                         remesh, reshard_state)
from repro_torch.runtime.health import HealthMonitor  # noqa: F401
from repro_torch.runtime.overlap import IngestStager  # noqa: F401
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
