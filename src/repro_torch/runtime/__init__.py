"""Runtime: health and failover, elastic scaling, stragglers, ingest
overlap, microbatched gradients and gradient compression (port of
``repro.runtime``)."""
from repro_torch.runtime.compression import (CompressedGrad,  # noqa: F401
                                             compress_tree,
                                             cross_pod_allreduce,
                                             decompress_tree, dequantize,
                                             init_errors, quantize)
from repro_torch.runtime.elastic import (ElasticBudget, rebuild_overlay,  # noqa: F401
                                         remesh, reshard_state)
from repro_torch.runtime.health import HealthMonitor  # noqa: F401
from repro_torch.runtime.overlap import (IngestStager,  # noqa: F401
                                         microbatched_grads)
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
