from repro_torch.stream.windows import (  # noqa: F401
    apply_watermark,
    session_window,
    sliding_window,
    tumbling_window,
    window_feature_names,
    window_features,
)
from repro_torch.stream.executor import (  # noqa: F401
    StreamConfig,
    StreamExecutor,
    StreamMetrics,
    StreamState,
)
from repro_torch.stream.ingest import (  # noqa: F401
    MODE_BACKFILL,
    MODE_LIVE,
    MODE_REPLAY,
    AdmissionPlan,
    DataContract,
)
