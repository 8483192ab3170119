from repro_torch.kernels.fused_tick.ops import fused_tick  # noqa: F401
from repro_torch.kernels.fused_tick.ref import (  # noqa: F401
    fused_tick_ref,
    rule_sweep,
)
