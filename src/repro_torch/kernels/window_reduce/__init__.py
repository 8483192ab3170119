from repro_torch.kernels.window_reduce.ops import (  # noqa: F401
    sliding_reduce,
    window_reduce,
)
from repro_torch.kernels.window_reduce.ref import sliding_reduce_ref  # noqa: F401
