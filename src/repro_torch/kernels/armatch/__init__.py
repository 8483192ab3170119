from repro_torch.kernels.armatch.ops import armatch  # noqa: F401
from repro_torch.kernels.armatch.ref import armatch_ref  # noqa: F401
