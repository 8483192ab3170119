from repro_torch.kernels.stage_mark.ops import stage_mark  # noqa: F401
from repro_torch.kernels.stage_mark.ref import stage_mark_ref  # noqa: F401
