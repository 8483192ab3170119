from repro_torch.kernels.hilbert.ops import hilbert_xy2d  # noqa: F401
from repro_torch.kernels.hilbert.ref import hilbert_xy2d_ref  # noqa: F401
