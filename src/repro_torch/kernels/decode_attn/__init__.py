from repro_torch.kernels.decode_attn.ops import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attn.ref import decode_attn_ref  # noqa: F401
