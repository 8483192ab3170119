"""The optimizer: AdamW with global-norm clipping and the learning-rate
schedule (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, global_norm,  # noqa: F401
                                     init, update)
from repro_torch.optim.schedule import cosine_with_warmup  # noqa: F401
