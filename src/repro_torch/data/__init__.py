"""Device-resident data structures (the ring buffer) and the training
data pipeline (``SyntheticTokens``, ``Prefetcher``)."""
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens  # noqa: F401
