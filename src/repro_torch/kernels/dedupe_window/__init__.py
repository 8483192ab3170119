from repro_torch.kernels.dedupe_window.ops import (  # noqa: F401
    EMPTY_HASH,
    FNV_BASIS,
    FNV_PRIME,
    dedupe_window,
    row_hash,
    seen_record,
)
