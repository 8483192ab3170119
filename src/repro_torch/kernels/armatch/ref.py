"""Plain PyTorch version of the ``armatch`` kernel: the associative
matching semantics of ``core.matching.match_matrix``, in plain torch
on either device and in row chunks (``matching._match_matrix_plain``),
as 0/1 int32.  The CPU path of ``ops.armatch`` runs it;
``chip_smoke.py`` holds the kernel against it on the card."""
from __future__ import annotations

import torch

from repro_torch.core import matching


def armatch_ref(data: torch.Tensor, interests: torch.Tensor) -> torch.Tensor:
    """[M,128] x [N,128] -> [M,N] int32 0/1."""
    return matching._match_matrix_plain(data, interests).to(torch.int32)
