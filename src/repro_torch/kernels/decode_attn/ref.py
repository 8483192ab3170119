"""Plain PyTorch version of the ``decode_attn`` kernel: GQA decode
attention against a KV cache with a length mask, computed in float32.

Port of ``repro.kernels.decode_attn.ref.decode_attn_ref``.  The CPU
path of ``ops.decode_attention`` runs it; ``chip_smoke.py`` holds the
kernel against it on the card."""
from __future__ import annotations

import torch


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q: [B, Hkv, G, D]; k, v: [B, Hkv, S, D]; lengths: [B] valid KV rows.
    Returns [B, Hkv, G, D] in q.dtype; a row of length 0 gives zeros."""
    s = k.shape[2]
    qf = q.float() * scale
    scores = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    pos = torch.arange(s, device=q.device)[None, None, None, :]
    mask = pos < lengths.to(q.device)[:, None, None, None]
    scores = torch.where(mask, scores, -torch.inf)
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, 1.0, denom)
    return torch.einsum("bhgs,bhsd->bhgd", p, v.float()).to(q.dtype)
