"""Positional encodings: RoPE, M-RoPE (Qwen2-VL), sinusoidal (MusicGen).

Port of ``repro.models.positional``.  RoPE rotates split halves (the
first D/2 features against the last D/2), not interleaved pairs.
"""
from __future__ import annotations

import math

import torch

from repro_torch import device_constant

def rope_freqs(d_head: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, D] rotated by ang [B, T, D/2], computed in float32."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T] int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)           # [D/2]
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, int, int],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the head dim is split into (temporal,
    height, width) sections, each rotated by its own position stream.

    x: [B, T, H, D]; positions: [3, B, T] int (t/h/w, equal for text).
    sections: frequency-pair counts per component, sum == D/2.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} do not sum to {d // 2}")
    inv = rope_freqs(d, theta, x.device)                      # [D/2]
    # component id per frequency pair: [D/2] in {0,1,2}, made on the host
    # once (a captured decode step may not copy from the host)
    comp = device_constant(
        tuple(i for i, n in enumerate(sections) for _ in range(n)),
        torch.int64, x.device)
    pos_sel = positions[comp]                                 # [D/2, B, T]
    return _rotate(x, torch.movedim(pos_sel, 0, -1).float() * inv)


def sinusoidal_embedding(positions: torch.Tensor, d_model: int,
                         max_scale: float = 10000.0) -> torch.Tensor:
    """positions: [B, T] -> [B, T, d_model] float32 (MusicGen decoder)."""
    half = d_model // 2
    freq = torch.exp(-math.log(max_scale) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
