"""Shared model layers: norms, dense init, the dense FFN kinds.

Port of ``repro.models.layers`` (``chunked_scan``, a training helper
of the recurrent kinds, is left out).  Norms and FFNs are plain
functions on tensors; a parameter group is any mapping of names to
tensors (a dict, or an ``nn.ParameterDict`` of a module).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


def init_norm(kind: str, d: int, dtype: torch.dtype,
              device: torch.device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    """``[d_in, d_out]`` standard normals times ``scale`` (default
    ``1/sqrt(d_in)``), drawn in float32 and cast to ``dtype``."""
    s = scale if scale is not None else 1.0 / (d_in ** 0.5)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * s).to(dtype)


def frozen(params: dict) -> nn.ParameterDict:
    """A parameter group as an ``nn.ParameterDict`` of tensors that take
    no gradient (the port serves; it does not train yet)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn_apply(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN forward; MoE lives in ``repro.models.moe`` (not ported)."""
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    if kind == "geglu":
        return (_gelu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    if kind == "sq_relu":   # Nemotron-4 squared ReLU, non-gated
        h = torch.relu(x @ p["w_in"])
        return (h * h) @ p["w_out"]
    if kind == "gelu":      # plain 2-layer GELU (MusicGen-style decoder FFN)
        return _gelu(x @ p["w_in"]) @ p["w_out"]
    raise ValueError(f"unknown ffn kind {kind!r}")


def ffn_init(kind: str, gen: torch.Generator, d: int, f: int,
             dtype: torch.dtype, device: torch.device) -> dict:
    p = {"w_in": dense_init(gen, d, f, dtype, device),
         "w_out": dense_init(gen, f, d, dtype, device)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(gen, d, f, dtype, device)
    return p


class FFN(nn.Module):
    """A dense FFN of kind ``kind`` over the parameter group ``params``."""

    def __init__(self, kind: str, params: dict) -> None:
        super().__init__()
        self.kind = kind
        self.p = frozen(params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ffn_apply(self.kind, self.p, x)
