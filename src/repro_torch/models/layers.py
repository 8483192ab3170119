"""Shared model layers: norms, dense init, the dense FFN kinds and the
chunked scan of the recurrent kinds.

Port of ``repro.models.layers``.  Norms and FFNs are plain functions
on tensors; a parameter group is any mapping of names to tensors (a
dict, or an ``nn.ParameterDict`` of a module).
"""
from __future__ import annotations

from typing import Callable

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


# ---------------------------------------------------------------------------
# Time-chunked scan
# ---------------------------------------------------------------------------

def _stack(ys: list):
    """A list of step outputs (tensors, or tuples of them) -> the outputs
    stacked along a new leading axis, with the steps' structure."""
    if isinstance(ys[0], (tuple, list)):
        return type(ys[0])(torch.stack(col) for col in zip(*ys))
    return torch.stack(ys)


def chunked_scan(body: Callable, init, xs, *, chunk: int):
    """``lax.scan(body, init, xs)`` over the leading axis in chunks of
    ``chunk`` steps: ``body(carry, x_t) -> (carry, y_t)``, where ``xs``
    is a tensor or a tuple of tensors and ``x_t`` its slices at step t.
    Returns ``(carry, ys)``, the ``y_t`` stacked along a new leading
    axis.  The leading axis must be a multiple of ``chunk``.  The
    reference wraps each chunk in ``jax.checkpoint`` for its backward
    pass; the port serves, so it keeps the chunking contract only."""
    seq = isinstance(xs, (tuple, list))
    t = (xs[0] if seq else xs).shape[0]
    if t % chunk:
        raise ValueError(f"chunked_scan: {t} steps are not a multiple of "
                         f"chunk {chunk}")
    carry, chunks = init, []
    for c in range(t // chunk):
        ys = []
        for i in range(c * chunk, (c + 1) * chunk):
            x_t = tuple(a[i] for a in xs) if seq else xs[i]
            carry, y = body(carry, x_t)
            ys.append(y)
        chunks.append(_stack(ys))
    if isinstance(chunks[0], (tuple, list)):
        return carry, type(chunks[0])(torch.cat(col) for col in zip(*chunks))
    return carry, torch.cat(chunks)
