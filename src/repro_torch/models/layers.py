"""Shared model layers: norms, dense init, the dense FFN kinds, the
chunked scan of the recurrent kinds and ``remat``.

Port of ``repro.models.layers``.  Norms and FFNs are plain functions
on tensors; a parameter group is any mapping of names to tensors (a
dict, or an ``nn.ParameterDict`` of a module).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as _checkpoint


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
    no gradient: the serving build's.  The trainable build turns them on
    (``transformer.Transformer(..., trainable=True)``)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def ffn_apply(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN forward; MoE lives in ``models/moe.py``."""
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
# Rematerialization and the time-chunked scan
# ---------------------------------------------------------------------------

def remat(fn: Callable, *args):
    """``fn(*args)`` with its intermediates recomputed in the backward
    pass (``torch.utils.checkpoint``, non-reentrant: the reference's
    ``jax.checkpoint``) when autograd records the call, that is when
    grad is enabled and some tensor argument requires grad; a plain call
    otherwise (serving), so a call that records no graph is unchanged.
    Tensors ``fn`` reaches through its closure (parameters) are saved by
    reference, not copied."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad
            for a in _flat(args)):
        return _checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _flat(args):
    for a in args:
        if isinstance(a, (tuple, list)):
            yield from _flat(a)
        else:
            yield a


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
    axis.  The leading axis must be a multiple of ``chunk``.  Each chunk
    runs under :func:`remat`, as the reference wraps it in
    ``jax.checkpoint``: the backward pass keeps only the chunks' carries
    and recomputes each chunk's steps (flash-style memory for
    recurrences).  A call that records no graph (serving) runs its
    chunks plainly."""
    seq = isinstance(xs, (tuple, list))
    t = (xs[0] if seq else xs).shape[0]
    if t % chunk:
        raise ValueError(f"chunked_scan: {t} steps are not a multiple of "
                         f"chunk {chunk}")

    def run_chunk(carry, xc):
        ys = []
        for i in range(chunk):
            x_t = tuple(a[i] for a in xc) if seq else xc[i]
            carry, y = body(carry, x_t)
            ys.append(y)
        return carry, _stack(ys)

    carry, chunks = init, []
    for c in range(t // chunk):
        lo = c * chunk
        xc = tuple(a[lo:lo + chunk] for a in xs) if seq \
            else xs[lo:lo + chunk]
        carry, ys = remat(run_chunk, carry, xc)
        chunks.append(ys)
    if isinstance(chunks[0], (tuple, list)):
        return carry, type(chunks[0])(torch.cat(col) for col in zip(*chunks))
    return carry, torch.cat(chunks)
