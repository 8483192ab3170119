"""AdamW with global-norm clipping; moment dtype configurable (the Kimi
config keeps bfloat16 moments).

Port of ``repro.optim.adamw`` as plain tensor ops in the reference's
order (not ``torch.optim.AdamW``, whose arithmetic differs): the clip
scale ``min(1, clip / (gnorm + 1e-9))``, bias corrections from the step
as float32, the decoupled decay inside ``delta``, the new parameter cast
back to its dtype and the moments kept in ``moment_dtype``.

Parameters, gradients and moments are mappings of names to tensors in
one order (a model's ``named_parameters()``; a module may stand for its
parameters).  ``update`` writes the parameters and the moments in place
under ``torch.no_grad()``.  The global norm sums the leaves in that
order; the reference sums them in ``jax.tree_util`` order (sorted
keys), so the two agree to rounding, not bitwise.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch import nn


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32


class AdamWState(NamedTuple):
    m: dict                     # name -> first moment (``moment_dtype``)
    v: dict                     # name -> second moment
    step: torch.Tensor          # [] int32 updates taken


def _named(params) -> Mapping[str, torch.Tensor]:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else params


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, step
    0 on the parameters' device."""
    params = _named(params)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device) for n, p in params.items()}

    dev = next(iter(params.values())).device
    return AdamWState(m=zeros(), v=zeros(),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: AdamWState, params,
           cfg: AdamWConfig, lr_scale: torch.Tensor | float = 1.0):
    """One AdamW step, in place.  Returns (params, the new state,
    ``{"grad_norm"}``): the same parameter and moment tensors, written,
    and a new step counter."""
    named = _named(params)
    gnorm = global_norm({n: grads[n] for n in named})
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale
    for n, p in named.items():
        m, v = state.m[n], state.v[n]
        gf = grads[n].to(torch.float32) * scale
        m1 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        v1 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * gf * gf
        del gf
        mh = m1 / b1c
        vh = v1 / b2c
        m.copy_(m1)
        v.copy_(v1)
        del m1, v1
        delta = mh / (torch.sqrt(vh) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        del mh, vh
        p.copy_(p.to(torch.float32) - lr * delta)
    return params, AdamWState(state.m, state.v, step), {"grad_norm": gnorm}
