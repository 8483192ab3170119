"""RecurrentGemma / Griffin RG-LRU recurrent block.

Port of ``repro.models.griffin``.  Block: x -> (linear -> GeLU gate) ||
(linear -> causal conv1d(w=4) -> RG-LRU) -> elementwise product ->
linear out.  The RG-LRU recurrence:
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = a^(c * r_t)        (a = sigmoid(lambda), c = 8, per-channel)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
State is a float32 ``[B, D_rnn]`` vector and a ``[B, W-1, D_rnn]`` conv
tail in the compute dtype: O(1) decode.  The order of operations and
the dtypes are the reference's, which bfloat16 results depend on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L


class RGLRUConfig(NamedTuple):
    d_rnn: int                # recurrence width (= d_model in RecurrentGemma)
    conv_width: int = 4
    c: float = 8.0
    chunk: int = 256
    # probe mode (dry-run cost analysis only, launch/probe.py): a
    # loop-free, FLOP-isomorphic stand-in for the recurrence.  NOT a
    # valid forward pass.
    probe: bool = False


def init_rglru_block(gen: torch.Generator, d_model: int, cfg: RGLRUConfig,
                     dtype: torch.dtype,
                     device: str | torch.device | None = None) -> dict:
    """The block's parameters, drawn from ``gen`` on ``device`` (``None``:
    the card): the reference's shapes and scales."""
    dev = resolve_device(device)
    dr = cfg.d_rnn
    conv_w = torch.randn((cfg.conv_width, dr), generator=gen,
                         dtype=torch.float32, device=dev)
    return {
        "w_gate": L.dense_init(gen, d_model, dr, dtype, dev),
        "w_x": L.dense_init(gen, d_model, dr, dtype, dev),
        "conv_w": (conv_w / (cfg.conv_width ** 0.5)).to(dtype),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=dev),
        "rg_wa": L.dense_init(gen, dr, dr, dtype, dev),
        "rg_wx": L.dense_init(gen, dr, dr, dtype, dev),
        "rg_lambda": torch.full((dr,), 2.2, dtype=dtype, device=dev),
        "w_out": L.dense_init(gen, dr, d_model, dtype, dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: [B,T,D]; w: [W,D]; tail: [B,W-1,D].
    Returns (out [B,T,D], the new tail)."""
    width, t = w.shape[0], x.shape[1]
    xp = torch.cat([tail, x], dim=1)                         # [B, T+W-1, D]
    # summed from Python 0 in x's dtype, tap by tap, then + b: in bf16
    # every partial sum rounds, as the reference's do
    out = sum(xp[:, i:i + t, :] * w[i] for i in range(width)) + b
    return out.to(x.dtype), xp[:, -(width - 1):, :]


def _step(h: torch.Tensor, inp: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    a_t, d_t = inp
    h = a_t * h + d_t
    return h, h


def rglru_block_apply(p, x: torch.Tensor, cfg: RGLRUConfig,
                      state: dict | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """x: [B, T, D_model].  state: {"h": [B,Dr] f32, "conv": [B,W-1,Dr]}
    (``None``: zeros).  Returns (out [B, T, D_model], the new state).
    ``cfg.probe``: the reference's cost-analysis stand-in, not a valid
    model (see :class:`RGLRUConfig`)."""
    b, t, _ = x.shape
    dr = cfg.d_rnn
    if state is None:
        state = {"h": torch.zeros((b, dr), dtype=torch.float32,
                                  device=x.device),
                 "conv": torch.zeros((b, cfg.conv_width - 1, dr),
                                     dtype=x.dtype, device=x.device)}
    gate = L._gelu(x @ p["w_gate"])                          # [B,T,Dr]
    u = x @ p["w_x"]
    u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])

    r = torch.sigmoid((u @ p["rg_wa"]).float())
    i = torch.sigmoid((u @ p["rg_wx"]).float())
    log_a = cfg.c * r * F.logsigmoid(p["rg_lambda"].float())
    a = torch.exp(log_a)                                     # [B,T,Dr] in (0,1)
    gated_in = i * u.float()
    drive = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated_in

    a_t, d_t = a.movedim(1, 0), drive.movedim(1, 0)          # [T,B,Dr]
    if cfg.probe:
        # per step: a*h + drive -> one mult + add over [T,B,Dr]
        ys = a_t * d_t + d_t
        h = state["h"] + ys[-1]
    elif t == 1:
        h, ys = _step(state["h"], (a_t[0], d_t[0]))
        ys = ys[None]
    else:
        chunk = min(cfg.chunk, t)
        while t % chunk:
            chunk -= 1
        h, ys = L.chunked_scan(_step, state["h"], (a_t, d_t), chunk=chunk)
    y = ys.movedim(0, 1).to(x.dtype)                         # [B,T,Dr]
    out = (y * gate) @ p["w_out"]
    return out, {"h": h, "conv": conv_state}
