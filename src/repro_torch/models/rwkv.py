"""RWKV-6 "Finch" blocks: data-dependent-decay linear recurrence.

Port of ``repro.models.rwkv``.  Time mixing: a per-head matrix state
S [Dk, Dv], per-channel decay w_t = exp(-exp(ww_t)) with a low-rank
data-dependent component, a bonus term u on the current token, an
output group norm and a SiLU gate.  Channel mixing: token-shifted
squared ReLU.  r, k, v and the wkv state are float32, ``g`` stays in
the compute dtype, as in the reference.  A sequence runs the
recurrence through ``layers.chunked_scan``; decode takes one step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L


class RWKVConfig(NamedTuple):
    n_heads: int
    d_head: int
    decay_lora: int = 64
    chunk: int = 64
    # probe mode (dry-run cost analysis only, launch/probe.py): replace
    # the sequential wkv scan with a loop-free, FLOP-isomorphic
    # emulation.  NOT a valid forward pass.
    probe: bool = False


def init_time_mix(gen: torch.Generator, d_model: int, cfg: RWKVConfig,
                  dtype: torch.dtype,
                  device: str | torch.device | None = None) -> dict:
    """Time-mix parameters drawn from ``gen`` on ``device`` (``None``:
    the card): the reference's shapes and scales."""
    dev = resolve_device(device)
    h, dh = cfg.n_heads, cfg.d_head
    dim = h * dh

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    p = {f"mu_{n}": full((d_model,), 0.5) for n in "rkvwg"}
    for n in ("wr", "wk", "wv", "wg"):
        p[n] = L.dense_init(gen, d_model, dim, dtype, dev)
    p["wo"] = L.dense_init(gen, dim, d_model, dtype, dev)
    # data-dependent decay (Finch): w = base + lora
    p["w_base"] = full((dim,), -4.0)
    p["w_lora_a"] = L.dense_init(gen, d_model, cfg.decay_lora, dtype, dev)
    p["w_lora_b"] = L.dense_init(gen, cfg.decay_lora, dim, dtype, dev,
                                 scale=0.01)
    p["bonus_u"] = full((h, dh), 0.0)
    p["ln_scale"] = full((h, dh), 1.0)
    return p


def init_channel_mix(gen: torch.Generator, d_model: int, d_ff: int,
                     dtype: torch.dtype,
                     device: str | torch.device | None = None) -> dict:
    """Channel-mix parameters drawn from ``gen`` on ``device`` (``None``:
    the card)."""
    dev = resolve_device(device)
    return {
        "mu_k": torch.full((d_model,), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((d_model,), 0.5, dtype=dtype, device=dev),
        "wk": L.dense_init(gen, d_model, d_ff, dtype, dev),
        "wv": L.dense_init(gen, d_ff, d_model, dtype, dev),
        "wr": L.dense_init(gen, d_model, d_model, dtype, dev),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x[t-1] with ``prev`` feeding position 0.  x: [B,T,D]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu.to(x.dtype)


def _wkv_step(state, inputs):
    """state: [B,H,Dk,Dv]; inputs r,k,v: [B,H,D*], w: [B,H,Dk], u: [H,Dk]."""
    r, k, v, w, u = inputs
    kv = k[..., :, None] * v[..., None, :]                  # [B,H,Dk,Dv]
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    state = w[..., None] * state + kv
    return state, y


def time_mix_apply(p, x: torch.Tensor, cfg: RWKVConfig,
                   state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """x: [B, T, D].  state (decode): {"shift": [B,D], "wkv": [B,H,Dk,Dv]}
    (``None``: zeros).  Returns (out, the new state).  ``cfg.probe``:
    the reference's cost-analysis stand-in, not a valid model (see
    :class:`RWKVConfig`)."""
    b, t, d = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    if state is None:
        state = {"shift": torch.zeros((b, d), dtype=x.dtype, device=x.device),
                 "wkv": torch.zeros((b, h, dh, dh), dtype=torch.float32,
                                    device=x.device)}
    xs = _shift(x, state["shift"])

    def proj(mu, w):
        return (_mix(x, xs, p[mu]) @ p[w]).reshape(b, t, h, dh)

    r = proj("mu_r", "wr").float()
    k = proj("mu_k", "wk").float()
    v = proj("mu_v", "wv").float()
    g = proj("mu_g", "wg")
    xw = _mix(x, xs, p["mu_w"])
    ww = p["w_base"].float() + (
        torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    w = torch.exp(-torch.exp(torch.clamp(ww, -20.0, 4.0))).reshape(b, t, h, dh)
    u = p["bonus_u"].float()

    def body(s, inp):
        rr, kk, vv, wwv = inp
        return _wkv_step(s, (rr, kk, vv, wwv, u))

    seq = tuple(a.movedim(1, 0) for a in (r, k, v, w))      # [T,B,H,dh]
    if cfg.probe:
        # per step: kv outer + decay mult + bonus + r-contraction,
        # batched over T
        r_t, k_t, v_t, w_t = seq
        kv = k_t[..., :, None] * v_t[..., None, :]          # [T,B,H,dk,dv]
        sw = w_t[..., None] * kv                             # ~ w*S mult
        y = torch.einsum("tbhk,tbhkv->tbhv", r_t,
                         sw + u[None, None, :, :, None] * kv)
        wkv_state = state["wkv"] + sw[-1]
    elif t == 1:
        wkv_state, y = body(state["wkv"], tuple(a[0] for a in seq))
        y = y[None]
    else:
        chunk = min(cfg.chunk, t)
        while t % chunk:
            chunk -= 1
        wkv_state, y = L.chunked_scan(body, state["wkv"], seq, chunk=chunk)
    y = y.movedim(0, 1).reshape(b, t, h, dh)                 # [B,T,H,dh]
    # per-head group norm, in float32, cast before the silu gate
    y = L.rms_norm(y, torch.ones((dh,), dtype=torch.float32,
                                 device=x.device), 1e-5) \
        * p["ln_scale"].float()
    y = (y.to(x.dtype) * F.silu(g)).reshape(b, t, h * dh)
    out = y @ p["wo"]
    return out, {"shift": x[:, -1, :], "wkv": wkv_state}


def channel_mix_apply(p, x: torch.Tensor, state: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel mix.  state: [B, D] previous token (decode; ``None``:
    zeros).  Returns (out, the new state)."""
    b, t, d = x.shape
    if state is None:
        state = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _shift(x, state)
    k = torch.square(torch.relu(_mix(x, xs, p["mu_k"]) @ p["wk"]))
    r = torch.sigmoid(_mix(x, xs, p["mu_r"]) @ p["wr"])
    return r * (k @ p["wv"]), x[:, -1, :]
