"""GQA attention: chunked causal forward/prefill and the cached decode step.

Port of ``repro.models.attention``.  The forward path computes the
reference's query chunks with causal KV truncation in plain torch,
without its sharding constraints, each chunk rematerialized in the
backward pass when autograd records it.  The decode step writes the new K/V
row into the ring cache in place and attends through the
``decode_attn`` wrapper (the CUDA kernel on a card tensor, its plain
version on a CPU one); ``use_kernel=False`` takes the reference's
split-KV jnp branch instead, written out in torch.

Supports: GQA/MQA/MHA, optional QKV bias (Qwen2), sliding windows,
RoPE / M-RoPE.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.decode_attn import decode_attention
from repro_torch.models import layers as L
from repro_torch.models import positional as pos_mod

NEG_INF = -1e30


class AttnConfig(NamedTuple):
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    window: int | None = None          # sliding-window size (None = full)
    rope: str = "rope"                 # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    chunk_q: int = 512


def init_attn(gen: torch.Generator, d_model: int, cfg: AttnConfig,
              dtype: torch.dtype, device: torch.device) -> dict:
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": L.dense_init(gen, d_model, h * dh, dtype, device),
         "wk": L.dense_init(gen, d_model, hkv * dh, dtype, device),
         "wv": L.dense_init(gen, d_model, hkv * dh, dtype, device),
         "wo": L.dense_init(gen, h * dh, d_model, dtype, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((width * dh,), dtype=dtype, device=device)
    return p


def _project_qkv(p, x: torch.Tensor, cfg: AttnConfig,
                 positions: torch.Tensor):
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, hkv, dh)
    v = v.reshape(b, t, hkv, dh)
    if cfg.rope == "rope":
        pos2 = positions if positions.dim() == 2 else positions[0]
        q = pos_mod.apply_rope(q, pos2, cfg.rope_theta)
        k = pos_mod.apply_rope(k, pos2, cfg.rope_theta)
    elif cfg.rope == "mrope":
        if positions.dim() != 3:
            raise ValueError("mrope needs [3, B, T] positions")
        q = pos_mod.apply_mrope(q, positions, cfg.mrope_sections,
                                cfg.rope_theta)
        k = pos_mod.apply_mrope(k, positions, cfg.mrope_sections,
                                cfg.rope_theta)
    return q, k, v


def causal_attention(p, x: torch.Tensor, positions: torch.Tensor,
                     cfg: AttnConfig) -> tuple[torch.Tensor, dict]:
    """Forward / prefill.  x: [B, T, D_model]; positions [B, T] (or
    [3, B, T] for mrope).  Returns (out [B, T, D_model], cache {k, v}
    [B, T, Hkv, dh])."""
    b, t, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = h // hkv
    q, k, v = _project_qkv(p, x, cfg, positions)
    scale = 1.0 / (dh ** 0.5)
    cq = min(cfg.chunk_q, t)
    while t % cq:          # fall back to a divisor (odd test lengths)
        cq -= 1

    def chunk_fn(qc, kc, vc, q0: int, lo: int):
        # qc: [B, cq, H, dh]; kc/vc: [B, L, hkv, dh], the causal KV slice
        qc = qc.reshape(b, cq, hkv, g, dh).float() * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc.float())
        qp = torch.arange(q0, q0 + cq, device=x.device)
        kp = torch.arange(lo, lo + kc.shape[1], device=x.device)
        mask = qp[:, None] >= kp[None, :]
        if cfg.window is not None:
            mask &= (qp[:, None] - kp[None, :]) < cfg.window
        s = torch.where(mask, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", w, vc.float())
        return o.reshape(b, cq, h * dh).to(x.dtype)

    outs = []
    # query chunks with causal KV truncation: chunk i reads keys [lo, hi);
    # each chunk is rematerialized in the backward pass (the reference's
    # jax.checkpoint of chunk_fn), so no chunk's float32 scores outlive it
    for i in range(t // cq):
        hi = (i + 1) * cq
        lo = 0 if cfg.window is None else max(0, hi - cfg.window - cq)
        outs.append(L.remat(chunk_fn, q[:, i * cq:hi], k[:, lo:hi],
                            v[:, lo:hi], i * cq, lo))
    out = torch.cat(outs, dim=1)
    return out @ p["wo"], {"k": k, "v": v}


def decode_attention_step(p, x: torch.Tensor, cache: dict,
                          lengths: torch.Tensor, cfg: AttnConfig, *,
                          use_kernel: bool = True
                          ) -> tuple[torch.Tensor, dict]:
    """One decode step.  x: [B, 1, D_model]; cache {k, v}: [B, S, Hkv, dh]
    ring buffers; lengths: [B] int32 tokens so far (cache fill).

    The new K/V row goes to slot ``lengths % S`` of ``cache`` in place
    (the reference returns a new cache): the cache passed in is the
    updated cache on return.  ``use_kernel`` attends through the
    ``decode_attn`` wrapper, which dispatches on the device;
    ``use_kernel=False`` takes the reference's split-KV jnp branch.
    Returns (out [B, 1, D_model], cache)."""
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s_cache = cache["k"].shape[1]
    positions = lengths[None, :, None].expand(3, b, 1) \
        if cfg.rope == "mrope" else lengths[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions)

    # ring-buffer write (sliding window wraps; full attn: slot == length)
    rows = torch.arange(b, device=x.device)
    slot = lengths % s_cache
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    valid = torch.clamp(lengths + 1, max=s_cache)

    if use_kernel:
        out = decode_attention(q.reshape(b, h, dh), cache["k"], cache["v"],
                               valid, num_kv_heads=hkv)
    else:
        g = h // hkv
        qg = q.reshape(b, hkv, g, dh).float() / (dh ** 0.5)
        kt = cache["k"].transpose(1, 2).float()      # [B, Hkv, S, dh]
        vt = cache["v"].transpose(1, 2).float()
        scores = torch.einsum("bhgd,bhsd->bhgs", qg, kt)
        pos = torch.arange(s_cache, device=x.device)[None, None, None, :]
        mask = pos < valid[:, None, None, None]
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
        out = torch.einsum("bhgs,bhsd->bhgd", w, vt)
        out = out.to(x.dtype).reshape(b, h, dh)
    return out.reshape(b, 1, h * dh) @ p["wo"], cache


def init_cache(cfg: AttnConfig, batch: int, seq_len: int,
               dtype: torch.dtype, device: torch.device) -> dict:
    s = seq_len if cfg.window is None else min(seq_len, cfg.window)
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Attention(nn.Module):
    """GQA attention over the parameter group ``params`` (``init_attn``'s
    names), for the configuration ``cfg``."""

    def __init__(self, cfg: AttnConfig, params: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.p = L.frozen(params)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
        return causal_attention(self.p, x, positions, self.cfg)

    def decode(self, x: torch.Tensor, cache: dict, lengths: torch.Tensor,
               *, use_kernel: bool = True) -> tuple[torch.Tensor, dict]:
        return decode_attention_step(self.p, x, cache, lengths, self.cfg,
                                     use_kernel=use_kernel)
