"""Mixture-of-Experts FFN with capacity-bounded dispatch.

Port of ``repro.models.moe``, its ``shardctx`` constraints in place
(identities outside a sharding context and on plain tensors).  The
dispatch is the reference's own sort-based plan (``dispatch_plan``),
not ``core/routing.make_plan``: a stable sort of each (token, k)
choice's expert, a running max of the segment starts, and each choice's
rank within its expert, kept below the capacity.  Gather/scatter with
static shapes: router -> top-k experts -> plan -> gather tokens into
``[G, E, C, D]`` buckets -> batched expert GEMMs -> weighted
scatter-add.  Overflowed choices fall through with zero update and are
counted in the stats.

Ties and order, against the reference:

* the top k come from a stable descending sort, so among equal router
  probabilities the lower expert index comes first, as
  ``jax.lax.top_k`` keeps it (``torch.topk`` promises no order);
* the router multiplies its compute-dtype operands in float32, as the
  reference's einsum does with ``preferred_element_type``;
* the scatter-add is ``index_add_``, which on a CUDA tensor adds in no
  fixed order: at top-2 from zero the sum is exact whatever the order,
  at top-8 (Kimi-K2) it is not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.launch import shardctx
from repro_torch.models import layers as L


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    gated: bool = True                 # SwiGLU experts (Mixtral/Kimi style)
    num_shared_experts: int = 0        # Kimi/DeepSeek shared expert(s)
    router_aux_weight: float = 0.01    # load-balance loss weight


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype,
             device: str | torch.device | None = None) -> dict:
    """Router (float32), experts and shared experts drawn from ``gen``
    on ``device`` (``None``: the card): the reference's shapes and
    scales."""
    dev = resolve_device(device)
    e, f = cfg.num_experts, cfg.d_ff

    def experts(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w / (d_in ** 0.5)).to(dtype)

    p = {"router": L.dense_init(gen, d_model, e, torch.float32, dev),
         "w_in": experts(d_model, f),
         "w_out": experts(f, d_model)}
    if cfg.gated:
        p["w_gate"] = experts(d_model, f)
    if cfg.num_shared_experts:
        p["shared"] = L.ffn_init("swiglu" if cfg.gated else "gelu", gen,
                                 d_model, f * cfg.num_shared_experts, dtype,
                                 dev)
    return p


def capacity(cfg: MoEConfig, n_tokens: int) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8 for tiling


def _pick_groups(n: int, target: int = 4096) -> int:
    g = max(1, n // target)
    while n % g:
        g -= 1
    return g


class Plan(NamedTuple):
    """A group's dispatch: each (token, k) choice's rank within its
    expert and whether it fits, and each expert's load."""
    pos: torch.Tensor           # [G, NK] int32 rank within the expert
    keep: torch.Tensor          # [G, NK] bool, pos < capacity
    counts: torch.Tensor        # [G, E] int32 kept choices, <= capacity
    overflow: torch.Tensor      # [G, E] int32 choices past capacity


def dispatch_plan(dest: torch.Tensor, num_experts: int, cap: int) -> Plan:
    """The reference's sort-based plan of ``dest`` ``[G, NK]`` (each
    choice's expert, in token-major order): a choice's rank is the count
    of earlier choices in its group with the same expert."""
    g, nk = dest.shape
    dev = dest.device
    sidx = torch.argsort(dest, dim=1, stable=True)
    d_sorted = torch.gather(dest, 1, sidx)
    ar = torch.arange(nk, device=dev).expand(g, nk)
    is_start = torch.cat([torch.ones((g, 1), dtype=torch.bool, device=dev),
                          d_sorted[:, 1:] != d_sorted[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    pos = torch.empty((g, nk), dtype=torch.int64, device=dev) \
        .scatter_(1, sidx, ar - seg_start).to(torch.int32)
    raw = torch.zeros((g, num_experts), dtype=torch.int32, device=dev) \
        .scatter_add_(1, dest, torch.ones_like(dest, dtype=torch.int32))
    counts = torch.clamp(raw, max=cap)
    return Plan(pos, pos < cap, counts, raw - counts)


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """The router of ``moe_apply``: tokens ``[G, Ng, D]`` -> (router
    probabilities ``[G, Ng, E]`` float32, the top ``k`` gate values
    renormalised to sum to 1, their expert ids ``[G, Ng, k]``, highest
    first, the lower id first among equals)."""
    logits = xt.float() @ router.float()                     # [G, Ng, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :k], expert_ids[..., :k]
    return probs, gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True), \
        expert_ids


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig,
              num_groups: int | None = None) -> tuple[torch.Tensor, dict]:
    """x: [B, T, D] -> ([B, T, D], stats: ``aux_loss``, ``overflow_frac``,
    ``load_max``).  Tokens are split into G contiguous groups (GShard
    style), each with its own plan and capacity."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.num_experts, cfg.top_k
    g = num_groups or _pick_groups(n)
    ng = n // g
    xt = shardctx.constrain(x.reshape(g, ng, d), ("dp", None, None))
    dev = x.device

    probs, gate_vals, expert_ids = route(xt, p["router"], k)

    cap = capacity(cfg, ng)
    dest = expert_ids.reshape(g, ng * k)                     # [G, NK] int64
    plan = dispatch_plan(dest, e, cap)

    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=(0, 1))                       # router prob mass
    fe = torch.mean((plan.counts + plan.overflow).float(), dim=0) / ng
    aux_loss = cfg.router_aux_weight * e * torch.sum(me * fe)

    tok_idx = torch.arange(ng, device=dev).repeat_interleave(k) \
        .expand(g, ng * k)
    slot = dest * cap + torch.clamp(plan.pos, 0, cap - 1)
    safe_slot = torch.where(plan.keep, slot, e * cap)        # e*cap = trash

    def to_slots(values, dtype):
        flat = torch.zeros((g, e * cap + 1), dtype=dtype, device=dev)
        return flat.scatter_(1, safe_slot, values.to(dtype))[:, :e * cap]

    idx = to_slots(tok_idx, torch.int64)                     # [G, E*C]
    kept = to_slots(plan.keep, torch.bool).reshape(g, e, cap)
    gates = to_slots(gate_vals.reshape(g, ng * k), torch.float32) \
        .reshape(g, e, cap)

    buckets = torch.gather(xt, 1, idx[..., None].expand(g, e * cap, d)) \
        .reshape(g, e, cap, d)
    buckets = buckets * kept[..., None].to(xt.dtype)         # [G, E, C, D]
    # the expert-parallel compute layout ("ep"/"cap")
    buckets = shardctx.constrain(buckets, ("dp", "ep", "cap", None))
    if cfg.gated:
        h = F.silu(torch.einsum("gecd,edf->gecf", buckets, p["w_gate"])) \
            * torch.einsum("gecd,edf->gecf", buckets, p["w_in"])
    else:
        h = L._gelu(torch.einsum("gecd,edf->gecf", buckets, p["w_in"]))
    h = shardctx.constrain(h, ("dp", "ep", "cap", None))
    expert_out = shardctx.constrain(
        torch.einsum("gecf,efd->gecd", h, p["w_out"]),
        ("dp", "ep", "cap", None))
    weighted = expert_out * (gates * kept)[..., None].to(expert_out.dtype)
    rows = (idx + torch.arange(g, device=dev)[:, None] * ng).reshape(-1)
    out = torch.zeros((g * ng, d), dtype=x.dtype, device=dev).index_add_(
        0, rows, weighted.reshape(g * e * cap, d).to(x.dtype))
    out = shardctx.constrain(out.reshape(g, ng, d), ("dp", None, None))

    if cfg.num_shared_experts:
        out = out + L.ffn_apply("swiglu" if cfg.gated else "gelu",
                                p["shared"], xt)

    stats = {
        "aux_loss": aux_loss,
        "overflow_frac": torch.sum(plan.overflow) / (n * k),
        "load_max": torch.max(plan.counts) / cap,
    }
    return out.reshape(b, t, d), stats


class MoE(nn.Module):
    """The MoE FFN over the parameter group ``params`` (``init_moe``'s
    names, ``shared`` a nested group) for the configuration ``cfg``."""

    def __init__(self, cfg: MoEConfig, params: dict) -> None:
        super().__init__()
        self.cfg = cfg
        params = dict(params)
        shared = params.pop("shared", None)
        self.p = L.frozen(params)
        self.shared = None if shared is None else L.frozen(shared)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        p = dict(self.p.items())
        if self.shared is not None:
            p["shared"] = self.shared
        return moe_apply(p, x, self.cfg)
