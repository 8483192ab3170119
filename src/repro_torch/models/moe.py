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

Under a batch split over N data ranks (``shardctx.batch_split``: each
rank holds the r-th of N contiguous parts of a microbatch or decode
step), the layer plans over the global batch, as the reference's does
on any mesh: the group count and capacity are those of the N x n_l
global tokens, one all-gather of every rank's expert ids a call gives
each rank the whole batch's plan (:func:`rank_plan`), and a choice is
kept iff it is in the one-process plan.  A rank's buckets hold only its
own kept choices, in the one-process bucket's order, at a local
capacity of ``min(capacity, its most tokens in one group)``: no rank
computes another's expert rows.  The load-balance loss is this rank's
exact share of the global one: with ``fe`` (integer counts, no
gradient) the global batch's, ``E sum_e me_e fe_e`` is linear in the
router probabilities, so the ranks' shares sum to it and each share's
gradient is the global loss's on this rank's tokens.  ``overflow_frac``
and ``load_max`` are the global batch's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.launch import shardctx
from repro_torch.launch.mesh import all_gather
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


def rank_plan(dest: torch.Tensor, num_experts: int, groups: int, cap: int,
              split: shardctx.BatchSplit) -> Plan:
    """The global batch's plan, from this rank's choices ``dest``
    ``[n_l * k]`` (token-major, this rank's tokens the ``split.rank``-th
    contiguous part of the global batch): one all-gather of every rank's
    ids (int32) over ``split.group``, :func:`dispatch_plan` of the
    ``[groups, N n_l k / groups]`` whole.  ``pos`` and ``keep`` are cut
    to this rank's choices (``[n_l * k]``); ``counts`` and ``overflow``
    are the global ``[groups, E]``.  No host sync: the shapes are
    static."""
    nlk = dest.shape[0]
    every = all_gather(dest.to(torch.int32), split.group).to(torch.int64)
    plan = dispatch_plan(every.reshape(groups, -1), num_experts, cap)
    lo = split.rank * nlk
    return plan._replace(pos=plan.pos.reshape(-1)[lo:lo + nlk],
                         keep=plan.keep.reshape(-1)[lo:lo + nlk])


def _expert_ffn(p, buckets: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The experts on their buckets ``[G, E, C, D]``: batched GEMMs in
    the expert-parallel compute layout ("ep"/"cap")."""
    buckets = shardctx.constrain(buckets, ("dp", "ep", "cap", None))
    if cfg.gated:
        h = F.silu(torch.einsum("gecd,edf->gecf", buckets, p["w_gate"])) \
            * torch.einsum("gecd,edf->gecf", buckets, p["w_in"])
    else:
        h = L._gelu(torch.einsum("gecd,edf->gecf", buckets, p["w_in"]))
    h = shardctx.constrain(h, ("dp", "ep", "cap", None))
    return shardctx.constrain(torch.einsum("gecf,efd->gecd", h, p["w_out"]),
                              ("dp", "ep", "cap", None))


def moe_apply(p, x: torch.Tensor, cfg: MoEConfig,
              num_groups: int | None = None) -> tuple[torch.Tensor, dict]:
    """x: [B, T, D] -> ([B, T, D], stats: ``aux_loss``, ``overflow_frac``,
    ``load_max``).  Tokens are split into G contiguous groups (GShard
    style), each with its own plan and capacity.  Under a batch split
    (``shardctx.split()``), ``x`` is this rank's share and G counts the
    global batch's groups (:func:`_moe_split`)."""
    split = shardctx.split()
    if split is not None:
        return _moe_split(p, x, cfg, split, num_groups)
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
    expert_out = _expert_ffn(p, buckets, cfg)
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


def _moe_split(p, x: torch.Tensor, cfg: MoEConfig,
               split: shardctx.BatchSplit,
               num_groups: int | None) -> tuple[torch.Tensor, dict]:
    """:func:`moe_apply` on this rank's share ``x`` ``[b, T, D]`` of a
    global batch of N x b rows: the global plan (:func:`rank_plan`), and
    buckets ``[S, E, C_l, D]`` of this rank's own kept choices, one
    segment for each global group its tokens touch (a rank's tokens may
    fill whole groups, share one group with other ranks, or both), each
    choice at its rank among this rank's choices of its segment and
    expert.  ``stats["aux_loss"]`` is this rank's share of the global
    loss; the other stats are the global batch's."""
    b, t, d = x.shape
    nl = b * t
    n = split.ranks * nl
    e, k = cfg.num_experts, cfg.top_k
    g = num_groups or _pick_groups(n)
    ng = n // g
    cap = capacity(cfg, ng)
    dev = x.device
    xt = x.reshape(nl, d)

    probs, gate_vals, expert_ids = route(xt[None], p["router"], k)
    dest = expert_ids.reshape(nl * k)
    plan = rank_plan(dest, e, g, cap, split)

    # this rank's tokens [lo, lo + nl) of the global batch, by group
    lo = split.rank * nl
    first = lo // ng
    segs = (lo + nl - 1) // ng - first + 1
    longest = max(min(lo + nl, (first + s + 1) * ng)
                  - max(lo, (first + s) * ng) for s in range(segs))
    cl = min(cap, longest)          # a token picks an expert at most once
    seg = (torch.arange(lo, lo + nl, device=dev) // ng - first) \
        .repeat_interleave(k)
    key = seg * e + dest                                     # [n_l k]
    local = dispatch_plan(key[None], segs * e, cl).pos[0]    # rank in key
    slot = torch.where(plan.keep, key * cl + local, segs * e * cl)

    def to_slots(values, dtype):
        flat = torch.zeros(segs * e * cl + 1, dtype=dtype, device=dev)
        return flat.scatter_(0, slot, values.to(dtype))[:segs * e * cl]

    tok_idx = torch.arange(nl, device=dev).repeat_interleave(k)
    idx = to_slots(tok_idx, torch.int64)                     # [S*E*C_l]
    kept = to_slots(plan.keep, torch.bool).reshape(segs, e, cl)
    gates = to_slots(gate_vals.reshape(nl * k), torch.float32) \
        .reshape(segs, e, cl)
    buckets = xt[idx].reshape(segs, e, cl, d) * kept[..., None].to(xt.dtype)
    expert_out = _expert_ffn(p, buckets, cfg)
    weighted = expert_out * (gates * kept)[..., None].to(expert_out.dtype)
    out = torch.zeros((nl, d), dtype=x.dtype, device=dev).index_add_(
        0, idx, weighted.reshape(segs * e * cl, d).to(x.dtype))
    if cfg.num_shared_experts:
        out = out + L.ffn_apply("swiglu" if cfg.gated else "gelu",
                                p["shared"], xt)

    # E sum_e me_e fe_e, me this rank's share of the global mean
    fe = torch.mean((plan.counts + plan.overflow).float(), dim=0) / ng
    me = torch.sum(probs[0], dim=0) / n
    stats = {
        "aux_loss": cfg.router_aux_weight * e * torch.sum(me * fe),
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
