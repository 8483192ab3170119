"""The decoder stack, ported from ``repro.models.transformer``.

An architecture is an ``ArchConfig``: a layer pattern (cycled kinds:
attention, RWKV6, RG-LRU recurrent), an FFN kind (the dense kinds or
MoE), attention geometry and embedding geometry (dtypes are
``torch.dtype``).  The model is a ``Transformer`` module: the
embedding, the final norm, the unembedding and one layer module a layer
(``DecoderLayer`` for ``attn+dense`` and ``attn+moe``, ``RWKVLayer``,
``RecurrentLayer``), driven by a Python loop (the reference scans
stacked layers with ``lax.scan``).

Casts.  The reference casts every layer's parameters to
``compute_dtype`` on each call (``_cast_params``).  The serving build
casts them once, when the model is built, to the same values, and its
parameters take no gradient.  The trainable build
(``init_params(..., trainable=True)``, ``convert.train_model_from_numpy``)
keeps the ``param_dtype`` master weights with ``requires_grad`` and
casts each layer's on every call, inside the autograd graph, so that
gradients land in ``param_dtype``; each layer then runs under
``layers.remat`` when autograd records it (the reference's per-group
``jax.checkpoint``).  In both builds, as in the reference, ``embed``
stays in ``param_dtype`` and is gathered before the cast,
``final_norm`` stays uncast, and ``unembed`` is cast to the
activations' dtype (``compute_dtype``): once when serving, on every
call when training (from ``embed.t()`` when tied).

Caches: one a layer, ``{k, v}`` ring buffers for attention,
``{"tmix": {"shift", "wkv"}, "cmix"}`` for RWKV6 and
``{"rec": {"h", "conv"}}`` for RG-LRU; a decode step updates them in
place.

Entry points: ``forward``, ``loss_fn``, ``prefill`` and ``decode_step``.
The training forward is the cache-free path: nothing on it writes in
place into a tensor that autograd saved.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import griffin as G
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import positional as pos_mod
from repro_torch.models import rwkv as W


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    pattern: tuple = ("attn",)          # cycled layer kinds
    ffn: str = "swiglu"                 # dense ffn kind or "moe"
    moe: M.MoEConfig | None = None
    first_k_dense: int = 0              # leading dense-FFN layers (Kimi)
    qkv_bias: bool = False
    window: int | None = None
    rope: str = "rope"                  # "rope" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    pos_emb: str = "none"               # "none" | "sinusoidal"
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    rwkv: W.RWKVConfig | None = None
    rglru: G.RGLRUConfig | None = None
    vlm: bool = False                   # expects vision_embeds in the batch
    modality: str = "text"              # doc tag: text | vision | audio
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    chunk_q: int = 512
    # long-context capability tag: full attention archs skip long_500k
    subquadratic: bool = False

    # ---- derived ----
    def attn_cfg(self) -> A.AttnConfig:
        return A.AttnConfig(self.n_heads, self.n_kv_heads, self.d_head,
                            self.qkv_bias, self.window, self.rope,
                            self.rope_theta, self.mrope_sections, self.chunk_q)

    def layer_kinds(self) -> list[str]:
        """Each layer's kind: ``attn+dense``, ``attn+moe``, ``rwkv``, ``rec``."""
        kinds = []
        for i in range(self.n_layers):
            k = self.pattern[i % len(self.pattern)]
            if k == "attn":
                f = "dense" if (self.ffn != "moe" or i < self.first_k_dense) \
                    else "moe"
                kinds.append(f"attn+{f}")
            else:
                kinds.append(k)
        return kinds

    def stacks(self) -> list[tuple[tuple[str, ...], int]]:
        """Layer plan as (kinds-per-group, repeat) with heterogeneous
        prefixes (first_k_dense) and pattern tails split off: the
        reference's stacking, which ``convert`` reads."""
        kinds = self.layer_kinds()
        out: list[tuple[tuple[str, ...], int]] = []
        g = len(self.pattern)
        i = 0
        while i < len(kinds):
            # greedily take maximal repeats of the next group of size g
            group = tuple(kinds[i:i + g])
            r = 1
            while kinds[i + r * g: i + (r + 1) * g] == list(group):
                r += 1
            out.append((group, r))
            i += r * g
        return out


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _cast(params: dict, dtype: torch.dtype | None) -> dict:
    """``params`` with its floating leaves cast to ``dtype`` (``None``:
    as they are, the trainable build's)."""
    if dtype is None:
        return params
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def _dense_ffn(cfg: ArchConfig) -> str:
    """The FFN kind of a dense attention layer: SwiGLU for the leading
    dense layers of a MoE config (Kimi-K2's first)."""
    return cfg.ffn if cfg.ffn != "moe" else "swiglu"


class DecoderLayer(nn.Module):
    """One attention layer, ``attn+dense`` or ``attn+moe``: pre-norm
    residual attention, then the dense FFN or the MoE, its parameters
    cast to ``dt`` once, here (``None``: kept as given)."""

    def __init__(self, cfg: ArchConfig, params: dict, kind: str,
                 dt: torch.dtype | None) -> None:
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm1 = L.frozen(_cast(params["norm1"], dt))
        self.norm2 = L.frozen(_cast(params["norm2"], dt))
        self.attn = A.Attention(cfg.attn_cfg(), _cast(params["attn"], dt))
        if kind == "attn+moe":
            self.ffn, self.moe = None, M.MoE(cfg.moe, _cast(params["moe"], dt))
        else:
            self.ffn = L.FFN(_dense_ffn(cfg), _cast(params["ffn"], dt))
            self.moe = None

    def forward(self, x, positions, cache: dict | None = None, lengths=None,
                *, use_kernel: bool = True):
        """(x, cache, MoE stats or None): the cache is the layer's KV
        (forward) or the decode cache updated in place (``cache``
        given)."""
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, x, self.norm1, cfg.norm_eps)
        if cache is not None:
            a_out, new_cache = self.attn.decode(h, cache, lengths,
                                                use_kernel=use_kernel)
        else:
            a_out, new_cache = self.attn(h, positions)
        x = x + a_out
        h = L.apply_norm(cfg.norm, x, self.norm2, cfg.norm_eps)
        if self.moe is not None:
            f_out, stats = self.moe(h)
            return x + f_out, new_cache, stats
        return x + self.ffn(h), new_cache, None


def _update(cache: dict, new: dict) -> dict:
    """Copy the state ``new`` into ``cache`` (same nesting) in place."""
    for k, v in new.items():
        if isinstance(v, dict):
            _update(cache[k], v)
        else:
            cache[k].copy_(v)
    return cache


class RWKVLayer(nn.Module):
    """One ``rwkv`` layer: pre-norm residual time mix, then channel mix."""

    kind = "rwkv"

    def __init__(self, cfg: ArchConfig, params: dict,
                 dt: torch.dtype | None) -> None:
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.frozen(_cast(params["norm1"], dt))
        self.norm2 = L.frozen(_cast(params["norm2"], dt))
        self.tmix = L.frozen(_cast(params["tmix"], dt))
        self.cmix = L.frozen(_cast(params["cmix"], dt))

    def forward(self, x, positions, cache: dict | None = None, lengths=None,
                *, use_kernel: bool = True):
        """(x, state, None): the new state (forward), or ``cache``
        updated in place (decode)."""
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, x, self.norm1, cfg.norm_eps)
        t_out, tstate = W.time_mix_apply(
            self.tmix, h, cfg.rwkv, None if cache is None else cache["tmix"])
        x = x + t_out
        h = L.apply_norm(cfg.norm, x, self.norm2, cfg.norm_eps)
        c_out, cstate = W.channel_mix_apply(
            self.cmix, h, None if cache is None else cache["cmix"])
        new = {"tmix": tstate, "cmix": cstate}
        return x + c_out, new if cache is None else _update(cache, new), None


class RecurrentLayer(nn.Module):
    """One ``rec`` layer: pre-norm residual RG-LRU block, then the FFN."""

    kind = "rec"

    def __init__(self, cfg: ArchConfig, params: dict,
                 dt: torch.dtype | None) -> None:
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.frozen(_cast(params["norm1"], dt))
        self.norm2 = L.frozen(_cast(params["norm2"], dt))
        self.rec = L.frozen(_cast(params["rec"], dt))
        self.ffn = L.FFN(cfg.ffn, _cast(params["ffn"], dt))

    def forward(self, x, positions, cache: dict | None = None, lengths=None,
                *, use_kernel: bool = True):
        """(x, state, None): the new state (forward), or ``cache``
        updated in place (decode)."""
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, x, self.norm1, cfg.norm_eps)
        r_out, rstate = G.rglru_block_apply(
            self.rec, h, cfg.rglru, None if cache is None else cache["rec"])
        x = x + r_out
        h = L.apply_norm(cfg.norm, x, self.norm2, cfg.norm_eps)
        new = {"rec": rstate}
        return x + self.ffn(h), new if cache is None else _update(cache, new), \
            None


def make_layer(cfg: ArchConfig, kind: str, params: dict, *,
               trainable: bool = False) -> nn.Module:
    """The layer module of ``kind`` over ``params`` (the reference's
    names for one layer): cast to ``compute_dtype`` for serving, kept as
    given for training."""
    dt = None if trainable else cfg.compute_dtype
    if kind.startswith("attn"):
        return DecoderLayer(cfg, params, kind, dt)
    if kind == "rwkv":
        return RWKVLayer(cfg, params, dt)
    if kind == "rec":
        return RecurrentLayer(cfg, params, dt)
    raise ValueError(f"unknown layer kind {kind!r}")


class Transformer(nn.Module):
    """The decoder stack: ``embed`` ``[V, D]`` and ``final_norm`` in
    ``param_dtype``, ``unembed`` ``[D, V]`` (``None`` when tied to the
    embedding), and one layer module a layer, of the kinds
    ``cfg.layer_kinds()`` names.  Serving (``trainable=False``):
    ``unembed`` and the layers are cast to ``compute_dtype`` and take no
    gradient.  Training: every parameter is as given (``param_dtype``)
    and takes a gradient; the casts happen on each call."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor,
                 final_norm: dict, unembed: torch.Tensor | None,
                 layers: list[nn.Module], *, trainable: bool = False) -> None:
        super().__init__()
        kinds = [layer.kind for layer in layers]
        if kinds != cfg.layer_kinds():
            raise ValueError(f"{cfg.name}: layers {kinds}, want "
                             f"{cfg.layer_kinds()}")
        self.cfg = cfg
        self.trainable = trainable
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = L.frozen(final_norm)
        if trainable:
            # tied: the unembedding is embed.t(), cast on each call
            self.unembed = None if cfg.tie_embeddings \
                else nn.Parameter(unembed, requires_grad=False)
        elif cfg.tie_embeddings:
            # a cast copy of a parameter, not one of its own
            self.register_buffer("unembed", embed.t().to(cfg.compute_dtype),
                                 persistent=False)
        else:
            self.unembed = nn.Parameter(unembed.to(cfg.compute_dtype),
                                        requires_grad=False)
        self.layers = nn.ModuleList(layers)
        if trainable:
            self.requires_grad_(True)


def _init_layer(cfg: ArchConfig, kind: str, gen: torch.Generator,
                dev: torch.device) -> dict:
    dt, d = cfg.param_dtype, cfg.d_model
    p = {"norm1": L.init_norm(cfg.norm, d, dt, dev),
         "norm2": L.init_norm(cfg.norm, d, dt, dev)}
    if kind.startswith("attn"):
        p["attn"] = A.init_attn(gen, d, cfg.attn_cfg(), dt, dev)
        if kind.endswith("+moe"):
            p["moe"] = M.init_moe(gen, d, cfg.moe, dt, dev)
        else:
            p["ffn"] = L.ffn_init(_dense_ffn(cfg), gen, d, cfg.d_ff, dt, dev)
    elif kind == "rwkv":
        p["tmix"] = W.init_time_mix(gen, d, cfg.rwkv, dt, dev)
        p["cmix"] = W.init_channel_mix(gen, d, cfg.d_ff, dt, dev)
    elif kind == "rec":
        p["rec"] = G.init_rglru_block(gen, d, cfg.rglru, dt, dev)
        p["ffn"] = L.ffn_init(cfg.ffn, gen, d, cfg.d_ff, dt, dev)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: str | torch.device | None = None,
                trainable: bool = False) -> Transformer:
    """A model with random weights drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (``None``: the card; ``"meta"`` gives the
    shapes and allocates nothing): the reference's shapes and scales
    (N(0, 0.02) embeddings, N(0, 1/d_in) dense weights, unit norms, zero
    biases), not its numbers.  ``trainable``: the training build (see
    :class:`Transformer`), the same numbers in ``param_dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator("cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    dt = cfg.param_dtype
    d = cfg.d_model
    embed = torch.randn((cfg.vocab, d), generator=gen, dtype=torch.float32,
                        device=dev) * 0.02
    unembed = None if cfg.tie_embeddings \
        else L.dense_init(gen, d, cfg.vocab, dt, dev)
    # each layer is cast as it is drawn, so that a full-width serving
    # model never holds all of its float32 layer weights at once
    layers = [make_layer(cfg, kind, _init_layer(cfg, kind, gen, dev),
                         trainable=trainable)
              for kind in cfg.layer_kinds()]
    return Transformer(cfg, embed.to(dt), L.init_norm(cfg.norm, d, dt, dev),
                       unembed, layers, trainable=trainable)


def param_count(cfg: ArchConfig, model: Transformer) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ArchConfig, model: Transformer) -> int:
    """Active params per token (MoE: top_k of the routed expert pool;
    the shared experts always count)."""
    total = param_count(cfg, model)
    if cfg.ffn != "moe":
        return total
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    experts = sum(layer.moe.p[n].numel() for layer in model.layers
                  if getattr(layer, "moe", None) is not None
                  for n in ("w_in", "w_out", "w_gate") if n in layer.moe.p)
    return total - experts + int(experts * k / e)


# ---------------------------------------------------------------------------
# Caches and embedding
# ---------------------------------------------------------------------------

def _empty_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int,
                 dev: torch.device) -> dict:
    dt = cfg.compute_dtype

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if kind.startswith("attn"):
        return A.init_cache(cfg.attn_cfg(), batch, seq_len, dt, dev)
    if kind == "rwkv":
        h, dh = cfg.rwkv.n_heads, cfg.rwkv.d_head
        return {"tmix": {"shift": zeros((batch, cfg.d_model)),
                         "wkv": zeros((batch, h, dh, dh), torch.float32)},
                "cmix": zeros((batch, cfg.d_model))}
    if kind == "rec":
        r = cfg.rglru
        return {"rec": {"h": zeros((batch, r.d_rnn), torch.float32),
                        "conv": zeros((batch, r.conv_width - 1, r.d_rnn))}}
    raise ValueError(f"unknown layer kind {kind!r}")


def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                device: str | torch.device | None = None) -> list[dict]:
    """One empty decode cache a layer on ``device`` (``None``: the card):
    a ``{k, v}`` ring cache ``[B, S, Hkv, dh]`` in ``compute_dtype`` (S
    capped at the window) for attention, zero recurrent states for the
    ``rwkv`` and ``rec`` kinds (float32 ``wkv`` and ``h``, the rest in
    ``compute_dtype``)."""
    dev = resolve_device(device)
    return [_empty_cache(cfg, kind, batch, seq_len, dev)
            for kind in cfg.layer_kinds()]


def _embed(cfg: ArchConfig, model: Transformer, batch: dict,
           positions: torch.Tensor | None = None):
    tokens = batch["tokens"]
    x = model.embed[tokens].to(cfg.compute_dtype)
    b, t = tokens.shape
    if cfg.vlm and "vision_embeds" in batch:
        vm = batch["vision_mask"][..., None]
        x = torch.where(vm, batch["vision_embeds"].to(x.dtype), x)
    if positions is None:
        base = torch.arange(t, dtype=torch.int32,
                            device=tokens.device)[None].expand(b, t)
        if cfg.rope == "mrope":
            positions = batch.get("mrope_positions")
            if positions is None:
                positions = base[None].expand(3, b, t)
        else:
            positions = base
    if cfg.pos_emb == "sinusoidal":
        pe = pos_mod.sinusoidal_embedding(
            positions if positions.dim() == 2 else positions[0], cfg.d_model)
        x = x + pe.to(x.dtype)
    return x, positions


def _logits(cfg: ArchConfig, model: Transformer, x: torch.Tensor):
    x = L.apply_norm(cfg.norm, x, model.final_norm, cfg.norm_eps)
    if not model.trainable:
        return x @ model.unembed
    unembed = model.embed.t() if cfg.tie_embeddings else model.unembed
    return x @ unembed.to(x.dtype)


def _layer_call(model: Transformer, layer: nn.Module, *args, **kwargs):
    """``layer(*args, **kwargs)``; a trainable model's layer sees its
    parameters cast to ``compute_dtype`` inside the autograd graph (the
    reference's ``_cast_params`` on every call)."""
    if not model.trainable:
        return layer(*args, **kwargs)
    dt = model.cfg.compute_dtype
    cast = {n: p.to(dt) if p.is_floating_point() else p
            for n, p in layer.named_parameters()}
    return torch.func.functional_call(layer, cast, args, kwargs)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, model: Transformer, batch: dict, *,
            want_caches: bool = False):
    """Full-sequence forward.  Returns (logits [B, T, V], aux_loss,
    per-layer caches or None); aux_loss sums the MoE layers'
    load-balance losses (0 without MoE).  Each layer is rematerialized
    in the backward pass when autograd records the call: only its input
    ``[B, T, D]`` is kept."""
    x, positions = _embed(cfg, model, batch)
    caches = [] if want_caches else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        x, c, stats = L.remat(_layer_call, model, layer, x, positions)
        if stats is not None:
            aux = aux + stats["aux_loss"]
        if want_caches:
            caches.append(c)
    return _logits(cfg, model, x), aux, caches


def loss_fn(cfg: ArchConfig, model: Transformer, batch: dict):
    """(loss, {"ce", "aux"}): the mean next-token cross entropy over the
    positions whose label is >= 0, plus the MoE aux loss.  Memory-lean
    as the reference's: a float32 logsumexp less the gathered label
    logit, never the float32 log-probabilities over the vocabulary."""
    logits, aux, _ = forward(cfg, model, batch)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    lsafe = torch.clamp(labels, min=0).to(torch.int64)
    lse = torch.logsumexp(logits.to(torch.float32), dim=-1)
    lab = torch.gather(logits, -1, lsafe[..., None])[..., 0]
    nll = lse - lab.to(torch.float32)
    ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(cfg: ArchConfig, model: Transformer, batch: dict,
            pad_cache_to: int | None = None):
    """Prefill: logits of the last position + caches for decode.

    ``pad_cache_to``: total cache capacity for subsequent decode steps.
    Attention caches are laid out in decode ring order (slot = t mod
    capacity); recurrent states need no padding and pass through."""
    logits, _, caches = forward(cfg, model, batch, want_caches=True)
    t = batch["tokens"].shape[1]
    if pad_cache_to is not None:
        cap = pad_cache_to if cfg.window is None \
            else min(pad_cache_to, cfg.window)

        def fix(a: torch.Tensor) -> torch.Tensor:      # [B, T, Hkv, dh]
            if cap >= t:             # zero-pad; slots t.. stay free
                pad = a.new_zeros((a.shape[0], cap - t) + a.shape[2:])
                return torch.cat([a, pad], dim=1)
            # window < t: keep the last ``cap`` tokens in ring order
            base = t - cap
            slots = torch.arange(cap, device=a.device)
            return a[:, base + ((slots - base) % cap)]

        caches = [{k: fix(v) for k, v in c.items()}
                  if kind.startswith("attn") else c
                  for kind, c in zip(cfg.layer_kinds(), caches)]
    return logits[:, -1, :], caches


def decode_step(cfg: ArchConfig, model: Transformer, tokens: torch.Tensor,
                caches: list, lengths: torch.Tensor, *,
                use_kernel: bool = True):
    """One decode step.  tokens: [B, 1]; lengths: [B] int32 tokens so
    far.  Writes the new K/V rows and the new recurrent states into
    ``caches`` in place.  Returns (logits [B, V], caches, lengths + 1).
    ``use_kernel=False`` attends by the reference's jnp branch in every
    layer."""
    if cfg.rope == "mrope":
        positions = lengths[None, :, None].expand((3,) + tokens.shape)
    else:
        positions = lengths[:, None]
    x, _ = _embed(cfg, model, {"tokens": tokens}, positions=positions)
    for layer, cache in zip(model.layers, caches):
        x, _, _ = _layer_call(model, layer, x, positions, cache, lengths,
                              use_kernel=use_kernel)
    return _logits(cfg, model, x)[:, 0, :], caches, lengths + 1
