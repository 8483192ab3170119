"""The port's partition pass (``repro_torch.launch.partition``) against
XLA's SPMD partitioner, one pattern of the models at a time, on the CPU.

A module-scoped subprocess compiles twelve small JAX programs on 8
forced host devices under a ``(2, 4)`` ``("data", "model")`` mesh with
Auto axes (on jax 0.9 a ``jax.make_mesh`` mesh without ``axis_types``
has Explicit axes, which ``with_sharding_constraint`` refuses), each
with ``in_shardings`` and ``with_sharding_constraint``, and writes the
collectives of each compiled module as ``launch.hlo.collective_stats``
reads them (the port's scan: it counts every element of a tuple-shaped
collective).  The port runs the torch twin of each program on ``meta``
tensors under ``costmodel.analyze`` with the same specs seeded, the same
constraints placed and its outputs taken whole (a jitted function's
results are whole values).  Per kind, the bytes must be equal, and so
must the counts: none of these programs has two independent collectives
of one kind that XLA's combiners could merge.

The patterns, each as the models write it: the sequence-parallel column
projection, the row projection into a residual constraint, the
vocab-sharded embedding lookup, the vocab-sharded unembed with
``log_softmax`` and the label gather, the GQA head reshape at 2 heads
over 4 ranks, RoPE's half split and concat, causal attention over a
sequence-sharded T, RWKV's one-step token shift, RG-LRU's causal conv1d
(concat of the tail, four shifted slices), the MoE dispatch and combine
under ``moe_compute_axes`` (experts over "model"), a gradient reduction
over the data axis with AdamW's global-norm clip, and a decode cache
write at ``lengths``."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.launch import partition as PM
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.obs import costmodel

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = AbstractMesh((2, 4), ("data", "model"))
B, T, D, FF, V = 8, 64, 64, 128, 256
G, NG, E, CAP = 2, 256, 4, 160

_XLA = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro_torch.launch import hlo
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    f32, i32 = jnp.float32, jnp.int32
    B, T, D, FF, V = %(dims)s
    G, NG, E, CAP = %(moe)s
    def S(*spec): return NamedSharding(mesh, P(*spec))
    def wsc(x, *spec): return jax.lax.with_sharding_constraint(x, S(*spec))
    PROGRAMS = {}
    def prog(name, shapes, specs):
        def deco(fn):
            PROGRAMS[name] = (fn, shapes, specs)
            return fn
        return deco

    @prog("column", [((B, T, D), f32), ((D, FF), f32)],
          [("data", "model", None), (None, "model")])
    def _(x, w):
        return wsc(x @ w, "data", "model", None)

    @prog("row", [((B, T, FF), f32), ((FF, D), f32)],
          [("data", None, "model"), ("model", None)])
    def _(h, w):
        return wsc(h @ w, "data", "model", None)

    @prog("embed", [((V, D), f32), ((B, T), i32)],
          [("model", None), ("data", None)])
    def _(e, ids):
        return wsc(e[ids], "data", None, None)

    @prog("unembed_loss", [((B, T, D), f32), ((D, V), f32), ((B, T), i32)],
          [("data", None, None), (None, "model"), ("data", None)])
    def _(x, u, lab):
        lp = jax.nn.log_softmax(x @ u, axis=-1)
        return jnp.sum(jnp.take_along_axis(lp, lab[..., None], axis=-1))

    @prog("gqa_heads", [((B, T, D), f32), ((D, 32), f32)],
          [("data", None, None), (None, "model")])
    def _(x, wk):
        return wsc((x @ wk).reshape(B, T, 2, 16), "data", None, None, None)

    @prog("rope", [((B, T, 4, 16), f32), ((T, 8), f32)],
          [("data", "model", None, None), (None, None)])
    def _(x, ang):
        x1, x2 = x[..., :8], x[..., 8:]
        c, s = jnp.cos(ang)[None, :, None], jnp.sin(ang)[None, :, None]
        out = jnp.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)
        return wsc(out, "data", "model", None, None)

    @prog("causal_attn", [((B, T, 4, 16), f32)] * 3,
          [("data", "model", None, None)] * 3)
    def _(q, k, v):
        q = wsc(q, "data", "model", None, None)
        k = wsc(k, "data", None, None, None)
        v = wsc(v, "data", None, None, None)
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
        mask = jnp.arange(T)[:, None] >= jnp.arange(T)[None, :]
        w = jax.nn.softmax(jnp.where(mask, s, -1e30), axis=-1)
        o = jnp.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, 64)
        return wsc(o, "data", "model", None)

    @prog("token_shift", [((B, T, D), f32), ((B, D), f32)],
          [("data", "model", None), ("data", None)])
    def _(x, prev):
        xs = jnp.concatenate([prev[:, None, :], x[:, :-1, :]], axis=1)
        return wsc(xs, "data", "model", None)

    @prog("conv1d", [((B, T, D), f32), ((B, 3, D), f32), ((4, D), f32)],
          [("data", "model", None), ("data", None, None), (None, "model")])
    def _(x, tail, w):
        xp = jnp.concatenate([tail, x], axis=1)
        out = sum(xp[:, i:i + T, :] * w[i] for i in range(4))
        return wsc(out, "data", "model", None)

    @prog("moe", [((G, NG, D), f32), ((G, E * CAP), i32), ((E, D, FF), f32),
                  ((E, FF, D), f32)],
          [("data", None, None), ("data", None), ("model", None, None),
           ("model", None, None)])
    def _(xt, idx, w_in, w_out):
        xt = wsc(xt, "data", None, None)
        buckets = jax.vmap(lambda xg, ig: xg[ig])(xt, idx) \\
            .reshape(G, E, CAP, D)
        buckets = wsc(buckets, "data", "model", None, None)
        h = jax.nn.silu(jnp.einsum("gecd,edf->gecf", buckets, w_in))
        h = wsc(h, "data", "model", None, None)
        eo = wsc(jnp.einsum("gecf,efd->gecd", h, w_out),
                 "data", "model", None, None)
        out = jax.vmap(lambda wg, ig: jnp.zeros((NG, D), f32).at[ig].add(wg))(
            eo.reshape(G, E * CAP, D), idx)
        return wsc(out, "data", None, None)

    @prog("grad_norm", [((B, T, D), f32), ((B, T, FF), f32), ((D, FF), f32)],
          [("data", None, None), ("data", None, "model"), (None, "model")])
    def _(x, dy, p):
        g = jnp.einsum("btd,btf->df", x, dy)
        scale = jnp.minimum(1.0, 1.0 / (jnp.sqrt(jnp.sum(g * g)) + 1e-9))
        return p - 1e-3 * g * scale

    @prog("cache_write", [((B, T, 2, 16), f32), ((B, 2, 16), f32),
                          ((B,), i32)],
          [("data", "model", None, None), ("data", None, None), ("data",)])
    def _(cache, k, lengths):
        out = jax.vmap(lambda c, kk, sl: jax.lax.dynamic_update_slice(
            c, kk[None], (sl, 0, 0)))(cache, k, lengths %% T)
        return wsc(out, "data", "model", None, None)

    res = {}
    for name, (fn, shapes, specs) in PROGRAMS.items():
        args = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
        with mesh:
            c = jax.jit(fn, in_shardings=tuple(S(*sp) for sp in specs)) \\
                .lower(*args).compile()
        st = hlo.collective_stats(c.as_text())
        res[name] = {k: [v["count"], v["bytes"]] for k, v in st.items()
                     if isinstance(v, dict) and v["count"]}
    print(json.dumps(res))
''') % {"dims": (B, T, D, FF, V), "moe": (G, NG, E, CAP)}


@pytest.fixture(scope="module")
def xla():
    """Each program's collectives in XLA's compiled module, per device:
    ``{name: {kind: [count, bytes]}}``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _XLA], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _column(P, x, w):
    return P.constrain(x @ w, ("data", "model", None))


def _row(P, h, w):
    return P.constrain(h @ w, ("data", "model", None))


def _embed(P, e, ids):
    return P.constrain(e[ids], ("data", None, None))


def _unembed_loss(P, x, u, lab):
    lp = torch.log_softmax(x @ u, dim=-1)
    return torch.sum(torch.gather(lp, -1, lab[..., None].long()))


def _gqa_heads(P, x, wk):
    return P.constrain((x @ wk).reshape(B, T, 2, 16),
                       ("data", None, None, None))


def _rope(P, x, ang):
    x1, x2 = x[..., :8], x[..., 8:]
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return P.constrain(out, ("data", "model", None, None))


def _causal_attn(P, q, k, v):
    q = P.constrain(q, ("data", "model", None, None))
    k = P.constrain(k, ("data", None, None, None))
    v = P.constrain(v, ("data", None, None, None))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    mask = torch.arange(T, device="meta")[:, None] >= \
        torch.arange(T, device="meta")[None, :]
    w = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, 64)
    return P.constrain(o, ("data", "model", None))


def _token_shift(P, x, prev):
    xs = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return P.constrain(xs, ("data", "model", None))


def _conv1d(P, x, tail, w):
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i:i + T, :] * w[i] for i in range(4))
    return P.constrain(out, ("data", "model", None))


def _moe(P, xt, idx, w_in, w_out):
    xt = P.constrain(xt, ("data", None, None))
    idx = idx.long()
    buckets = torch.gather(xt, 1, idx[..., None].expand(G, E * CAP, D)) \
        .reshape(G, E, CAP, D)
    buckets = P.constrain(buckets, ("data", "model", None, None))
    h = F.silu(torch.einsum("gecd,edf->gecf", buckets, w_in))
    h = P.constrain(h, ("data", "model", None, None))
    eo = P.constrain(torch.einsum("gecf,efd->gecd", h, w_out),
                     ("data", "model", None, None))
    rows = (idx + torch.arange(G, device="meta")[:, None] * NG).reshape(-1)
    out = torch.zeros((G * NG, D), device="meta").index_add_(
        0, rows, eo.reshape(G * E * CAP, D))
    return P.constrain(out.reshape(G, NG, D), ("data", None, None))


def _grad_norm(P, x, dy, p):
    g = torch.einsum("btd,btf->df", x, dy)
    scale = torch.clamp(1.0 / (torch.sqrt(torch.sum(g * g)) + 1e-9),
                        max=1.0)
    return p - 1e-3 * g * scale


def _cache_write(P, cache, k, lengths):
    cache[torch.arange(B, device="meta"), lengths % T] = k
    return P.constrain(cache, ("data", "model", None, None))


I32 = torch.int32
#: name -> (the torch twin, its arguments' shapes and dtypes, the specs)
PATTERNS = {
    "column": (_column, [((B, T, D),), ((D, FF),)],
               [("data", "model", None), (None, "model")]),
    "row": (_row, [((B, T, FF),), ((FF, D),)],
            [("data", None, "model"), ("model", None)]),
    "embed": (_embed, [((V, D),), ((B, T), I32)],
              [("model", None), ("data", None)]),
    "unembed_loss": (_unembed_loss,
                     [((B, T, D),), ((D, V),), ((B, T), I32)],
                     [("data", None, None), (None, "model"),
                      ("data", None)]),
    "gqa_heads": (_gqa_heads, [((B, T, D),), ((D, 32),)],
                  [("data", None, None), (None, "model")]),
    "rope": (_rope, [((B, T, 4, 16),), ((T, 8),)],
             [("data", "model", None, None), (None, None)]),
    "causal_attn": (_causal_attn, [((B, T, 4, 16),)] * 3,
                    [("data", "model", None, None)] * 3),
    "token_shift": (_token_shift, [((B, T, D),), ((B, D),)],
                    [("data", "model", None), ("data", None)]),
    "conv1d": (_conv1d, [((B, T, D),), ((B, 3, D),), ((4, D),)],
               [("data", "model", None), ("data", None, None),
                (None, "model")]),
    "moe": (_moe, [((G, NG, D),), ((G, E * CAP), I32), ((E, D, FF),),
                   ((E, FF, D),)],
            [("data", None, None), ("data", None), ("model", None, None),
             ("model", None, None)]),
    "grad_norm": (_grad_norm, [((B, T, D),), ((B, T, FF),), ((D, FF),)],
                  [("data", None, None), ("data", None, "model"),
                   (None, "model")]),
    "cache_write": (_cache_write,
                    [((B, T, 2, 16),), ((B, 2, 16),), ((B,), I32)],
                    [("data", "model", None, None), ("data", None, None),
                     ("data",)]),
}


def port_stats(name: str) -> dict:
    """The port's collectives of pattern ``name``, per device:
    ``{kind: [count, bytes]}``."""
    fn, shapes, specs = PATTERNS[name]
    args = [_meta(*s[0], dtype=s[1] if len(s) > 1 else torch.float32)
            for s in shapes]
    part = PM.Partition(MESH)
    for a, spec in zip(args, specs):
        part.seed(a, spec)
    with torch.inference_mode():
        ca = costmodel.analyze(lambda *a: fn(part, *a), *args,
                               partition=part)
    assert not part.unknown, part.unknown
    return {k: [v["count"], v["bytes"]] for k, v in
            ca["collectives"].items() if isinstance(v, dict) and v["count"]}


def test_all_patterns_have_a_twin(xla):
    assert set(xla) == set(PATTERNS)


@pytest.mark.parametrize("name", list(PATTERNS))
def test_pattern_matches_xla(xla, name):
    got, want = port_stats(name), xla[name]
    assert {k: v[1] for k, v in got.items()} == \
        {k: v[1] for k, v in want.items()}, (name, got, want)
    assert got == want, (name, got, want)
