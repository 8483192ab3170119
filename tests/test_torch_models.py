"""The port's model layers against ``repro.models`` on the same seeded
numpy inputs, in float32 on the CPU: norms, the four dense FFN kinds,
RoPE / M-RoPE / sinusoidal embeddings, the QKV projection (with bias
and M-RoPE), causal attention, and the decode step against both of the
reference's branches (the jnp split-KV branch and the Pallas kernel in
interpret mode), with a window smaller than the sequence so that the
ring cache wraps.

Tolerance: 1e-5 absolute and relative (float32; the two frameworks
round transcendental functions and reduction orders differently)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import positional as JP
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import positional as P

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _pair(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 5, 32)
    p = {"scale": 1 + _normal(rng, 32, scale=0.1),
         "bias": _normal(rng, 32, scale=0.1)}
    if kind == "rmsnorm":
        del p["bias"]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    want = JL.apply_norm(kind, jnp.asarray(x), jp, 1e-6)
    got = L.apply_norm(kind, torch.from_numpy(x), tp, 1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    init = L.init_norm(kind, 32, torch.float32, torch.device("cpu"))
    ref = JL.init_norm(kind, 32, jnp.float32)
    assert set(init) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(_np(init[k]), _np(ref[k]))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_ffn_kinds_match(kind):
    rng = np.random.default_rng(1)
    d, f = 32, 48
    x = _normal(rng, 2, 3, d)
    shapes = JL.ffn_init(kind, jax.random.PRNGKey(0), d, f, jnp.float32)
    p = {k: _normal(rng, *v.shape, scale=0.2) for k, v in shapes.items()}
    want = JL.ffn_apply(kind, {k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    got = L.FFN(kind, {k: torch.from_numpy(v) for k, v in p.items()})(
        torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    mine = L.ffn_init(kind, torch.Generator().manual_seed(0), d, f,
                      torch.float32, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}


def test_dense_init_scale():
    w = L.dense_init(torch.Generator().manual_seed(0), 256, 512,
                     torch.bfloat16, torch.device("cpu"))
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(float(w.float().std()) - 1 / 16) < 2e-3


@pytest.mark.parametrize("theta", [10000.0, 5e6])
def test_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 6, 3, 16)
    pos = rng.integers(0, 5000, (2, 6)).astype(np.int32)
    want = JP.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = P.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # angles up to 5e3 rad: a float32 ulp of the angle is 5e-4 rad
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)
    small = np.arange(6, dtype=np.int32)[None].repeat(2, 0)
    np.testing.assert_allclose(
        _np(P.apply_rope(torch.from_numpy(x), torch.from_numpy(small), theta)),
        _np(JP.apply_rope(jnp.asarray(x), jnp.asarray(small), theta)), **TOL)


def test_mrope_matches():
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 5, 3, 16)
    pos = rng.integers(0, 64, (3, 2, 5)).astype(np.int32)
    want = JP.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3), 1e6)
    got = P.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                        (2, 3, 3), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(ValueError):
        P.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (2, 3, 4))


def test_sinusoidal_matches():
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    want = JP.sinusoidal_embedding(jnp.asarray(pos), 64)
    got = P.sinusoidal_embedding(torch.from_numpy(pos), 64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=2e-5)


def _attn(rng, cfg_kw, d_model=32):
    jcfg = JA.AttnConfig(**cfg_kw)
    tcfg = A.AttnConfig(**cfg_kw)
    shapes = JA.init_attn(jax.random.PRNGKey(0), d_model, jcfg, jnp.float32)
    p = {k: _normal(rng, *v.shape, scale=0.3) for k, v in shapes.items()}
    mine = A.init_attn(torch.Generator().manual_seed(0), d_model, tcfg,
                       torch.float32, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    return (jcfg, {k: jnp.asarray(v) for k, v in p.items()},
            tcfg, {k: torch.from_numpy(v) for k, v in p.items()})


CFGS = {
    "gqa_rope": dict(n_heads=4, n_kv_heads=2, d_head=8, rope_theta=5e6),
    "bias_mrope": dict(n_heads=4, n_kv_heads=2, d_head=16, qkv_bias=True,
                       rope="mrope", mrope_sections=(2, 3, 3)),
    "mha_norope": dict(n_heads=4, n_kv_heads=4, d_head=8, rope="none"),
    "mqa_window": dict(n_heads=4, n_kv_heads=1, d_head=8, window=4,
                       chunk_q=4),
}


def _positions(cfg_kw, b, t):
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    return np.broadcast_to(pos, (3, b, t)).copy() \
        if cfg_kw.get("rope") == "mrope" else pos.copy()


@pytest.mark.parametrize("name", list(CFGS))
def test_project_qkv_and_causal_attention_match(name):
    rng = np.random.default_rng(4)
    jcfg, jp, tcfg, tp = _attn(rng, CFGS[name])
    if jcfg.qkv_bias:      # non-zero biases, so that they are tested
        for k in ("bq", "bk", "bv"):
            jp[k] = jp[k] + 0.5
            tp[k] = tp[k] + 0.5
    x = _normal(rng, 2, 8, 32)
    pos = _positions(CFGS[name], 2, 8)
    jx, tx = _pair(x)
    jpos, tpos = _pair(pos)
    for a, b in zip(JA._project_qkv(jp, jx, jcfg, jpos),
                    A._project_qkv(tp, tx, tcfg, tpos)):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    want, wc = JA.causal_attention(jp, jx, jpos, jcfg)
    got, gc = A.causal_attention(tp, tx, tpos, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), **TOL)


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("jax_kernel", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_decode_attention_step_matches_both_branches(name, jax_kernel,
                                                     use_kernel):
    """Ten steps from an empty cache of 6 rows (4 under the window): the
    ring wraps.  The port's kernel branch (the plain version on the CPU)
    and its jnp branch each match either JAX branch, output and cache."""
    rng = np.random.default_rng(5)
    cfg_kw = CFGS[name]
    jcfg, jp, tcfg, tp = _attn(rng, cfg_kw)
    b, s = 2, 6
    jc = JA.init_cache(jcfg, b, s, jnp.float32)
    tc = A.init_cache(tcfg, b, s, torch.float32, torch.device("cpu"))
    assert tc["k"].shape == jc["k"].shape
    lengths = np.asarray([0, 2], np.int32)
    for step in range(10):
        x = _normal(rng, b, 1, 32)
        want, jc = JA.decode_attention_step(jp, jnp.asarray(x), jc,
                                            jnp.asarray(lengths), jcfg,
                                            use_kernel=jax_kernel,
                                            interpret=True)
        got, tc2 = A.decode_attention_step(tp, torch.from_numpy(x), tc,
                                           torch.from_numpy(lengths), tcfg,
                                           use_kernel=use_kernel)
        assert tc2 is tc          # written in place
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"step {step} out")
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL,
                                       err_msg=f"step {step} cache {k}")
        lengths = lengths + 1
    assert lengths.max() > tc["k"].shape[1]         # the ring wrapped
