"""The port's RWKV-6 time mix and channel mix
(``repro_torch.models.rwkv``) against ``repro.models.rwkv`` on the same
seeded numpy inputs, on the CPU: a 16-step forward (chunk 8, two
chunks), then one decode step from the state it left (nonzero), each
output and each state -- the token shift and the float32 wkv state --
against the reference's.

Float32 within 1e-5 absolute and relative (matmuls, the wkv einsum and
transcendental functions rounded by two frameworks).  bfloat16 compute
within 1.6e-2 of the largest value of each output or state, four bf16
ulps (3.9e-3 relative each): the two frameworks round bfloat16 matmul
results and their float32 casts at different points (8.3e-3 seen)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as JW
from repro_torch.models import rwkv as W

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1.6e-2
B, T, D, H, DH, F = 2, 16, 32, 4, 8, 48
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, compute):
    if compute == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    else:
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=BF16_REL * scale)


def _random_like(rng, shapes, scale=0.3):
    return {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _pair(p, compute):
    jdt, tdt = DTYPES[compute]
    return ({k: jnp.asarray(v).astype(jdt) for k, v in p.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in p.items()})


def _shapes(p):
    return {k: tuple(v.shape) for k, v in p.items()}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_time_mix_forward_then_decode_matches(compute):
    rng = np.random.default_rng(0)
    kw = dict(n_heads=H, d_head=DH, decay_lora=8, chunk=8)
    jcfg, tcfg = JW.RWKVConfig(**kw), W.RWKVConfig(**kw)
    shapes = JW.init_time_mix(jax.random.PRNGKey(0), D, jcfg, jnp.float32)
    assert _shapes(W.init_time_mix(torch.Generator().manual_seed(0), D, tcfg,
                                   torch.float32, "cpu")) == _shapes(shapes)
    p = _random_like(rng, shapes)
    p["w_base"] = p["w_base"] - 1.0       # decays exp(-exp(-1 +- ...))
    p["mu_r"] = p["mu_r"] + 0.5
    jp, tp = _pair(p, compute)
    jdt, tdt = DTYPES[compute]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    want, ws = JW.time_mix_apply(jp, jnp.asarray(x).astype(jdt), jcfg)
    got, gs = W.time_mix_apply(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt and gs["wkv"].dtype == torch.float32
    assert gs["shift"].dtype == tdt
    _close(got, want, compute)
    for k in ("shift", "wkv"):
        _close(gs[k], ws[k], compute)
    assert float(np.abs(_np(gs["wkv"])).max()) > 0
    want1, ws1 = JW.time_mix_apply(jp, jnp.asarray(x1).astype(jdt), jcfg, ws)
    got1, gs1 = W.time_mix_apply(tp, torch.from_numpy(x1).to(tdt), tcfg, gs)
    _close(got1, want1, compute)
    for k in ("shift", "wkv"):
        _close(gs1[k], ws1[k], compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_channel_mix_forward_then_decode_matches(compute):
    rng = np.random.default_rng(1)
    shapes = JW.init_channel_mix(jax.random.PRNGKey(0), D, F, jnp.float32)
    assert _shapes(W.init_channel_mix(torch.Generator().manual_seed(0), D, F,
                                      torch.float32, "cpu")) == \
        _shapes(shapes)
    jp, tp = _pair(_random_like(rng, shapes), compute)
    jdt, tdt = DTYPES[compute]
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    want, ws = JW.channel_mix_apply(jp, jnp.asarray(x).astype(jdt))
    got, gs = W.channel_mix_apply(tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got, want, compute)
    _close(gs, ws, compute)
    want1, ws1 = JW.channel_mix_apply(jp, jnp.asarray(x1).astype(jdt), ws)
    got1, gs1 = W.channel_mix_apply(tp, torch.from_numpy(x1).to(tdt), gs)
    _close(got1, want1, compute)
    _close(gs1, ws1, compute)


def test_wkv_step_matches():
    rng = np.random.default_rng(2)
    r, k, v, w = (rng.standard_normal((B, H, DH)).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.exp(w))
    u = rng.standard_normal((H, DH)).astype(np.float32)
    s = rng.standard_normal((B, H, DH, DH)).astype(np.float32)
    want_s, want_y = JW._wkv_step(jnp.asarray(s), tuple(
        jnp.asarray(a) for a in (r, k, v, w, u)))
    got_s, got_y = W._wkv_step(torch.from_numpy(s), tuple(
        torch.from_numpy(a) for a in (r, k, v, w, u)))
    np.testing.assert_allclose(_np(got_s), _np(want_s), **TOL)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **TOL)


def test_rwkv_probe_mode_is_refused():
    """Probe mode, refused before the dry run was ported, now runs the
    reference's loop-free stand-in: the output and state equal the
    reference's probe branch (float32, 1e-5)."""
    rng = np.random.default_rng(4)
    kw = dict(n_heads=H, d_head=DH, decay_lora=8, chunk=8, probe=True)
    jcfg, tcfg = JW.RWKVConfig(**kw), W.RWKVConfig(**kw)
    shapes = JW.init_time_mix(jax.random.PRNGKey(0), D, jcfg, jnp.float32)
    p = _random_like(rng, shapes)
    p["w_base"] = p["w_base"] - 1.0
    jp, tp = _pair(p, "float32")
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    want, ws = JW.time_mix_apply(jp, jnp.asarray(x), jcfg)
    got, gs = W.time_mix_apply(tp, torch.from_numpy(x), tcfg)
    _close(got, want, "float32")
    for k in ("shift", "wkv"):
        _close(gs[k], ws[k], "float32")
