"""The port's RG-LRU block (``repro_torch.models.griffin``) and its
chunked scan (``layers.chunked_scan``) against ``repro.models`` on the
same seeded numpy inputs, on the CPU.

``chunked_scan`` runs the same step function as ``jax.lax.scan`` at
every chunk size that divides the sequence, within 1e-5 (XLA's CPU
backend fuses the step's multiply and add into one rounding); the
chunk size changes no bit of the port's own result.

The block: a 16-step forward (chunk 8, two chunks), then one decode
step from the state it left (nonzero), each output and each state
against the reference's.  Float32 within 1e-5 absolute and relative
(matmuls and transcendental functions rounded by two frameworks).
bfloat16 compute within 1.6e-2 of the largest value of each output or
state, four bf16 ulps (3.9e-3 relative each): the two frameworks round
bfloat16 matmul results and their float32 casts at different points,
and the recurrence carries those differences forward (3.2e-3 seen)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import griffin as JG
from repro.models import layers as JL
from repro_torch.models import griffin as G
from repro_torch.models import layers as L
from repro_torch.testing import assert_bitwise

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1.6e-2
B, T, D, DR = 2, 16, 32, 48


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


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16])
def test_chunked_scan_equals_lax_scan(chunk):
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, (T, B, DR)).astype(np.float32)
    d = rng.standard_normal((T, B, DR)).astype(np.float32)
    h0 = rng.standard_normal((B, DR)).astype(np.float32)

    def jbody(h, inp):
        at, dt = inp
        h = at * h + dt
        return h, (h, h * at)

    def tbody(h, inp):
        at, dt = inp
        h = at * h + dt
        return h, (h, h * at)

    want_h, want_ys = jax.lax.scan(jbody, jnp.asarray(h0),
                                   (jnp.asarray(a), jnp.asarray(d)))
    got_h, got_ys = L.chunked_scan(tbody, torch.from_numpy(h0),
                                   (torch.from_numpy(a), torch.from_numpy(d)),
                                   chunk=chunk)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **TOL)
    for g, w in zip(got_ys, want_ys):
        assert g.shape == (T, B, DR)
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    ref_h, _ = JL.chunked_scan(jbody, jnp.asarray(h0),
                               (jnp.asarray(a), jnp.asarray(d)), chunk=chunk)
    np.testing.assert_allclose(_np(got_h), _np(ref_h), **TOL)
    one_h, one_ys = L.chunked_scan(tbody, torch.from_numpy(h0),
                                   (torch.from_numpy(a), torch.from_numpy(d)),
                                   chunk=T)
    assert_bitwise(got_h, one_h, "carry against one chunk")
    for g, w in zip(got_ys, one_ys):
        assert_bitwise(g, w, "ys against one chunk")


def test_chunked_scan_needs_whole_chunks():
    with pytest.raises(ValueError, match="multiple of chunk"):
        L.chunked_scan(lambda c, x: (c, x), torch.zeros(1), torch.zeros(6),
                       chunk=4)


def _params(rng, cfg):
    shapes = JG.init_rglru_block(jax.random.PRNGKey(0), D, cfg, jnp.float32)
    p = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
         for k, v in shapes.items()}
    p["rg_lambda"] = p["rg_lambda"] + 2.2            # a in (0.8, 0.95)
    mine = G.init_rglru_block(torch.Generator().manual_seed(0), D, cfg,
                              torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in shapes.items()}
    return p


def _pair(p, compute):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    return ({k: jnp.asarray(v).astype(jdt) for k, v in p.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}, jdt, tdt)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_causal_conv_matches(compute):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, DR)).astype(np.float32)
    w = (rng.standard_normal((4, DR)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((DR,)) * 0.1).astype(np.float32)
    tail = rng.standard_normal((B, 3, DR)).astype(np.float32)
    jp, tp, _, _ = _pair(dict(x=x, w=w, b=b, tail=tail), compute)
    jx, jw, jb, jt = jp.values()
    tx, tw, tb, tt = tp.values()
    want, want_tail = JG._causal_conv(jx, jw, jb, jt)
    got, got_tail = G._causal_conv(tx, tw, tb, tt)
    assert got.dtype == tx.dtype and got_tail.shape == (B, 3, DR)
    # the same products and sums in the same order: bitwise in float32
    # and in bfloat16 (each partial sum rounded to bf16 on both sides)
    assert_bitwise(got.float(), _np(want), "conv out")
    assert_bitwise(got_tail.float(), _np(want_tail), "conv tail")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_rglru_block_forward_then_decode_matches(compute):
    rng = np.random.default_rng(2)
    cfg_kw = dict(d_rnn=DR, chunk=8)
    jcfg, tcfg = JG.RGLRUConfig(**cfg_kw), G.RGLRUConfig(**cfg_kw)
    jp, tp, jdt, tdt = _pair(_params(rng, jcfg), compute)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    want, ws = JG.rglru_block_apply(jp, jnp.asarray(x).astype(jdt), jcfg)
    got, gs = G.rglru_block_apply(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert got.dtype == tdt and gs["h"].dtype == torch.float32
    assert gs["conv"].dtype == tdt
    _close(got, want, compute)
    for k in ("h", "conv"):
        _close(gs[k], ws[k], compute)
    # one decode step from the forward's state (nonzero), each side
    # from its own state
    want1, ws1 = JG.rglru_block_apply(jp, jnp.asarray(x1).astype(jdt), jcfg,
                                      ws)
    got1, gs1 = G.rglru_block_apply(tp, torch.from_numpy(x1).to(tdt), tcfg,
                                    gs)
    assert float(np.abs(_np(gs["h"])).min()) > 0
    _close(got1, want1, compute)
    for k in ("h", "conv"):
        _close(gs1[k], ws1[k], compute)


def test_rglru_probe_mode_is_refused():
    cfg = G.RGLRUConfig(d_rnn=DR, probe=True)
    p = G.init_rglru_block(torch.Generator().manual_seed(0), D, cfg,
                           torch.float32, "cpu")
    with pytest.raises(NotImplementedError, match="probe"):
        G.rglru_block_apply(p, torch.zeros((1, 2, D)), cfg)
