"""The port's ``decode_attn`` (wrapper and plain version, on the CPU)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, on the same seeded numpy inputs: the five shapes of
``tests/test_kernels.py`` (GQA, MHA with odd heads, MQA, a long cache,
a ragged S) in float32 and bfloat16, and a row of length 0.

Tolerances: float32 1e-5 (the two sides sum the scores and the P.V
products in other orders); bfloat16 2.5e-2, the reference's own bf16
tolerance (the output is rounded to bfloat16 on both sides, and one
bf16 ulp near 1 is 7.8e-3)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.decode_attn import decode_attention as jax_decode_attention
from repro.kernels.decode_attn import decode_attn_ref as jax_decode_attn_ref
from repro_torch.kernels.decode_attn import decode_attention, decode_attn_ref

SHAPES = [
    (2, 8, 4, 64, 1024, 256),
    (1, 7, 7, 128, 512, 512),      # MHA, odd heads
    (3, 10, 1, 64, 768, 256),      # MQA
    (2, 32, 8, 128, 2048, 512),
    (1, 4, 2, 32, 100, 64),        # non-multiple S -> padding in the reference
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.5e-2)}


def _inputs(b, h, hkv, d, s, seed, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, s + 1, b)
    return q, k, v, np.asarray(lens, np.int32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("b,h,hkv,d,s,bs", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_jax(b, h, hkv, d, s, bs, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, lens = _inputs(b, h, hkv, d, s, seed=b * 100 + s)
    g = h // hkv
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jl = jnp.asarray(lens)
    kernel = jax_decode_attention(jq, jk, jv, jl, num_kv_heads=hkv,
                                  block_s=bs, interpret=True)
    oracle = jax_decode_attn_ref(
        jq.reshape(b, hkv, g, d), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), jl, scale=1.0 / d ** 0.5).reshape(b, h, d)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tl = torch.from_numpy(lens)
    before = decode_attention.launches
    out = decode_attention(tq, tk, tv, tl, num_kv_heads=hkv)
    assert decode_attention.launches == before     # the CPU launches nothing
    plain = decode_attn_ref(tq.reshape(b, hkv, g, d), tk.transpose(1, 2),
                            tv.transpose(1, 2), tl,
                            scale=1.0 / d ** 0.5).reshape(b, h, d)
    assert out.dtype == tdt and out.shape == (b, h, d)
    for name, mine in (("wrapper", out), ("plain", plain)):
        for ref_name, ref in (("pallas", kernel), ("oracle", oracle)):
            np.testing.assert_allclose(_f32(mine), _f32(ref), rtol=tol,
                                       atol=tol, err_msg=f"{name} vs {ref_name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_zero_length_gives_zeros(dtype):
    """A row with an empty cache gives zeros, not NaN, as in JAX."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, lens = _inputs(2, 4, 2, 32, 64, seed=5, lens=[0, 10])
    want = np.asarray(jax_decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lens),
        num_kv_heads=2, block_s=64, interpret=True), np.float32)
    out = decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(lens), num_kv_heads=2)
    assert np.isfinite(_f32(out)).all()
    assert (_f32(out)[0] == 0).all() and (want[0] == 0).all()
    np.testing.assert_allclose(_f32(out), want, rtol=tol, atol=tol)


def test_decode_attention_reads_strided_caches():
    """A cache view with a padded row stride gives the contiguous answer."""
    q, k, v, lens = _inputs(2, 8, 2, 32, 40, seed=6)
    wide = torch.zeros((2, 40, 2, 48))
    wide[..., :32] = torch.from_numpy(k)
    got = decode_attention(torch.from_numpy(q), wide[..., :32],
                           torch.from_numpy(v), torch.from_numpy(lens),
                           num_kv_heads=2)
    want = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens),
                            num_kv_heads=2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["heads", "lengths_dtype", "dtypes"])
def test_decode_attention_rejects_bad_inputs(bad):
    q, k, v, lens = (torch.from_numpy(a)
                     for a in _inputs(2, 8, 2, 32, 16, seed=7))
    kw = dict(num_kv_heads=2)
    if bad == "heads":
        kw["num_kv_heads"] = 3
    elif bad == "lengths_dtype":
        lens = lens.long()
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        decode_attention(q, k, v, lens, **kw)


def test_check_decode_attn_runs_on_the_cpu_and_catches_errors(monkeypatch):
    """The card's check, on the CPU at a small full shape; a wrapper that
    answers wrong by more than the tolerance, or gives a length-0 row
    that is not zero, is caught."""
    from repro_torch.kernels import checks
    assert checks.check_decode_attn("cpu", (2, 8, 2, 32, 64)) == 0.0

    def off(q, k, v, lengths, *, num_kv_heads):
        out = decode_attention(q, k, v, lengths, num_kv_heads=num_kv_heads)
        out[-1, 0, 0] += 0.1
        return out
    off.launches = 0
    monkeypatch.setattr(checks, "decode_attention", off)
    with pytest.raises(AssertionError, match="differ by more than"):
        checks.check_decode_attn("cpu", (2, 8, 2, 32, 64))

    def nonzero(q, k, v, lengths, *, num_kv_heads):
        return decode_attention(q, k, v, lengths.clamp(min=1),
                                num_kv_heads=num_kv_heads)
    nonzero.launches = 0
    monkeypatch.setattr(checks, "decode_attention", nonzero)
    with pytest.raises(AssertionError, match="length-0 row"):
        checks.check_decode_attn("cpu", (2, 8, 2, 32, 64))
