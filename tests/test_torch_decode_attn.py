"""The port's ``decode_attn`` (wrapper and plain version, on the CPU)
against the JAX package's Pallas kernel in interpret mode and its jnp
oracle, on the same seeded numpy inputs: the five shapes of
``tests/test_kernels.py`` (GQA, MHA with odd heads, MQA, a long cache,
a ragged S) in float32 and bfloat16, and a row of length 0.

Tolerances: float32 1e-5 (the two sides sum the scores and the P.V
products in other orders); bfloat16 2.5e-2, the reference's own bf16
tolerance (the output is rounded to bfloat16 on both sides, and one
bf16 ulp near 1 is 7.8e-3)."""
import ast

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
    off.launches = off.generic_launches = 0
    monkeypatch.setattr(checks, "decode_attention", off)
    with pytest.raises(AssertionError, match="differ by more than"):
        checks.check_decode_attn("cpu", (2, 8, 2, 32, 64))

    def nonzero(q, k, v, lengths, *, num_kv_heads):
        return decode_attention(q, k, v, lengths.clamp(min=1),
                                num_kv_heads=num_kv_heads)
    nonzero.launches = nonzero.generic_launches = 0
    monkeypatch.setattr(checks, "decode_attention", nonzero)
    with pytest.raises(AssertionError, match="length-0 row"):
        checks.check_decode_attn("cpu", (2, 8, 2, 32, 64))


def test_check_decode_attn_catches_a_call_that_changes_bits(monkeypatch):
    """A wrapper whose second call on the same inputs gives other bits
    is caught, though each call lies within the tolerance."""
    from repro_torch.kernels import checks
    calls = []

    def drifts(q, k, v, lengths, *, num_kv_heads):
        out = decode_attention(q, k, v, lengths, num_kv_heads=num_kv_heads)
        calls.append(1)
        out[-1, 0, 0] += 1e-7 * len(calls)
        return out
    drifts.launches = drifts.generic_launches = 0
    monkeypatch.setattr(checks, "decode_attention", drifts)
    with pytest.raises(AssertionError, match="second call"):
        checks.check_decode_attn("cpu", (2, 8, 2, 32, 64))


def test_check_decode_attn_names_the_side_that_is_off(monkeypatch):
    """A failed comparison reports the kernel's and the plain version's
    largest differences from float64: the wrong one is the kernel."""
    from repro_torch.kernels import checks

    def off(q, k, v, lengths, *, num_kv_heads):
        out = decode_attention(q, k, v, lengths, num_kv_heads=num_kv_heads)
        out[-1, 0, 0] += 0.1
        return out
    off.launches = off.generic_launches = 0
    monkeypatch.setattr(checks, "decode_attention", off)
    with pytest.raises(AssertionError, match="from float64") as e:
        checks.check_decode_attn("cpu", (2, 8, 2, 32, 64))
    sides = ast.literal_eval(str(e.value).split("from float64: ")[1])
    assert set(sides) == {"kernel", "plain"}
    assert sides["kernel"] > 0.09 and sides["plain"] < 1e-6


@pytest.mark.parametrize("shape", [(2, 8, 2, 32, 64), (3, 10, 1, 256, 70)])
def test_decode_attn_f64_is_what_the_plain_version_rounds(shape):
    """The check's float64 answer agrees with the float32 plain version
    within float32's rounding, and gives zeros on a length-0 row."""
    from repro_torch.kernels import checks
    b, h, hkv, d, s = shape
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((b, h, d), generator=gen)
    k, v = (torch.randn((b, s, hkv, d), generator=gen) for _ in range(2))
    lens = torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)
    lens[0] = 0
    exact = checks.decode_attn_f64(q, k, v, lens, hkv)
    got = decode_attention(q, k, v, lens, num_kv_heads=hkv)
    assert exact.dtype == torch.float64 and exact.shape == (b, h, d)
    assert bool((exact[0] == 0).all())
    assert float((got.double() - exact).abs().max()) < 1e-6


def test_check_decode_attn_takes_several_serve_shapes(monkeypatch):
    """RecurrentGemma-2B's serve shape beside a small one: each at full
    and split-edge lengths; a plan that names another instance than
    ``bf16_d256`` at D 256 is caught."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.decode_attn.ops import Plan
    rg = (2, 10, 1, 256, 300)
    assert checks.check_decode_attn("cpu", (2, 8, 2, 32, 64), rg) == 0.0
    real = checks.plan_for

    def wrong(q, k, v, hkv):
        how = real(q, k, v, hkv)
        return Plan("bf16_d128", how.n_split) \
            if how.instance == "bf16_d256" else how
    monkeypatch.setattr(checks, "plan_for", wrong)
    with pytest.raises(AssertionError, match="want bf16_d256"):
        checks.check_decode_attn("cpu", rg)


# ---- the kernel's launch plan (a pure function of shapes, strides and
# dtype; the card runs what it names) ---------------------------------------

def _strides(b, s, hkv, width):
    return (s * hkv * width, hkv * width, width)


@pytest.mark.parametrize("case,args,want", [
    ("yi_6b serve", (16, 32, 4, 128, 1088, torch.bfloat16), ("bf16_d128", 2)),
    ("musicgen G 1, 512 blocks", (16, 32, 32, 64, 1088, torch.bfloat16),
     ("bf16_d64", 1)),
    ("yi_6b float32, short cache", (4, 32, 4, 128, 40, torch.float32),
     ("f32_d128", 1)),
    ("smoke D 16", (2, 4, 2, 16, 7, torch.bfloat16), ("bf16_d16", 1)),
    ("one unit", (1, 8, 1, 64, 64, torch.bfloat16), ("bf16_d64", 1)),
    ("a unit and one row", (1, 8, 1, 64, 65, torch.float32), ("f32_d64", 2)),
    ("G 16, D 256", (1, 16, 1, 256, 300, torch.bfloat16), ("bf16_d256", 4)),
    ("recurrentgemma_2b serve", (16, 10, 1, 256, 1088, torch.bfloat16),
     ("bf16_d256", 4)),
    ("mixtral_8x7b serve", (16, 32, 8, 128, 96, torch.bfloat16),
     ("bf16_d128", 1)),
    ("a long cache, one head", (1, 8, 1, 128, 4096, torch.bfloat16),
     ("bf16_d128", 8)),
    ("a full wave of heads", (512, 8, 1, 128, 4096, torch.bfloat16),
     ("bf16_d128", 1)),
    ("G 17", (1, 17, 1, 64, 300, torch.bfloat16), ("generic", 1)),
    ("D 48", (1, 8, 2, 48, 300, torch.bfloat16), ("generic", 1)),
    ("float32 D 256", (1, 8, 2, 256, 300, torch.float32), ("generic", 1)),
])
def test_plan_picks_the_instance(case, args, want):
    from repro_torch.kernels.decode_attn.ops import Plan, plan
    b, h, hkv, d, s, dtype = args
    st = _strides(b, s, hkv, d)
    assert plan(b, h, hkv, d, s, st, st, dtype) == Plan(*want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_takes_the_generic_instance_for_unaligned_caches(dtype):
    """A view whose rows are not 16 bytes apart, or whose base is not
    16-byte aligned, goes to the generic instance; a padded view whose
    rows stay aligned keeps the fast one."""
    from repro_torch.kernels.decode_attn.ops import plan, plan_for
    tdt = DTYPES[dtype][1]
    q = torch.zeros((3, 8, 32), dtype=tdt)
    for width, instance in ((33, "generic"), (48, None)):
        wide = torch.zeros((3, 70, 2, width), dtype=tdt)
        got = plan_for(q, wide[..., :32], wide[..., :32], 2)
        assert got.instance == (instance or plan(
            3, 8, 2, 32, 70, _strides(3, 70, 2, 32),
            _strides(3, 70, 2, 32), tdt).instance)
    st = _strides(3, 70, 2, 32)
    assert plan(3, 8, 2, 32, 70, st, st, tdt, aligned=False).instance \
        == "generic"
    flat = torch.zeros(3 * 70 * 2 * 32 + 1, dtype=tdt)
    shifted = flat[1:].view(3, 70, 2, 32)          # base one element off
    assert plan_for(q, shifted, shifted, 2).instance == "generic"


@pytest.mark.parametrize("arch", ["yi_6b", "yi_34b", "qwen2_72b",
                                  "nemotron_4_15b", "qwen2_vl_7b",
                                  "musicgen_large"])
def test_plan_gives_every_dense_config_a_fast_instance(arch):
    """The serve path's head shapes at every ported configuration, with
    the cache ``init_cache`` makes, take a fast instance in bf16."""
    from repro_torch import configs
    from repro_torch.kernels.decode_attn.ops import plan
    cfg = configs.get_config(arch)
    b, s = 16, 1088
    st = _strides(b, s, cfg.n_kv_heads, cfg.d_head)
    got = plan(b, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, s, st, st,
               torch.bfloat16)
    assert got.instance == f"bf16_d{cfg.d_head}"
    units = -(-s // (16 * 8))
    assert got.n_split == max(1, min(units, 8, 132 // (b * cfg.n_kv_heads)))


def test_plan_never_reads_lengths():
    """The plan's inputs are shapes, strides, dtype and alignment: no
    lengths, so the wrapper never reads a device value back."""
    import inspect
    from repro_torch.kernels.decode_attn import ops
    for fn in (ops.plan, ops.plan_for):
        assert "lengths" not in inspect.signature(fn).parameters


def test_splits_share_the_units_evenly():
    from repro_torch.kernels.decode_attn.ops import split_starts
    assert split_starts(1088, 2, 128) == [0, 512, 1088]
    assert split_starts(1088, 6, 64) == [0, 128, 320, 512, 704, 896, 1088]
    assert split_starts(65, 2, 64) == [0, 64, 65]
    for s, n, unit in ((1088, 8, 128), (300, 5, 64), (4096, 3, 128),
                       (100, 1, 64)):
        starts = split_starts(s, n, unit)
        assert starts[0] == 0 and starts[-1] == s
        assert all(a < b for a, b in zip(starts, starts[1:]))   # none empty
        sizes = [b - a for a, b in zip(starts[:-1], starts[1:-1])]
        assert max(sizes, default=0) - min(sizes, default=0) <= unit


def test_split_edge_lengths_hit_the_split_edges():
    from repro_torch.kernels.checks import split_edge_lengths
    got = split_edge_lengths(16, 1088, 2, 128).tolist()
    assert got[:10] == [0, 1, 1088, 1087, 511, 512, 513, 127, 128, 129]
    assert split_edge_lengths(3, 64, 1, 64).tolist() == [0, 1, 64]
