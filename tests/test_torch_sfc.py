"""The port's ``core.sfc`` and ``kernels.hilbert`` against the JAX
package, bit for bit.

The hashes run over the whole int32 range (hypothesis), where the
port's three traps live: an int32 ``sum`` that promotes to int64, an
arithmetic ``>>`` where the reference's uint32 shift is logical, and a
uint32 product that overflows an int64 before the mask.  The JAX
Hilbert kernel runs in interpret mode, as its own tests run it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import profiles as JP
from repro.core import sfc as J
from repro.kernels.hilbert import hilbert_xy2d as j_hilbert
from repro_torch.core import profiles as TP
from repro_torch.core import sfc as T
from repro_torch.kernels import checks
from repro_torch.kernels.hilbert import hilbert_xy2d, hilbert_xy2d_ref
from repro_torch.testing import assert_bitwise

I32 = st.integers(-(1 << 31), (1 << 31) - 1)
EDGES = np.array([-(1 << 31), -(1 << 31) + 1, -1, 0, 1, 2, (1 << 31) - 1,
                  0x7FFF, 0x8000, 0xFFFF, 0x10000, -0x10000], np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@settings(max_examples=60, deadline=None)
@given(st.lists(I32, min_size=1, max_size=64),
       st.lists(I32, min_size=1, max_size=64))
def test_hashes_equal_jax_over_int32(a, b):
    n = min(len(a), len(b))
    a = np.asarray(a[:n], np.int32)
    b = np.asarray(b[:n], np.int32)
    assert_bitwise(T.fmix32(_t(a)), J.fmix32(jnp.asarray(a)), "fmix32")
    assert_bitwise(T.hash_combine(_t(a), _t(b)),
                   J.hash_combine(jnp.asarray(a), jnp.asarray(b)),
                   "hash_combine")


def test_hashes_at_the_int32_edges():
    a, b = np.meshgrid(EDGES, EDGES)
    a, b = a.ravel(), b.ravel()
    assert_bitwise(T.fmix32(_t(a)), J.fmix32(jnp.asarray(a)), "fmix32")
    assert_bitwise(T.hash_combine(_t(a), _t(b)),
                   J.hash_combine(jnp.asarray(a), jnp.asarray(b)),
                   "hash_combine")


@pytest.mark.parametrize("order", range(1, 17))
def test_xy2d_d2xy_equal_jax(order):
    rng = np.random.default_rng(order)
    x = rng.integers(0, 1 << order, 500).astype(np.int32)
    y = rng.integers(0, 1 << order, 500).astype(np.int32)
    d = T.xy2d(_t(x), _t(y), order)
    assert_bitwise(d, J.xy2d(jnp.asarray(x), jnp.asarray(y), order),
                   f"xy2d order {order}")
    # d2xy over the order's index range and over arbitrary int32 bits
    for dd in (d.numpy(), rng.integers(-(1 << 31), 1 << 31, 500,
                                       dtype=np.int64).astype(np.int32)):
        for got, want, name in zip(T.d2xy(_t(dd), order),
                                   J.d2xy(jnp.asarray(dd), order), "xy"):
            assert_bitwise(got, want, f"d2xy order {order} {name}")
    gx, gy = T.d2xy(d, order)
    assert_bitwise(gx, x, "d2xy(xy2d) x")
    assert_bitwise(gy, y, "d2xy(xy2d) y")


@settings(max_examples=40, deadline=None)
@given(st.lists(I32, min_size=2, max_size=40), st.integers(1, 16))
def test_xy2d_equal_jax_on_any_int32(vals, order):
    """Points outside the grid too: the reference's uint32 wrap of
    ``s - 1 - x`` is reproduced."""
    v = np.asarray(vals, np.int32)
    x, y = v, v[::-1].copy()
    assert_bitwise(T.xy2d(_t(x), _t(y), order),
                   J.xy2d(jnp.asarray(x), jnp.asarray(y), order), "xy2d")


def _profiles(seed, n):
    rng = np.random.default_rng(seed)
    built = checks.random_profiles(rng, n, wildcard=0.1, bad_vkind=0.05,
                                   zero_rows=0.05)
    raw = rng.integers(-(1 << 31), 1 << 31, (n, TP.PROFILE_WIDTH),
                       dtype=np.int64).astype(np.int32)
    raw[:, TP.L_USED::TP.SLOT_WIDTH] = rng.integers(-2, 3, (n, TP.MAX_SLOTS))
    raw[:, TP.L_VKIND::TP.SLOT_WIDTH] = rng.integers(0, 7, (n, TP.MAX_SLOTS))
    return np.concatenate([built, raw])


@pytest.mark.parametrize("order", [4, 8, 16])
def test_profile_point_and_index_equal_jax(order):
    profs = _profiles(order, 200)
    for got, want, name in zip(T.profile_point(_t(profs), order),
                               J.profile_point(jnp.asarray(profs), order),
                               "xy"):
        assert_bitwise(got, want, f"profile_point {name}")
    assert_bitwise(T.profile_index(_t(profs), order),
                   J.profile_index(jnp.asarray(profs), order),
                   "profile_index")
    # leading batch dims broadcast as in the reference
    p3 = profs[:60].reshape(3, 20, -1)
    assert_bitwise(T.profile_index(_t(p3), order),
                   J.profile_index(jnp.asarray(p3), order),
                   "profile_index [3, 20]")


@pytest.mark.parametrize("granularity,num_ranks", [
    (2, 3), (4, 16), (8, 256), (8, 65536), (6, 65536), (9, 7), (12, 1000),
    (16, 65536), (16, 1)])
def test_index_to_rank_equal_jax(granularity, num_ranks):
    """Both branches (2 * order <= 16 and the hi/lo split), with rank
    counts large enough that the reference's uint32 products wrap."""
    rng = np.random.default_rng(granularity * 7 + num_ranks)
    idx = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 300, dtype=np.int64),
        np.arange(min(4 ** granularity, 300)), EDGES]).astype(np.int32)
    assert_bitwise(T.index_to_rank(_t(idx), num_ranks, granularity),
                   J.index_to_rank(jnp.asarray(idx), num_ranks, granularity),
                   f"index_to_rank g{granularity} R{num_ranks}")


INTERESTS = [
    JP.ProfileBuilder().add_single("Drone").add_single("Li*").build(),
    JP.ProfileBuilder().add_range("lat", 38, 42).build(),
    JP.ProfileBuilder().add_range("lat", -50, 3000).build(),
    JP.ProfileBuilder().add_pair("type", "ima*").build(),
    JP.ProfileBuilder().add_any("type").build(),
    JP.ProfileBuilder().add_single("*").build(),
    JP.profile("Drone", lat=40),
    JP.profile("Drone", t="img3"),
]


@pytest.mark.parametrize("granularity", [2, 4, 6])
@pytest.mark.parametrize("order", [8, 16])
def test_interest_regions_equal_jax(order, granularity):
    for i, prof in enumerate(INTERESTS):
        try:
            want = J.interest_regions(prof, order, granularity)
        except IndexError:
            # a RANGE whose bounds wrap past 2^order leaves no cell: the
            # reference fails on it, and so must the port
            with pytest.raises(IndexError):
                T.interest_regions(prof, order, granularity)
            continue
        got = T.interest_regions(prof, order, granularity)
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"interest {i}")


def test_port_profiles_encode_as_the_reference():
    b = [m.ProfileBuilder().add_single("Drone").add_single("Li*")
         .add_pair("type", "ima*").add_pair("k", "v").add_num("lat", -40)
         .add_range("x", -5, 5).add_any("y").add_single("*").build()
         for m in (JP, TP)]
    np.testing.assert_array_equal(b[0], b[1])
    np.testing.assert_array_equal(JP.profile("a", "b*", n=3, r=(1, 2), s="x"),
                                  TP.profile("a", "b*", n=3, r=(1, 2), s="x"))
    batch = TP.batch_profiles([b[1], b[1]], device="cpu")
    assert batch.dtype == torch.int32 and batch.shape == (2, 128)
    np.testing.assert_array_equal(batch.numpy(),
                                  np.asarray(JP.batch_profiles([b[0], b[0]])))
    assert TP.batch_profiles([], device="cpu").shape == (0, 128)


@pytest.mark.parametrize("order", range(1, 17))
def test_hilbert_equals_jax_kernel(order):
    rng = np.random.default_rng(order * 1000 + 77)
    x = rng.integers(0, 1 << order, 1100).astype(np.int32)
    y = rng.integers(0, 1 << order, 1100).astype(np.int32)
    before = hilbert_xy2d.launches
    got = hilbert_xy2d(_t(x), _t(y), order)
    assert hilbert_xy2d.launches == before      # the CPU runs the plain loop
    assert_bitwise(got, j_hilbert(jnp.asarray(x), jnp.asarray(y), order,
                                  interpret=True), f"hilbert order {order}")


def test_hilbert_nd_shape_equals_jax_kernel():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 8, (4, 33)).astype(np.int32)
    y = rng.integers(0, 1 << 8, (4, 33)).astype(np.int32)
    got = hilbert_xy2d(_t(x), _t(y), 8)
    assert got.shape == (4, 33)
    assert_bitwise(got, j_hilbert(jnp.asarray(x), jnp.asarray(y), 8,
                                  interpret=True), "hilbert (4, 33)")
    assert_bitwise(got, hilbert_xy2d_ref(_t(x), _t(y), 8), "hilbert ref")


def test_hilbert_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        hilbert_xy2d(x.long(), x.long())
    with pytest.raises(ValueError):
        hilbert_xy2d(x, x[:3])
    with pytest.raises(ValueError):
        hilbert_xy2d(x, x, 33)


def test_check_hilbert_runs_on_the_cpu_and_measures_its_error():
    """The card's check, on the CPU: the wrapper takes its plain version
    and launches nothing, and the difference it reports is measured."""
    before = hilbert_xy2d.launches
    assert checks.check_hilbert("cpu", 4096) == 0.0
    assert hilbert_xy2d.launches == before
    near = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32)
    assert checks.max_int_err(near, near) == 0.0
    assert checks.max_int_err(near, near - torch.tensor([1, 0],
                                                        dtype=torch.int32)) == 1.0
