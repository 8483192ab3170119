"""The port's ``core.matching`` and ``kernels.armatch`` against the
JAX package, bit for bit.

Profiles are those of ``tests/test_kernels.py`` (built by
``checks.random_profiles`` in bulk) with wildcard attributes, vkinds
outside the codes and all-zero rows, plus the semantics table of
``tests/test_core.py``.  The JAX kernel runs in interpret mode, as its
own tests run it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import matching as J
from repro.core import profiles as JP
from repro.kernels.armatch import armatch as j_armatch
from repro_torch.core import matching as T
from repro_torch.core import profiles as TP
from repro_torch.kernels import checks
from repro_torch.kernels.armatch import armatch, armatch_ref
from repro_torch.testing import assert_bitwise


def _pair(seed, m, n):
    rng = np.random.default_rng(seed)
    kw = dict(wildcard=0.05, bad_vkind=0.03, zero_rows=0.05)
    return (checks.random_profiles(rng, m, **kw),
            checks.random_profiles(rng, n, max_slots=3, **kw))


def test_semantics_table_equals_jax():
    drone = TP.profile("Drone", "LiDAR")
    num = TP.ProfileBuilder().add_single("Drone").add_num("lat", 40).build()
    pair = TP.ProfileBuilder().add_pair("type", "image").build()
    ints = [
        TP.ProfileBuilder().add_single("Drone").add_single("Li*").build(),
        TP.ProfileBuilder().add_single("Drone").add_single("Cam*").build(),
        TP.ProfileBuilder().add_range("lat", 38, 42).build(),
        TP.ProfileBuilder().add_range("lat", 50, 60).build(),
        TP.ProfileBuilder().add_pair("type", "ima*").build(),
        TP.ProfileBuilder().add_pair("type", "video").build(),
        TP.ProfileBuilder().add_any("type").build(),
        TP.ProfileBuilder().add_single("*").build(),
    ]
    data, ints = np.stack([drone, num, pair]), np.stack(ints)
    got = T.match_matrix(torch.from_numpy(data), torch.from_numpy(ints))
    want = J.match_matrix(jnp.asarray(data), jnp.asarray(ints))
    assert_bitwise(got, want, "semantics table")
    np.testing.assert_array_equal(got.numpy().astype(int), [
        [1, 0, 0, 0, 0, 0, 0, 1],
        [0, 0, 1, 0, 0, 0, 0, 1],
        [0, 0, 0, 0, 1, 0, 1, 1],
    ])


def test_slot_match_equals_jax():
    data, ints = _pair(1, 40, 30)
    ps = data.reshape(-1, TP.SLOT_WIDTH)[:, None, :]
    ds = ints.reshape(-1, TP.SLOT_WIDTH)[None, :, :]
    assert_bitwise(T.slot_match(torch.from_numpy(ps), torch.from_numpy(ds)),
                   J.slot_match(jnp.asarray(ps), jnp.asarray(ds)),
                   "slot_match")


@pytest.mark.parametrize("m,n", [(1, 1), (7, 13), (64, 64), (300, 50)])
def test_match_matrix_and_profile_match_equal_jax(m, n):
    data, ints = _pair(m * 1000 + n, m, n)
    td, ti = torch.from_numpy(data), torch.from_numpy(ints)
    want = J.match_matrix(jnp.asarray(data), jnp.asarray(ints))
    assert_bitwise(T.match_matrix(td, ti), want, "match_matrix")
    # the reference's broadcasting forms of profile_match
    assert_bitwise(T.profile_match(ti[None], td[:, None]),
                   J.profile_match(jnp.asarray(ints)[None],
                                   jnp.asarray(data)[:, None]),
                   "profile_match [M, N]")
    assert_bitwise(T.profile_match(ti[0], td[0]),
                   J.profile_match(jnp.asarray(ints[0]), jnp.asarray(data[0])),
                   "profile_match scalar")
    # the store's form: one interest against a table, through armatch
    for j in range(min(n, 4)):
        before = armatch.launches
        got = T.profile_match(ti[j][None], td)
        assert armatch.launches == before
        assert_bitwise(got, J.profile_match(jnp.asarray(ints[j])[None],
                                            jnp.asarray(data)),
                       f"profile_match store form, interest {j}")


def test_match_matrix_in_chunks_equals_one_piece(monkeypatch):
    data, ints = _pair(9, 333, 21)
    td, ti = torch.from_numpy(data), torch.from_numpy(ints)
    whole = T._match_matrix_plain(td, ti)
    # a chunk of 5 rows: 67 chunks, the last one ragged
    monkeypatch.setattr(T, "_CHUNK_ELEMS", 5 * 21 * 64)
    assert_bitwise(T._match_matrix_plain(td, ti), whole, "chunked vs whole")
    assert 0 < int(whole.sum()) < whole.numel()


#: (name, interest of (ints, data), data of (ints, data), armatch calls)
#: for each form of the public entry points: every outer product of
#: interests and data goes through the ``armatch`` wrapper once
_FORMS = [
    ("match_matrix", None, None, 1),
    ("table x one interest", lambda i, d: i[2][None], lambda i, d: d, 1),
    ("table x one interest, 1-d", lambda i, d: i[2], lambda i, d: d, 1),
    ("one data x interests", lambda i, d: i, lambda i, d: d[3], 1),
    ("[1, N] x [M, 1]", lambda i, d: i[None], lambda i, d: d[:, None], 1),
    ("one x one", lambda i, d: i[0], lambda i, d: d[0], 1),
    ("row by row", lambda i, d: i[:9], lambda i, d: d[:9], 0),
]


@pytest.mark.parametrize("form", _FORMS, ids=[f[0] for f in _FORMS])
def test_public_entry_points_dispatch_to_armatch(form, monkeypatch):
    """On a CUDA tensor the kernel runs wherever the wrapper is called;
    here the wrapper's calls are counted and the results held against
    the JAX package."""
    import sys
    name, pick_i, pick_d, calls = form
    data, ints = _pair(77, 40, 11)
    pkg = sys.modules["repro_torch.kernels.armatch"]
    seen = []

    def spy(d, i):
        seen.append((tuple(d.shape), tuple(i.shape)))
        return armatch(d, i)
    monkeypatch.setattr(pkg, "armatch", spy)
    td, ti = torch.from_numpy(data), torch.from_numpy(ints)
    if pick_i is None:
        got = T.match_matrix(td, ti)
        want = J.match_matrix(jnp.asarray(data), jnp.asarray(ints))
    else:
        got = T.profile_match(pick_i(ti, td), pick_d(ti, td))
        want = J.profile_match(jnp.asarray(pick_i(ints, data)),
                               jnp.asarray(pick_d(ints, data)))
    assert len(seen) == calls, seen
    assert all(len(d) == 2 and len(i) == 2 for d, i in seen)
    assert got.dtype == torch.bool
    assert_bitwise(got, want, name)


@pytest.mark.parametrize("m,n", [(1, 1), (7, 13), (130, 129), (300, 50)])
def test_armatch_equals_jax_kernel(m, n):
    data, ints = _pair(m * 7 + n, m, n)
    before = armatch.launches
    got = armatch(torch.from_numpy(data), torch.from_numpy(ints))
    assert armatch.launches == before      # the CPU runs the plain version
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert_bitwise(got, j_armatch(jnp.asarray(data), jnp.asarray(ints),
                                  interpret=True), f"armatch {m}x{n}")


def test_armatch_zero_profiles_never_match():
    real = JP.profile("Drone", "LiDAR", t="img")
    zero = np.zeros(TP.PROFILE_WIDTH, np.int32)
    both = torch.from_numpy(np.stack([real, zero]))
    out = armatch_ref(both, both)
    assert out[1].sum() == 0 and out[:, 1].sum() == 0 and out[0, 0] == 1


def test_armatch_wrapper_rejects_what_the_kernel_does_not_take():
    ok = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        armatch(ok.long(), ok)
    with pytest.raises(ValueError):
        armatch(ok, ok[:, :64])


def test_check_armatch_runs_on_the_cpu_and_measures_its_error(monkeypatch):
    """The card's check, on the CPU, at its ragged shapes; a wrapper that
    answers wrong is caught."""
    assert checks.check_armatch("cpu") == 0.0

    def wrong(data, ints):
        out = armatch_ref(data, ints)
        out[0, 0] = 2
        return out
    wrong.launches = 0
    monkeypatch.setattr(checks, "armatch", wrong)
    with pytest.raises(AssertionError):
        checks.check_armatch("cpu")
