"""The port's ``core.store`` against the JAX package, bit for bit, on
the arcs of ``tests/test_store.py`` and ``tests/test_core.py``: ring
eviction, 7 rows into 4 slots, masked rows, tombstones reused by the
ring, and ``max_results`` past the capacity.  After every operation
the whole shard (keys, values, stamps, cursor) is compared field by
field through ``convert.store_to_numpy``, and every query is run on
both sides.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import profiles as JP
from repro.core import store as J
from repro_torch import convert
from repro_torch.core import store as T
from repro_torch.kernels import checks
from repro_torch.testing import assert_bitwise


def _key(i: int) -> np.ndarray:
    return JP.ProfileBuilder().add_single("Sensor") \
        .add_pair("id", f"k{i}").build()


def _rows(lo, hi, d=2):
    keys = np.stack([_key(i) for i in range(lo, hi)])
    vals = np.repeat(np.arange(lo, hi, dtype=np.float32)[:, None], d, 1)
    return keys, vals


WILDCARD = JP.ProfileBuilder().add_single("Sensor").add_any("id").build()
QUERIES = [WILDCARD, _key(1), _key(5),
           JP.ProfileBuilder().add_pair("id", "k*").build(),
           JP.ProfileBuilder().add_single("*").build(),
           JP.ProfileBuilder().add_single("Nothing").build()]


def _compare(jst, tst, what):
    got = convert.store_to_numpy(tst)
    for f in J.ShardStore._fields:
        assert_bitwise(got[f], np.asarray(getattr(jst, f)), f"{what}: {f}")


def _queries(jst, tst, keys, what):
    cap = tst.capacity
    for qi, q in enumerate(QUERIES):
        for k in (1, 3, cap, cap + 5):
            want = J.query_match(jst, jnp.asarray(q), k)
            got = T.query_match(tst, torch.from_numpy(q), k)
            for g, w, name in zip(got, want, ("values", "hits", "n_hits")):
                assert_bitwise(g, w, f"{what}: query {qi} k={k} {name}")
    for i, key in enumerate(keys):
        want = J.query_exact(jst, jnp.asarray(key))
        got = T.query_exact(tst, torch.from_numpy(key))
        for g, w, name in zip(got, want, ("value", "found")):
            assert_bitwise(g, w, f"{what}: exact {i} {name}")


def _run(cap, ops, d=2):
    """Apply ``ops`` to both stores, comparing state and queries after
    each: ("store", lo, hi[, mask]) | ("delete", profile)."""
    jst = J.init_store(cap, d)
    tst = convert.store_from_numpy(jax.device_get(jst), device="cpu")
    _compare(jst, tst, "init")
    seen = []
    for n, op in enumerate(ops):
        if op[0] == "store":
            keys, vals = _rows(op[1], op[2], d)
            seen.extend(keys)
            mask = None if len(op) < 4 else np.asarray(op[3])
            jst = J.store(jst, jnp.asarray(keys), jnp.asarray(vals),
                          None if mask is None else jnp.asarray(mask))
            tst = T.store(tst, torch.from_numpy(keys), torch.from_numpy(vals),
                          None if mask is None else torch.from_numpy(mask))
        else:
            jst = J.delete_matching(jst, jnp.asarray(op[1]))
            tst = T.delete_matching(tst, torch.from_numpy(op[1]))
        _compare(jst, tst, f"op {n} {op[0]}")
        _queries(jst, tst, seen, f"op {n} {op[0]}")
    return jst, tst


def test_ring_eviction_overwrites_oldest_first():
    _run(4, [("store", 0, 4), ("store", 4, 6)])


def test_seven_rows_into_four_slots_newest_win():
    jst, tst = _run(4, [("store", 0, 7)])
    assert sorted(convert.store_to_numpy(tst)["stamps"].tolist()) == [3, 4, 5, 6]


def test_batch_larger_than_capacity_with_masked_rows():
    mask = [True, False, True, True, False, True, True, True, True, False, True]
    _run(4, [("store", 0, 3), ("store", 3, 14, mask), ("store", 14, 16)])


def test_masked_store_rows_consume_no_slots():
    _run(4, [("store", 0, 3, [True, False, True])])


def test_delete_then_ring_reuses_tombstones():
    _run(4, [("store", 0, 4), ("delete", _key(2)), ("store", 4, 6),
             ("delete", WILDCARD), ("store", 6, 7)])


def test_core_arcs_exact_wildcard_and_lru():
    _run(32, [("store", 0, 8)], d=4)
    _run(16, [("store", 0, 2, [True, False]), ("delete", _key(0))])


def test_random_batches_against_reference():
    """Random profiles, values and masks; batches past the capacity."""
    rng = np.random.default_rng(3)
    cap, d = 64, 3
    jst = J.init_store(cap, d)
    tst = T.init_store(cap, d, device="cpu")
    for step in range(6):
        n = int(rng.integers(1, 150))
        keys = checks.random_profiles(rng, n)
        vals = rng.standard_normal((n, d)).astype(np.float32)
        mask = rng.random(n) < 0.7
        jst = J.store(jst, jnp.asarray(keys), jnp.asarray(vals),
                      jnp.asarray(mask))
        tst = T.store(tst, torch.from_numpy(keys), torch.from_numpy(vals),
                      torch.from_numpy(mask))
        _compare(jst, tst, f"step {step}")
        for q in checks.random_profiles(rng, 4, max_slots=2):
            for g, w in zip(T.query_match(tst, torch.from_numpy(q), 8),
                            J.query_match(jst, jnp.asarray(q), 8)):
                assert_bitwise(g, w, f"step {step} query")
        if step == 3:
            q = checks.random_profiles(rng, 1, max_slots=1)[0]
            jst = J.delete_matching(jst, jnp.asarray(q))
            tst = T.delete_matching(tst, torch.from_numpy(q))
            _compare(jst, tst, "delete")


def test_store_round_trips_through_convert():
    jst = J.store(J.init_store(8, 2), jnp.asarray(_rows(0, 5)[0]),
                  jnp.asarray(_rows(0, 5)[1]))
    tst = convert.store_from_numpy(jax.device_get(jst), device="cpu")
    assert tst.keys.shape == (9, 128) and int(tst.stamps[-1]) == -1
    _compare(jst, tst, "round trip")


def test_init_store_shape_and_dtype():
    st = T.init_store(5, 3, dtype=torch.float64, device="cpu")
    assert st.capacity == 5
    assert st.values.dtype == torch.float64 and st.values.shape == (6, 3)
    assert (st.stamps == -1).all() and int(st.cursor) == 0
