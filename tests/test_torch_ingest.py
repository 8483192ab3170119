"""The port's admission lane against the JAX reference: FNV-1a event
ids, the sort-based dedupe window against the reference's ``[N, K]``
compare, the seen-ring recording, and the contract gate."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import dedupe_window as JD
from repro.kernels.dedupe_window import ref as JDR
from repro.stream import ingest as JI
from repro_torch.kernels import dedupe_window as TD
from repro_torch.stream import ingest as TI
from repro_torch.testing import assert_bitwise


def _u32(t: torch.Tensor) -> np.ndarray:
    """Port hashes (int64 in [0, 2^32)) as the reference's uint32."""
    a = t.numpy()
    assert ((a >= 0) & (a < 1 << 32)).all()
    return a.astype(np.uint32)


def test_constants_match_reference():
    assert (TD.FNV_BASIS, TD.FNV_PRIME, TD.EMPTY_HASH) == \
        (int(JDR.FNV_BASIS), int(JDR.FNV_PRIME), int(JDR.EMPTY_HASH))


def test_row_hash_bitwise_with_special_words():
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((64, 5)).astype(np.float32)
    rows[1, 2], rows[2, 0] = -0.0, 0.0
    rows[3, 1] = np.nan
    rows[4, 3] = np.float32(np.inf)
    rows[5] = np.frombuffer(np.asarray([0x7FC00001, 0xFFFFFFFF, 1, 0x80000000,
                                        0x00000001], np.uint32).tobytes(),
                            np.float32)
    # a row whose FNV-1a is 0 before the bump: the single word w with
    # (BASIS ^ w) * PRIME == 0 mod 2^32, i.e. w = BASIS (PRIME is odd)
    zero = np.frombuffer(np.uint32(JDR.FNV_BASIS).tobytes(),
                         np.float32).copy()
    h_ref = np.asarray(JD.row_hash(jnp.asarray(rows)))
    h_port = _u32(TD.row_hash(torch.from_numpy(rows)))
    np.testing.assert_array_equal(h_port, h_ref)
    np.testing.assert_array_equal(h_port, JD.row_hash_ref(rows))
    z = _u32(TD.row_hash(torch.from_numpy(zero.reshape(1, 1))))
    assert z[0] == 1 == int(JD.row_hash_ref(zero.reshape(1, 1))[0])


@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("n", [1, 9, 40])
def test_sort_dedupe_equals_reference(n, k):
    """Random batches with in-batch and cross-tick duplicates and offer
    masks, against the reference's compare-matrix version."""
    rng = np.random.default_rng(n * 100 + k)
    seen_j = jnp.zeros((k,), jnp.uint32)
    pos_j = jnp.zeros((), jnp.int32)
    seen_t = torch.zeros(k, dtype=torch.int64)
    pos_t = torch.zeros((), dtype=torch.int32)
    prev = None
    for _ in range(6):
        rows = rng.standard_normal((n, 3)).astype(np.float32)
        if prev is not None and n >= 3:
            rows[0] = prev[-1]               # cross-tick re-delivery
            rows[-1] = rows[n // 2]          # in-batch duplicate
            rows[1] = rows[n // 2]
        prev = rows
        offered = rng.random(n) < 0.8
        h_j = JD.row_hash(jnp.asarray(rows))
        h_t = TD.row_hash(torch.from_numpy(rows))
        fresh_j, dup_j = JD.dedupe_window(h_j, jnp.asarray(offered), seen_j)
        fresh_t, dup_t = TD.dedupe_window(h_t, torch.from_numpy(offered),
                                          seen_t)
        assert_bitwise(fresh_t, fresh_j, "fresh")
        assert_bitwise(dup_t, dup_j, "dup")
        n_acc = int(rng.integers(0, int(fresh_t.sum()) + 1))
        rank = np.cumsum(fresh_t.numpy()) - 1
        accepted = fresh_t.numpy() & (rank < n_acc)
        seen_j, pos_j = JD.seen_record(seen_j, pos_j, h_j,
                                       jnp.asarray(accepted))
        seen_t, pos_t = TD.seen_record(seen_t, pos_t, h_t,
                                       torch.from_numpy(accepted))
        np.testing.assert_array_equal(_u32(seen_t), np.asarray(seen_j))
        assert_bitwise(pos_t, pos_j, "seen_pos")


def test_seen_record_more_than_k_accepted():
    rng = np.random.default_rng(2)
    k, n = 5, 23
    h = rng.integers(1, 1 << 32, n, dtype=np.int64)
    accepted = rng.random(n) < 0.8
    seen0 = rng.integers(1, 1 << 32, k, dtype=np.int64)
    seen_t, pos_t = TD.seen_record(torch.from_numpy(seen0),
                                   torch.tensor(3, dtype=torch.int32),
                                   torch.from_numpy(h),
                                   torch.from_numpy(accepted))
    seen_r, pos_r = JD.seen_record_ref(seen0.astype(np.uint32), 3,
                                       h.astype(np.uint32), accepted)
    np.testing.assert_array_equal(_u32(seen_t), seen_r)
    assert int(pos_t) == pos_r


@pytest.mark.parametrize("contract", [
    None,
    {"lo": (-1.0, -2.0, 0.0), "hi": (1.0, 2.0, 0.7)},
    {"require_finite": False, "lo": (-0.5,) * 3},
])
def test_admission_gate_and_record_equal_reference(contract):
    rng = np.random.default_rng(5)
    plans = [mod.AdmissionPlan(8, contract and mod.DataContract(**contract))
             for mod in (JI, TI)]
    adm_j = JI.admission_init(plans[0])
    adm_t = TI.admission_init(plans[1], device="cpu")
    prev = None
    for tick in range(4):
        items = rng.standard_normal((12, 3)).astype(np.float32)
        items[0, 1] = np.nan
        items[1, 2] = np.inf
        ts = np.arange(12, dtype=np.float32) + 12 * tick
        if prev is not None:
            items[2:5], ts[2:5] = prev[0][2:5], prev[1][2:5]
        prev = (items, ts)
        offer = rng.random(12) < 0.9
        g_j = JI.admission_gate(plans[0], adm_j, jnp.asarray(ts),
                                jnp.asarray(items), jnp.asarray(offer))
        g_t = TI.admission_gate(plans[1], adm_t, torch.from_numpy(ts),
                                torch.from_numpy(items),
                                torch.from_numpy(offer))
        for f in ("admit", "n_deduped", "n_contract", "drift"):
            assert_bitwise(getattr(g_t, f), getattr(g_j, f), f"tick {tick} {f}")
        np.testing.assert_array_equal(_u32(g_t.hashes), np.asarray(g_j.hashes))
        n_acc = max(0, int(g_t.admit.sum()) - tick)   # some backpressure
        adm_j = JI.admission_record(plans[0], adm_j, g_j, jnp.int32(n_acc))
        adm_t = TI.admission_record(plans[1], adm_t, g_t,
                                    torch.tensor(n_acc, dtype=torch.int32))
        np.testing.assert_array_equal(_u32(adm_t.seen), np.asarray(adm_j.seen))
        assert_bitwise(adm_t.seen_pos, adm_j.seen_pos, "seen_pos")


def test_plan_validation_and_inert():
    with pytest.raises(ValueError, match="dedupe_window"):
        TI.AdmissionPlan(dedupe_window=-1)
    with pytest.raises(ValueError, match="lo"):
        TI.DataContract(lo=(0.0,), hi=(1.0, 2.0))
    assert TI.AdmissionPlan().inert
    assert not TI.AdmissionPlan(contract=TI.DataContract()).inert
