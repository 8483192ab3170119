"""The port's copy of the dedupe-window numpy oracle
(``repro_torch.kernels.dedupe_window.ref``) against the reference's
(``repro.kernels.dedupe_window.ref``) and against the port's torch
stage (``ops.row_hash``, ``dedupe_window``, ``seen_record``), on random
wire rows with re-sent rows, rows not offered, an all-empty and a
partly filled seen ring, and windows of 0, 1 and 64 slots; bitwise
(uint32 hashes, int64 values in ``[0, 2^32)`` on the torch side)."""
import numpy as np
import pytest
import torch

from repro.kernels.dedupe_window import ref as RR
from repro_torch.kernels.dedupe_window import ops
from repro_torch.kernels.dedupe_window import ref as TR


def _rows(rng, n: int) -> np.ndarray:
    rows = rng.standard_normal((n, 5)).astype(np.float32)
    rows[n // 2:n // 2 + 5] = rows[:5]                  # re-sent rows
    rows[-1] = -0.0                                      # signed zero row
    return rows


def test_constants_and_row_hash_equal():
    assert (TR.FNV_BASIS, TR.FNV_PRIME, TR.EMPTY_HASH) == \
        (RR.FNV_BASIS, RR.FNV_PRIME, RR.EMPTY_HASH)
    assert (int(TR.FNV_BASIS), int(TR.FNV_PRIME), int(TR.EMPTY_HASH)) == \
        (ops.FNV_BASIS, ops.FNV_PRIME, ops.EMPTY_HASH)
    rows = _rows(np.random.default_rng(0), 257)
    want = RR.row_hash_ref(rows)
    got = TR.row_hash_ref(rows)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.row_hash(torch.from_numpy(rows)).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k", [0, 1, 64])
def test_window_and_record_equal(k):
    rng = np.random.default_rng(k)
    for fill in (0, k // 2, k):
        rows = _rows(rng, 96)
        hashes = RR.row_hash_ref(rows)
        offered = rng.random(96) < 0.8
        seen = np.zeros(k, np.uint32)
        seen[:fill] = hashes[rng.integers(0, 96, fill)]
        want = RR.dedupe_window_ref(hashes, offered, seen)
        got = TR.dedupe_window_ref(hashes, offered, seen)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        tfresh, tdup = ops.dedupe_window(
            torch.from_numpy(hashes.astype(np.int64)),
            torch.from_numpy(offered),
            torch.from_numpy(seen.astype(np.int64)))
        np.testing.assert_array_equal(tfresh.numpy(), want[0])
        np.testing.assert_array_equal(tdup.numpy(), want[1])
        accepted = want[0] & (np.cumsum(want[0]) <= 40)  # backpressure
        pos = int(rng.integers(0, max(k, 1)))
        wseen, wpos = RR.seen_record_ref(seen, pos, hashes, accepted)
        gseen, gpos = TR.seen_record_ref(seen, pos, hashes, accepted)
        np.testing.assert_array_equal(gseen, wseen)
        assert gpos == wpos
        tseen, tpos = ops.seen_record(
            torch.from_numpy(seen.astype(np.int64)), torch.tensor(pos),
            torch.from_numpy(hashes.astype(np.int64)),
            torch.from_numpy(accepted))
        np.testing.assert_array_equal(tseen.numpy(), wseen.astype(np.int64))
        assert int(tpos) == wpos
