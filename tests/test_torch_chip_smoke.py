"""``chip_smoke.py``'s AR data-plane phase, rehearsed on the CPU at a
tiny size: the same functions the card runs, with the kernels' plain
versions.  The card-only pieces (``torch.cuda.synchronize``, the
kernels' launch counts, which stay 0 on the CPU) are stubbed."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.testing import assert_bitwise

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ar_phase_runs_and_checks_itself(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = smoke.read_launches
    monkeypatch.setattr(smoke, "read_launches",
                        lambda: {k: max(v, 1) for k, v in real().items()})
    sz = smoke.ARSizes(n=256, shard=4096, interests=32, queries=4, steps=3,
                       warmup=1)
    ar = smoke.run_ar(sz, "cpu")
    assert len(ar["secs"]) == 3 and ar["found"] == 10
    # the RP takes at most `capacity` messages a step from this source
    assert 0 < ar["kept"] <= 3 * sz.n // 64
    assert 0 < ar["notify_share"] < 1 and ar["min_hits"] > 0
    # the pre-fill, the warm-up step, then the measured steps' kept rows
    assert int(ar["shard"].cursor) >= sz.shard + ar["kept"]


def test_ar_card_vs_cpu_compares_every_output(smoke):
    sz = smoke.ARSizes(n=128, shard=2048, interests=16, queries=2, steps=2,
                       warmup=0)
    seen = []

    def bitwise(a, b, what):
        assert_bitwise(a, b, what)
        seen.append(what)
    assert smoke.run_ar_card_vs_cpu(sz, "cpu", bitwise) == 2
    assert {"AR step 1 notify", "AR step 1 plan keep", "AR shard stamps",
            "AR step 0 query 1 n_hits"} <= set(seen)


def test_ar_fails_without_kernel_launches(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sz = smoke.ARSizes(n=128, shard=1024, interests=8, queries=1, steps=1,
                       warmup=0)
    with pytest.raises(RuntimeError, match="launched no hilbert kernel"):
        smoke.run_ar(sz, "cpu")


def test_armatch_ops_counts_each_used_slot_pair(smoke):
    """The bound's operation count against a count pair by pair."""
    import numpy as np
    from repro_torch.core import profiles as P
    from repro_torch.kernels.checks import random_profiles
    rng = np.random.default_rng(3)
    kw = dict(wildcard=0.1, bad_vkind=0.1, zero_rows=0.1)
    data = random_profiles(rng, 23, **kw)
    ints = random_profiles(rng, 9, max_slots=4, **kw)
    cost = {P.VK_NONE: 7, P.VK_EXACT: 12, P.VK_PREFIX: 15, P.VK_ANY: 8,
            P.VK_RANGE: 12}
    want = 0
    d = data.reshape(-1, P.MAX_SLOTS, P.SLOT_WIDTH)
    p = ints.reshape(-1, P.MAX_SLOTS, P.SLOT_WIDTH)
    want += 3 * int((d[..., P.L_USED] > 0).sum())
    want += 2 * int((p[..., P.L_USED] > 0).sum())
    for row in d:
        for prof in p:
            want += 1
            for ps in prof[prof[:, P.L_USED] > 0]:
                want += 1
                for ds in row[row[:, P.L_USED] > 0]:
                    want += cost.get(int(ps[P.L_VKIND]), 0)
    assert smoke.armatch_ops(torch.from_numpy(data),
                             torch.from_numpy(ints)) == want
