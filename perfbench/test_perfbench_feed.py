"""The one traffic generator: the same seed gives the same pool, the
re-sends copy the previous tick's fresh rows stamps and all, the NaN
rows are where the seed puts them, and the stamps are exact float32."""
from __future__ import annotations

import torch

from perfbench.conftest import SEED, cell, shrink
from perfbench.pb import feed as F


def _feed(seed, shards=(0,), name="gateway.redeliver"):
    c = shrink(cell(name))
    return F.Feed(c["traffic"], c["config"], shards, seed, "cpu"), c


def test_pool_reproducible_from_seed():
    a, _ = _feed(SEED)
    b, _ = _feed(SEED)
    c, _ = _feed(SEED + 1)
    assert torch.equal(a.items.view(torch.int32), b.items.view(torch.int32))
    assert torch.equal(a.rel, b.rel)
    assert not torch.equal(a.items.nan_to_num(), c.items.nan_to_num())
    assert not torch.equal(a.rel, c.rel)


def test_redelivery_copies_previous_tick():
    f, c = _feed(SEED)
    tr, b = c["traffic"], c["config"]["micro_batch"]
    n_dup = round(tr["redeliver_share"] * b)
    for t in range(1, 2 * f.p):
        items, ts = (x.clone() for x in f.tick(t))
        prev_items, prev_ts = (x.clone() for x in f.tick(t - 1))
        dup = f.rel[0, t % f.p] < 0
        assert int(dup.sum()) == n_dup
        src = (f.rel[0, t % f.p][dup] + b).long()
        # a re-send is the row the previous tick offered there, stamp too
        assert torch.equal(items[0][dup].view(torch.int32),
                           prev_items[0][src].view(torch.int32))
        assert torch.equal(ts[0][dup], prev_ts[0][src])
        # and carries its identity: the ordinal of its first sending
        assert torch.equal(f.ids(t)[0][dup], f.ids(t - 1)[0][src])
        assert torch.equal(f.ids(t)[0][~dup],
                           torch.arange(b)[~dup] + t * b)
        # and that row was fresh there
        assert bool((f.rel[0, (t - 1) % f.p][src] >= 0).all())
        fresh = ~dup
        nan_rows = torch.isnan(items[0][fresh]).any(1)
        assert int(nan_rows.sum()) == tr["nan_rows"]
        assert int(torch.isnan(items[0][fresh]).sum()) == tr["nan_rows"]


def test_stamps_exact_past_2_24():
    f, c = _feed(2 ** 40 + 5)
    b = c["config"]["micro_batch"]
    t = (1 << 24) // b + 3001
    _, ts = f.tick(t)
    want = (torch.arange(b, dtype=torch.float64) + t * b).to(torch.float32)
    fresh = f.rel[0, t % f.p] >= 0
    assert torch.equal(ts[0][fresh], want[fresh])
    assert torch.equal(f.stamps(t), ts)


def test_fleet_shards_alike_on_any_rank():
    whole, _ = _feed(SEED, range(8), "fleet_8x2.hotcold")
    part, _ = _feed(SEED, (2, 3), "fleet_8x2.hotcold")
    assert torch.equal(whole.items[2:4], part.items)
    assert not torch.equal(whole.items[0], whole.items[1])
    hot = [(k // 2) % 2 == 1 for k in range(whole.p)]
    means = whole.items[..., 0].mean((0, 2))
    for k, h in enumerate(hot):
        assert (means[k] > 0.3) == h


def test_sampling_draws_from_seed():
    a, b = F.Sampler(SEED, 32), F.Sampler(SEED + 1, 32)
    picks = [t for t in range(4000) if a(t)]
    assert picks[0] == 0 and 80 <= len(picks) <= 170
    assert picks != [t for t in range(4000) if b(t)]
    assert picks == [t for t in range(4000) if F.Sampler(SEED, 32)(t)]
