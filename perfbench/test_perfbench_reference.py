"""The plain reference holds the configuration's guarantees on a small
feed on the CPU, agrees with the program there, and the precision
control (the reference's core in TF32) fails the check's limit."""
from __future__ import annotations

import torch

from perfbench.conftest import SEED, cell, run_small, shrink
from perfbench.pb import feed as F
from perfbench.pb.cli import verdict
from perfbench.reference import compare as RC
from perfbench.reference import stream as RS
from perfbench.systems import stream as ST


def _reference(name: str, ticks: int, seed: int = SEED):
    c = shrink(cell(name))
    cfg = c["config"]
    shards = cfg.get("num_regions", 1) * cfg.get("edges_per_region", 1)
    feed = F.Feed(c["traffic"], cfg, range(shards), seed, "cpu")
    p = torch.as_tensor(ST.core_weights(cfg, seed)).double()
    ref = RS.Stream(cfg, p, "cpu")
    done = ref.run(feed, ticks, set(range(ticks)))
    return c, feed, ref, done


def test_gateway_guarantees():
    c, feed, ref, done = _reference("gateway.redeliver", 14)
    cfg, tr = c["config"], c["traffic"]
    b = cfg["micro_batch"]
    n = ref.counters()
    offered = n["items_offered"][0]
    assert offered == 14 * b
    # none lost: every offered row is accepted, deduped or rejected
    assert offered == n["items_accepted"][0] + n["items_deduped"][0] \
        + n["items_rejected"][0]
    # every re-send of an accepted row is deduped (ticks 1..13)
    n_dup = round(tr["redeliver_share"] * b)
    assert n["items_deduped"][0] >= 13 * (n_dup - tr["nan_rows"])
    # the NaN rows are rejected, counted on their field
    assert n["items_rejected"][0] >= 14 * tr["nan_rows"]
    assert sum(n["drift_counts"][0]) >= 14 * tr["nan_rows"]
    assert n["items_dequeued"][0] == n["items_accepted"][0]
    # the windows: exact float32 sums; a float64 sum is within rounding
    for t, (inc, out) in done.items():
        assert out["window_count"].max() <= cfg["window"]
        assert torch.isfinite(out["aggregates"]).all()
        hot = (t % feed.p) // tr["hot_run"] % 2 == 1
        share = out["escalated"].float().mean()
        assert (share > 0.5) == hot
        assert int(out["processed"].sum()) <= cfg["core_capacity"]


def test_fleet_budgets_bind_on_hot_ticks_only():
    c, feed, ref, done = _reference("fleet_8x2.hotcold", 12)
    cfg, tr = c["config"], c["traffic"]
    for t, (inc, out) in done.items():
        hot = (t % feed.p) // tr["hot_run"] % 2 == 1
        shed = sum(inc["fog_shed"])
        over = inc["fleet_core_overflow"]
        assert (shed > 0 and over > 0) == hot, (t, shed, over)
        assert int(out["processed"].sum()) <= cfg["core_budget"]
        sent = sum(inc["escalations_sent"])
        assert sent <= cfg["num_regions"] * cfg["fog_budget"]
        assert sum(inc["core_received"]) == sent


def test_windows_match_float64_sums():
    c, feed, ref, done = _reference("fleet_8x2.hotcold", 3)
    cfg = c["config"]
    _, out = done[2]
    # tick 2's windows over tick 1's last rows and tick 2's block
    rows = torch.cat([feed.items[0, 1, -(cfg["window"] - cfg["stride"]):],
                      feed.items[0, 2]]).double()
    w = rows.unfold(0, cfg["window"], cfg["stride"]).mean(-1)
    assert torch.allclose(out["aggregates"][0].double(), w, atol=1e-6)


def test_program_matches_reference_on_cpu():
    for name in ("gateway.redeliver", "fleet_8x2.hotcold"):
        run = run_small(cell(name))
        nums = run["numbers"]
        assert nums["window_mismatches"] == 0, (name, nums)
        assert nums["counter_mismatches"] == 0, (name, nums)
        assert nums["ticks_checked"] >= 2
        ok, _ = verdict(nums, cell(name)["config"]["limits"])
        assert ok, (name, nums)


def _fnv1a(wire: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the 32-bit words of ``[N, C]`` float32 rows: the id
    the program's admission gives a row (``stream/ingest.py``)."""
    words = wire.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = torch.full(words.shape[:1], 2166136261, dtype=torch.int64)
    for c in range(words.shape[1]):
        h = ((h ^ words[:, c]) * 16777619) & 0xFFFFFFFF
    return h


def _colliding(stamp_a: float, stamp_c: float, d: int):
    """Two rows of N(0, 1) fields, stamped ``stamp_a`` and ``stamp_c``,
    whose FNV-1a ids are equal (a birthday search over 2^18 each)."""
    gen = torch.Generator().manual_seed(5)
    n = 1 << 18
    xa, xc = (torch.randn((n, d), generator=gen) for _ in range(2))
    ha = _fnv1a(torch.cat([torch.full((n, 1), stamp_a), xa], 1))
    hc = _fnv1a(torch.cat([torch.full((n, 1), stamp_c), xc], 1))
    hit = torch.isin(hc, ha).nonzero()[0, 0]
    return xa[(ha == hc[hit]).nonzero()[0, 0]], xc[hit]


def test_fresh_row_taken_for_a_resend_reads_incorrect(monkeypatch):
    """The check holds the program to the row's identity: a fresh row of
    tick 1 whose contents hash to the id of an accepted row of tick 0
    is one the program drops as a re-delivery, and the run reads
    ``correct`` false, with one row more deduped than was re-sent."""
    c = cell("gateway.redeliver")
    b, d = 1024, c["config"]["features"]           # shrink's micro-batch
    orig = F._shard_pool

    def planted(traffic, cfg, seed, device):
        items, rel = orig(traffic, cfg, seed, device)
        a, k = (int(((rel[t] >= 0) & ~items[t].isnan().any(1))
                     .nonzero()[0, 0]) for t in (0, 1))
        items[0, a], items[1, k] = _colliding(float(a), float(b + k), d)
        for t in (1, 2):      # the re-sends copy the planted rows too
            dup = rel[t] < 0
            items[t, dup] = items[t - 1, (rel[t, dup] + b).long()]
        return items, rel
    monkeypatch.setattr(F, "_shard_pool", planted)
    run = run_small(c)
    ok, _ = verdict(run["numbers"], c["config"]["limits"])
    assert not ok, run["numbers"]
    got, want = run["counter_diffs"]["items_deduped"]
    assert got[0] == want[0] + 1, (got, want)


def test_tf32_control_fails_the_core_limit():
    """The control: the reference put in the program's place with its
    core in TF32 (the precision below the configuration's float32),
    read by the same comparison: it must fail ``core_gap``."""
    for name in ("gateway.redeliver", "fleet_8x2.hotcold"):
        c, feed, ref, done = _reference(name, 8, SEED + 3)
        cfg = c["config"]
        p32 = torch.as_tensor(ST.core_weights(cfg, SEED + 3))
        nums = RC.control_numbers(cfg, done, p32)
        assert nums["window_mismatches"] == 0
        limit = cfg["limits"]["core_gap"]
        assert nums["core_gap"] > 3 * limit, (name, nums)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.0000002])
    y = RC.tf32(x)
    assert y.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.0]
