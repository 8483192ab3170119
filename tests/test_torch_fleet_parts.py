"""The fleet's parts on the port, against the JAX package in-process on
one host device: ``ingest_and_window``'s fleet arguments, the exchange
helpers of ``core.routing``, ``stream.fleet.routing`` and the watermark
and federation functions of ``stream.fleet.federation``,
``runtime.elastic``, and ``FleetConfig``'s checks and derived sizes.

Everything is bitwise (integers and float bit patterns) unless a test
says otherwise; the whole fleet is held against the reference's
``FleetExecutor`` in ``test_torch_fleet.py``.
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import routing as JR
from repro.core import rules as jrules
from repro.core.overlay import Overlay as JOverlay
from repro.runtime.elastic import ElasticBudget as JElasticBudget
from repro.runtime.elastic import rebuild_overlay as j_rebuild_overlay
from repro.stream import executor as JX
from repro.stream import ingest as JI
from repro.stream.fleet import FleetConfig as JFleetConfig
from repro.stream.fleet import federation as JF
from repro.stream.fleet import routing as JFR
from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import routing as TR
from repro_torch.core import rules as trules
from repro_torch.runtime import elastic as TE
from repro_torch.stream import executor as TX
from repro_torch.stream import ingest as TI
from repro_torch.stream.fleet import FleetConfig as TFleetConfig
from repro_torch.stream.fleet import federation as TF
from repro_torch.stream.fleet import routing as TFR
from repro_torch.testing import assert_bitwise

D, BATCH = 3, 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# -- ingest_and_window's fleet arguments -------------------------------------

def _engine(mod):
    return mod.RuleEngine([
        mod.threshold_rule("hot", 0, ">=", 0.5, mod.C_SEND_CORE, priority=1),
        mod.threshold_rule("sparse", 4, "<", 8.0, mod.C_STORE_EDGE)])


def _ingest_ticks(case: str, rng) -> list[dict]:
    """Eight ticks of offers with the fleet arguments ``case`` names: the
    same keyword arguments for either package (numpy values)."""
    ticks, t0 = [], 0.0
    for i in range(8):
        items = rng.standard_normal((BATCH, D)).astype(np.float32)
        ts = (t0 + np.arange(BATCH)).astype(np.float32)
        t0 += BATCH
        kw = dict(items=items, ts=ts, now=np.float32(0.5 + 0.25 * i))
        if case in ("watermark", "all"):
            # a fleet minimum behind this stream, and a reference past it
            kw["watermark_ts"] = np.float32(t0 - 3 * BATCH)
            kw["excluded_ref"] = np.float32(t0 - BATCH // 2)
            if i == 4:
                ts[:6] -= 70.0          # late by the fleet, not by itself
        if case in ("offer_mask", "all"):
            mask = rng.random(BATCH) < 0.7
            if i == 2:
                mask[:] = False         # a stalled uplink
            kw["offer_mask"] = mask
        if case in ("replay", "all") and i in (3, 6):
            kw["replay"] = np.bool_(True)
            ts -= 300.0                 # old by construction
        if case in ("backfill", "all") and i == 5:
            kw["mode"] = np.int32(JI.MODE_BACKFILL)
            ts -= 500.0
        if case == "all" and i not in (3, 5, 6):
            kw["mode"] = np.int32(JI.MODE_LIVE)
        ticks.append(kw)
    return ticks


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["watermark", "offer_mask", "replay",
                                  "backfill", "all", "admission"])
def test_ingest_fleet_arguments_match_the_reference(case, fused):
    """Each fleet argument of ``ingest_and_window`` over 8 ticks with a
    carried state (ring, carry, clock, dedupe window): every result
    field, ``n_late_excluded`` included, equals the reference's."""
    kw = dict(micro_batch=BATCH, window=16, stride=8, capacity=96,
              lateness=8.0)
    adm = case == "admission"
    jcfg = JX.StreamConfig(**kw, admission=JI.AdmissionPlan(
        64 if adm else 0))
    tcfg = TX.StreamConfig(**kw, fused=fused, admission=TI.AdmissionPlan(
        64 if adm else 0))
    je, te = _engine(jrules), _engine(trules)
    fns = (lambda _, b: (b, b[:, :5]), lambda _, b: (b + 1.0, b[:, :5]))
    jx = JX.StreamExecutor(jcfg, je, jpipe.two_tier_pipeline(*fns, je))
    js = jx.init_state(D)
    ts_ = convert.state_from_numpy(jax.device_get(js), device="cpu")
    ticks = _ingest_ticks("all" if adm else case,
                          np.random.default_rng(7))
    if adm:
        ticks[5]["items"], ticks[5]["ts"] = ticks[4]["items"], ticks[4]["ts"]
    fields = [f for f in JX.IngestResult._fields if f not in ("rb", "adm")]
    assert "n_late_excluded" in fields
    seen = {f: 0 for f in ("n_late", "n_late_excluded", "n_replayed",
                           "n_backfilled", "n_deduped")}
    for i, tk in enumerate(ticks):
        jargs = {k: jnp.asarray(v) for k, v in tk.items()}
        targs = {k: _t(v) for k, v in tk.items()}
        ji = JX.ingest_and_window(jcfg, je, js, **jargs)
        ti = TX.ingest_and_window(tcfg, te, ts_, **targs)
        for f in fields:
            assert_bitwise(getattr(ti, f), getattr(ji, f), f"tick {i} {f}")
        for f in seen:
            seen[f] += int(getattr(ji, f))
        js = JX.StreamState(ji.rb, ji.carry, ji.carry_valid, ji.max_ts,
                            js.metrics, ji.adm)
        ts_ = TX.StreamState(ti.rb, ti.carry, ti.carry_valid, ti.max_ts,
                             ts_.metrics, ti.adm)
        got = convert.state_to_numpy(ts_)
        assert_bitwise(got["rb"]["buf"], js.rb.buf, f"tick {i} ring")
        assert_bitwise(got["rb"]["tail"], js.rb.tail, f"tick {i} tail")
        assert_bitwise(got["adm"]["seen"], js.adm.seen, f"tick {i} seen")
    # the case really exercised its argument
    want = {"watermark": "n_late_excluded", "replay": "n_replayed",
            "backfill": "n_backfilled", "admission": "n_deduped"}.get(case)
    if want is not None:
        assert seen[want] > 0, seen


def test_ingest_replay_and_mode_are_exclusive():
    cfg = TX.StreamConfig(micro_batch=8, window=4, stride=4, capacity=16)
    st = TX.StreamExecutor(cfg, _engine(trules), tpipe.two_tier_pipeline(
        lambda _, b: (b, b[:, :5]), lambda _, b: (b, b[:, :5]),
        _engine(trules)), device="cpu").init_state(D)
    with pytest.raises(ValueError, match="not both"):
        TX.ingest_and_window(cfg, _engine(trules), st, torch.zeros(8, D),
                             torch.zeros(8), replay=True, mode=1)


# -- core.routing: batched plans and the exchange helpers --------------------

@pytest.mark.parametrize("seed", range(4))
def test_make_plan_and_buckets_with_a_leading_dim(seed):
    """A batched plan, scatter and gather equal the reference's, one
    leading row at a time."""
    rng = np.random.default_rng(seed)
    nd, cap = 5, 3
    dest = rng.integers(0, nd, (4, 20)).astype(np.int32)
    items = rng.standard_normal((4, 20, 2)).astype(np.float32)
    items[0, 0] = -0.0                  # the add's zero rounds it to +0
    plan = TR.make_plan(_t(dest), nd, cap)
    buckets = TR.scatter_to_buckets(_t(items), plan, nd, cap)
    back = TR.gather_from_buckets(buckets, plan)
    for b in range(4):
        jp = JR.make_plan(jnp.asarray(dest[b]), nd, cap)
        for f in JR.DispatchPlan._fields:
            assert_bitwise(getattr(plan, f)[b], getattr(jp, f), f"{b} {f}")
        jb = JR.scatter_to_buckets(jnp.asarray(items[b]), jp, nd, cap)
        assert_bitwise(buckets[b], jb, f"{b} buckets")
        assert_bitwise(back[b], JR.gather_from_buckets(jb, jp), f"{b} back")


@pytest.mark.parametrize("seed", range(6))
def test_escalation_plan_and_recv_slots_match(seed):
    """Seeded per-shard escalation masks and budgets, binding ones
    included: each shard's send plan and global slots, and each rank's
    receive occupancy, equal the reference's."""
    rng = np.random.default_rng(seed)
    e, n = int(rng.integers(1, 7)), 24
    num_core = int(rng.integers(1, e + 1))
    cap = -(-n // num_core)
    esc = rng.random((e, n)) < rng.uniform(0.1, 0.9)
    counts = esc.sum(1).astype(np.int32)
    budget = int(rng.integers(0, max(1, counts.sum())))  # binds
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    plan, g = TR.escalation_plan(_t(esc), _t(offsets), e, num_core, cap)
    ranks = torch.arange(e, dtype=torch.int32)
    under, occ, slots = TR.escalation_recv_slots(
        _t(counts), ranks, num_core, cap, budget)
    for s in range(e):
        jp, jg = JR.escalation_plan(jnp.asarray(esc[s]), offsets[s], e,
                                    num_core, cap)
        for f in JR.DispatchPlan._fields:
            assert_bitwise(getattr(plan, f)[s], getattr(jp, f), f"{s} {f}")
        assert_bitwise(g[s], jg, f"{s} slots")
        ju, jo, js = JR.escalation_recv_slots(jnp.asarray(counts), s,
                                              num_core, cap, budget)
        assert_bitwise(under[s], ju, f"rank {s} under budget")
        assert_bitwise(occ[s], jo, f"rank {s} occupied")
        assert_bitwise(slots[s], js, f"rank {s} slots")
    assert int(under.sum()) == min(budget, int(counts.sum()))


def test_all_to_all_route_and_route_and_deliver():
    """The exchange is a transpose (``recv[dst][src] == send[src][dst]``),
    and ``route_and_deliver`` equals each rank's reference
    ``route_local`` followed by that exchange."""
    rng = np.random.default_rng(3)
    e, n, d, cap = 4, 40, 3, 16
    send = rng.standard_normal((e, e, cap, d)).astype(np.float32)
    recv = TR.all_to_all_route(_t(send))
    for i in range(e):
        for j in range(e):
            assert_bitwise(recv[i, j], send[j, i], f"{i} <- {j}")
    table = np.arange(16, dtype=np.int32) % e
    idx = rng.integers(-2**31, 2**31, (e, n)).astype(np.int32)
    payload = rng.standard_normal((e, n, d)).astype(np.float32)
    got, counts = TR.route_and_deliver(_t(payload), _t(idx), _t(table), e,
                                       cap)
    ref = [JR.route_local(jnp.asarray(payload[s]), jnp.asarray(idx[s]),
                          jnp.asarray(table), e, cap) for s in range(e)]
    for dst in range(e):
        for src in range(e):
            assert_bitwise(got[dst, src], ref[src][0][dst], f"{dst}<-{src}")
            assert int(counts[dst, src]) == int(ref[src][1].counts[dst])


# -- stream.fleet.routing ----------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_fleet_routing_matches_the_reference(seed):
    """``region_survivor_counts`` and ``fog_recv_occupancy`` one region
    and one column at a time, and batched (every region and column at
    once), against the reference's numpy functions."""
    rng = np.random.default_rng(seed)
    rr, ee, num_core = 2, int(rng.integers(2, 6)), int(rng.integers(1, 3))
    counts = rng.integers(0, 9, (rr, ee)).astype(np.int32)
    budget = rng.integers(0, 30, rr).astype(np.int32)   # binds sometimes
    cap = 8
    surv = TFR.region_survivor_counts(_t(counts), _t(budget)[:, None])
    rs = surv.sum(-1)
    roff = torch.cumsum(rs, 0) - rs
    occ = TFR.fog_recv_occupancy(surv[:, None, :],
                                 torch.arange(ee)[:, None],
                                 roff[:, None, None], num_core, cap)
    for r in range(rr):
        ref = JFR.region_survivor_counts(counts[r], budget[r])
        np.testing.assert_array_equal(surv[r].numpy(), ref)
        one = TFR.region_survivor_counts(_t(counts[r]), _t(budget[r]))
        np.testing.assert_array_equal(one.numpy(), ref)
        for col in range(ee):
            want = JFR.fog_recv_occupancy(ref, col, int(roff[r]), num_core,
                                          cap)
            np.testing.assert_array_equal(occ[r, col].numpy(), want)
            np.testing.assert_array_equal(TFR.fog_recv_occupancy(
                _t(ref), col, int(roff[r]), num_core, cap).numpy(), want)


@pytest.mark.parametrize("geom", [(1, 8, 2, 16, 8), (2, 4, 2, 16, 6),
                                  (4, 16, 3, 11, 40)])
def test_tiered_exchange_bytes(geom):
    t = TFR.TieredExchange(*geom)
    j = JFR.TieredExchange(*geom)
    for fn in ("intra_region_bytes", "cross_region_bytes",
               "flat_exchange_bytes"):
        assert getattr(t, fn)(9) == getattr(j, fn)(9)
        assert getattr(t, fn)(9, itemsize=2) == getattr(j, fn)(9, itemsize=2)


# -- stream.fleet.federation -------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_tiered_watermark_matches_the_references(seed):
    """The port's tiered watermark over random ``[R, E]`` maxima, health
    and membership masks (empty regions and all-excluded fleets
    included) against ``tiered_watermark_ref`` and ``layered_min_ref``,
    the reference's and the port's copies alike."""
    rng = np.random.default_rng(seed)
    rr, ee = int(rng.integers(1, 4)), int(rng.integers(1, 5))
    mt = (rng.standard_normal((rr, ee)) * 100).astype(np.float32)
    h = rng.random((rr, ee)) < [0.0, 0.4, 0.9][seed % 3]
    a = rng.random((rr, ee)) < [0.3, 0.8, 1.0][seed // 4 % 3]
    fleet, region = TF.tiered_watermark(_t(mt), _t(h), _t(a))
    jfleet, jregion = JF.tiered_watermark_ref(mt, h, a)
    tfleet, tregion = TF.tiered_watermark_ref(mt, h, a)
    assert tfleet == jfleet and list(tregion) == list(jregion)
    assert float(fleet) == jfleet
    np.testing.assert_array_equal(region.numpy().astype(np.float64), jregion)
    for r in range(rr):
        assert float(region[r]) == JF.layered_min_ref(mt[r], h[r], a[r]) \
            == TF.layered_min_ref(mt[r], h[r], a[r])
    flat = TF.fleet_watermark(_t(mt.reshape(-1)), _t(h.reshape(-1)),
                              _t(a.reshape(-1)))
    assert float(flat) == JF.layered_min_ref(mt.reshape(-1), h.reshape(-1),
                                             a.reshape(-1))
    assert float(TF.fleet_watermark(_t(mt.reshape(-1)))) == mt.min()


def _core(b):
    return b + 100.0, b[:, :5]


@pytest.mark.parametrize("budget", [3, 40, 1000])
def test_flat_federation_is_one_region_of_the_tiered(budget):
    """``federate_escalations`` and ``federate_escalations_tiered`` with
    one region and a non-binding fog budget give the same results (the
    reference's flat-fleet equality), budgets binding or not."""
    rng = np.random.default_rng(budget)
    e, n, r, num_core = 4, 16, 7, 2
    rec = _t(rng.standard_normal((e, n, r)).astype(np.float32))
    esc = _t(rng.random((e, n)) < 0.6)
    cap = -(-n // num_core)
    flat = TF.federate_escalations(rec, esc, _core, num_shards=e,
                                   num_core=num_core, core_budget=budget,
                                   capacity=cap, core_slots=budget)
    tier = TF.federate_escalations_tiered(
        rec, esc, _core, num_regions=1, edges_per_region=e,
        num_core=num_core, region_budget=e * n, core_budget=budget,
        edge_capacity=cap, cross_capacity=-(-e * n // num_core),
        core_slots=budget)
    for a, b, what in zip(flat[:3], tier[:3], ("out", "feats", "done")):
        assert_bitwise(a, b, what)
    fs, ts = flat[3], tier[3]
    for f in ("escalations_sent", "core_received", "core_processed",
              "fleet_escalations", "fleet_overflow"):
        assert_bitwise(getattr(fs, f), getattr(ts, f), f)
    assert int(fs.core_processed.sum()) == min(budget, int(esc.sum()))
    assert int(ts.fog_shed.sum()) == 0
    # processed records carry the core stage's result, the rest zeros
    done = flat[2]
    assert_bitwise(flat[0][done], rec[done] + 100.0, "core outputs")
    assert not flat[0][~done].any()


def test_allreduce_metrics_sums_and_replicates():
    m = TX.StreamMetrics(*(torch.arange(4, dtype=torch.int32) * (i + 1)
                           for i in range(len(TX.StreamMetrics._fields) - 1)),
                         drift_counts=torch.ones((4, 3), dtype=torch.int32))
    out = TF.allreduce_metrics(m)
    for i, v in enumerate(out[:-1]):
        assert v.tolist() == [6 * (i + 1)] * 4 and v.dtype == torch.int32
    assert out.drift_counts.tolist() == [[4, 4, 4]] * 4


# -- runtime.elastic ---------------------------------------------------------

@pytest.mark.parametrize("shape,n,fix_regions,want", [
    ((2, 4), 6, True, (2, 3)),
    ((2, 4), 12, False, (3, 4)),
])
def test_remesh_shapes(shape, n, fix_regions, want):
    assert TE.remesh(*shape, n, fix_regions) == want


@pytest.mark.parametrize("shape,n,fix_regions", [
    ((2, 4), 7, True),
    ((2, 4), 6, False),
    ((2, 4), 0, True),
])
def test_remesh_refuses_what_the_reference_refuses(shape, n, fix_regions):
    with pytest.raises(ValueError):
        TE.remesh(*shape, n, fix_regions)


def test_elastic_budget_matches_the_reference():
    rng = np.random.default_rng(5)
    t, j = TE.ElasticBudget(4, 64), JElasticBudget(4, 64)
    bt = bj = 8
    for demand in rng.integers(0, 80, 60):
        bt, bj = t.propose(int(demand), bt), j.propose(int(demand), bj)
        assert bt == bj
    with pytest.raises(ValueError):
        TE.ElasticBudget(0, 4)


@pytest.mark.parametrize("shape", [{"region": 2, "edge": 4},
                                   {"region": 1, "edge": 8},
                                   {"edge": 5}])
def test_rebuild_overlay_matches_the_reference(shape):
    got = TE.rebuild_overlay(tuple(shape.values()))
    ref = j_rebuild_overlay(SimpleNamespace(shape=shape))
    assert isinstance(ref, JOverlay)
    for g in (2, 4):
        np.testing.assert_array_equal(got.routing_table(g),
                                      ref.routing_table(g))


def test_reshard_state_reslices_rows():
    st = TX.StreamMetrics(*(torch.arange(3) + 10 * i for i in range(16)))
    fresh = TX.StreamMetrics(*(torch.full((4,), -1) for _ in range(16)))
    out = TE.reshard_state(st, [2, None, 0, 1], fresh)
    assert out.steps.tolist() == [2, -1, 0, 1]
    assert out.drift_counts.tolist() == [152, -1, 150, 151]


# -- FleetConfig -------------------------------------------------------------

_SCFG = dict(micro_batch=BATCH, window=16, stride=8, capacity=128)


@pytest.mark.parametrize("bad", [
    dict(num_shards=0), dict(num_shards=6, num_regions=4),
    dict(num_shards=4, num_core=0), dict(num_shards=4, num_core=5),
    dict(num_shards=8, num_regions=2, num_core=5),
    dict(num_shards=4, core_budget=-1),
    dict(num_shards=4, core_budget=8, core_budget_max=4),
    dict(num_shards=4, fog_budget=-2),
    dict(num_shards=4, fog_budget=8, fog_budget_max=4),
])
def test_fleet_config_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        JFleetConfig(stream=JX.StreamConfig(**_SCFG), **bad)
    with pytest.raises(ValueError):
        TFleetConfig(stream=TX.StreamConfig(**_SCFG), **bad)


@pytest.mark.parametrize("good", [
    dict(num_shards=8), dict(num_shards=8, num_regions=2, num_core=2),
    dict(num_shards=8, num_regions=2, num_core=3, core_budget=5,
         core_budget_max=9, fog_budget=7, fog_budget_max=13),
    dict(num_shards=6, num_regions=3, num_core=2, fog_budget=4),
])
def test_fleet_config_derived_sizes_match(good):
    j = JFleetConfig(stream=JX.StreamConfig(**_SCFG), **good)
    t = TFleetConfig(stream=TX.StreamConfig(**_SCFG), **good)
    for p in ("edges_per_region", "core_slots", "fog_slots",
              "initial_fog_budget", "route_capacity", "cross_capacity"):
        assert getattr(t, p) == getattr(j, p), p
    assert t.exchange().__dict__ == j.exchange().__dict__
