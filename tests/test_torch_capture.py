"""The compile-once step (``repro_torch.runtime.capture``) on the CPU.

The reference's trace-count assertions, ported: the stream executor's
tick is built once for a fixed feed on every path (staged, fused,
overlapped ingest, admission), once more for a new producer batch
shape and never for an operand (the core budget, the ingest mode, the
fleet's masks and budgets); a fleet remesh or a slot ceiling that grows
adds exactly one; through a controlled arc the executor's count stays
within ``FleetController.max_trace_count`` and ``1 + resizes``.  Where
the JAX executor runs in-process on this jax (the stream executor), its
count on the same feed is held equal.  On the CPU nothing is captured,
so ``_compile_count`` equals ``trace_count``, and the first tick's wall
time is withheld from the latency histogram (``warmup_excluded``) as the
reference withholds a compile.

Then the copy-in and copy-out rules, which run here as on the card:
tick k's outputs survive tick k + 1, a state the executor did not hand
out (a ``clone_state`` copy) is copied in and gives the same ticks, a
returned tensor changed in place is copied in, a ring of another shape
raises, and the step equals ``capture.disable()`` bit for bit.  And the
function registry's ahead-of-time cache: one step a signature
(``aot_cached``), a module keyed by identity.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro_torch.core import pipeline as tpipe
from repro_torch.core import profiles as P
from repro_torch.core import rules as trules
from repro_torch.core.serverless import FunctionRegistry
from repro_torch.runtime import ElasticBudget, StragglerDetector, capture
from repro_torch.stream import StreamConfig
from repro_torch.stream import executor as TX
from repro_torch.stream import ingest as TI
from repro_torch.stream.executor import clone_state
from repro_torch.stream.fleet import (Churn, Fault, FaultInjector,
                                      FaultSchedule, FleetConfig,
                                      FleetController, FleetExecutor)
from repro_torch.testing import assert_bitwise

from test_torch_stream import BATCH, D, _Clock, _feed, _pair


def _fresh(monkeypatch, **kw):
    """``_pair`` on a fresh fake clock: two runs stamp the same wall
    times into their rings."""
    monkeypatch.setattr(TX, "time", _Clock())
    return _pair(**kw)[1]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _run(ex, state, feed, **kw):
    outs = []
    for items, ts in feed:
        state, out = ex.step(state, items, ts, **kw)
        outs.append(out)
    return state, outs


def _jax_run(jx, feed, **kw):
    js = jx.init_state(D)
    for items, ts in feed:
        js, _ = jx.step(js, jnp.asarray(items), jnp.asarray(ts), **kw)
    return js


PATHS = {"staged": {}, "fused": dict(fused=True),
         "overlap": dict(overlap=True), "admission": dict(admission={"k": 64})}


@pytest.mark.parametrize("path", list(PATHS))
def test_stream_tick_builds_once(path):
    """``trace_count == 1`` after warmup on every path, as the JAX
    executor counts on the same feed; on the CPU ``_compile_count``
    equals it and the first tick is withheld from the histogram."""
    jx, tx = _pair(**PATHS[path])
    feed = _feed(steps=6)
    if path == "overlap":
        _, outs = tx.run(tx.init_state(D), feed)
        assert len(outs) == len(feed)
    else:
        _run(tx, tx.init_state(D), feed)
    _jax_run(jx, feed)
    assert tx.trace_count == 1 == jx.trace_count
    assert tx._compile_count() == tx.trace_count
    lat = tx.latency_percentiles()
    assert lat["warmup_excluded"] == 1 and lat["count"] == len(feed) - 2


def test_new_batch_shape_builds_one_more():
    """A new producer batch shape is a new signature (the reference
    retraces); going back to the first shape builds nothing."""
    jx, tx = _pair()
    feed = _feed(steps=6)
    half = [(items[:BATCH // 2], ts[:BATCH // 2]) for items, ts in feed[3:5]]
    sched = feed[:3] + half + feed[5:]
    _run(tx, tx.init_state(D), sched)
    _jax_run(jx, sched)
    assert tx.trace_count == 2 == jx.trace_count
    assert tx._compile_count() == 2


def test_stream_operands_build_nothing():
    """The core budget and the ingest mode are operands: resizing the
    budget and replay and backfill ticks keep ``trace_count == 1``, as
    in the reference."""
    jx, tx = _pair(core_capacity=3)
    feed = _feed(steps=6)
    ts_, js = tx.init_state(D), jx.init_state(D)
    for i, (items, ts) in enumerate(feed):
        if i == 2:
            tx.set_core_budget(1)
            jx.set_core_budget(1)
        mode = (TI.MODE_LIVE, TI.MODE_REPLAY, TI.MODE_BACKFILL)[i % 3]
        ts_, _ = tx.step(ts_, items, ts, mode=mode)
        js, _ = jx.step(js, jnp.asarray(items), jnp.asarray(ts), mode=mode)
    ts_, _ = tx.step(ts_, *feed[0], mode=torch.tensor(TI.MODE_REPLAY))
    assert tx.trace_count == 1 == jx.trace_count


def _engine():
    return trules.RuleEngine([trules.threshold_rule(
        "hot", 0, ">=", 1.0, trules.C_SEND_CORE, priority=2)])


def _fleet(e=4, regions=2, **kw):
    engine = _engine()
    scfg = StreamConfig(micro_batch=BATCH, window=16, stride=16,
                        capacity=4 * BATCH, lateness=4.0)
    cfg = dict(stream=scfg, num_shards=e, num_core=2, core_budget=4,
               core_budget_max=8, num_regions=regions, fog_budget=4,
               fog_budget_max=8)
    cfg.update(kw)
    return FleetExecutor(
        FleetConfig(**cfg), engine, tpipe.two_tier_pipeline(
            lambda p, b: (b * 1.5, b[:, :5]),
            lambda p, b: (b + 100.0, b[:, :5]), engine), device="cpu")


def _fleet_feed(rng, e, t):
    items = rng.standard_normal((e, BATCH, D)).astype(np.float32)
    items[:, :, 0] += (t % 3 == 0) * 1.5
    ts = np.tile(t * BATCH + np.arange(BATCH, dtype=np.float32), (e, 1))
    return items, ts


def test_fleet_operands_build_nothing_and_remesh_adds_one():
    """Health and membership flips, budgets within their ceilings and
    replay ticks are operands of the fleet tick; a budget grown past its
    slot ceiling and a remesh each build exactly one more signature."""
    ex = _fleet()
    st = ex.init_state(D)
    rng = np.random.default_rng(7)
    for t in range(8):
        if t == 2:
            ex.set_health([True, False, True, True])
        if t == 3:
            ex.set_active([True, True, True, False])
            ex.set_core_budget(2)
            ex.set_region_budget([3, 8])
        if t == 4:
            ex.set_health([True] * 4)
            ex.set_active([True] * 4)
        st, _ = ex.step(st, *_fleet_feed(rng, 4, t),
                        mode=np.asarray([0, t % 2, 0, 2 * (t % 2)],
                                        np.int32))
    assert ex.trace_count == 1 == ex._compile_count()
    ex.set_core_budget(12)                    # past the ceiling of 8
    st, _ = ex.step(st, *_fleet_feed(rng, 4, 8))
    st, _ = ex.step(st, *_fleet_feed(rng, 4, 9))
    assert ex.trace_count == 2
    st, _ = ex.remesh(st, 6)                  # 2 regions of 3
    assert ex.trace_count == 2                # counted at the next tick
    for t in range(10, 13):
        st, _ = ex.step(st, *_fleet_feed(rng, 6, t))
    assert ex.trace_count == 3 == ex._compile_count()
    assert ex.latency_percentiles()["warmup_excluded"] == 3


def test_controlled_arc_holds_the_trace_bound():
    """The reference's instrumented arc (``tests/test_obs.py``) on the
    port: a stall of shard 2, shard 5 leaving (its stream replayed on a
    backup) and rejoining, the elastic budget resizing; then
    ``trace_count <= max_trace_count <= 1 + resizes``, and a remesh down
    to 7 shards costs exactly one more."""
    e = 8
    engine = _engine()
    scfg = StreamConfig(micro_batch=BATCH, window=16, stride=16,
                        capacity=4 * BATCH, lateness=4.0)
    ex = FleetExecutor(
        FleetConfig(stream=scfg, num_shards=e, num_core=2, core_budget=4,
                    core_budget_max=16), engine,
        tpipe.two_tier_pipeline(lambda p, b: (b * 1.5, b[:, :5]),
                                lambda p, b: (b + 100.0, b[:, :5]), engine),
        device="cpu")
    ctl = FleetController(
        ex, budget_policy=ElasticBudget(min_budget=2, max_budget=64,
                                        patience=2),
        wall_detector=StragglerDetector(e, window=3, threshold=3.0,
                                        patience=2))
    state = ex.init_state(D)
    sched = FaultSchedule([Fault(shard=2, start=4, end=7)],
                          churn=[Churn(shard=5, leave=10, join=15)])
    inj = FaultInjector(sched)
    rng = np.random.default_rng(0)
    backups, t = {}, 0
    while t < 20 or inj.pending:
        if t == 10:
            backups = {5: ctl.leave(5)}
        if t == 15:
            ctl.join(5)
        drain = t >= 20
        items = (np.zeros((e, BATCH, D), np.float32) if drain else
                 rng.standard_normal((e, BATCH, D)).astype(np.float32))
        if not drain:
            items[:, :, 0] += (t % 3 == 0) * 1.5
        ts = np.tile(t * BATCH + np.arange(BATCH, dtype=np.float32), (e, 1))
        items, ts, offered, replay = inj.inject(t, items, ts,
                                                fresh=not drain,
                                                backups=backups)
        state, _ = ex.step(state, items, ts, offered=offered, replay=replay)
        ctl.tick(state, step_times=sched.stall_time(t, e))
        t += 1
    assert ctl.resizes > 0
    assert ex.trace_count <= ctl.max_trace_count <= 1 + ctl.resizes, \
        (ex.trace_count, ctl.max_trace_count, ctl.resizes)
    before = ex.trace_count
    state, _ = ctl.remesh(state, e - 1, keep=[j for j in range(e) if j != 5])
    items = rng.standard_normal((e - 1, BATCH, D)).astype(np.float32)
    ts = np.tile(t * BATCH + np.arange(BATCH, dtype=np.float32), (e - 1, 1))
    state, _ = ex.step(state, items, ts)
    ctl.tick(state, step_times=np.full(e - 1, 0.1))
    assert ex.trace_count == before + 1 <= ctl.max_trace_count


# -- copy-in and copy-out --------------------------------------------------------

def _snapshot(tree):
    return [t.clone() for t in capture.flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def _assert_same(a, b, what):
    la = [t for t in capture.flatten(a)[0] if isinstance(t, torch.Tensor)]
    lb = [t for t in capture.flatten(b)[0] if isinstance(t, torch.Tensor)]
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert_bitwise(x, y, f"{what} leaf {i}")


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_outputs_survive_the_next_tick_and_equal_eager(fused, monkeypatch):
    """Tick k's outputs and returned state (less the ring, written in
    place as the reference donates it) are unchanged by tick k + 1; the
    whole run equals ``capture.disable()`` bit for bit (less the latency
    histogram, whose first sample the built run withholds)."""
    feed = _feed(steps=6)
    tx = _fresh(monkeypatch, fused=fused)
    st, kept = tx.init_state(D), []
    for items, ts in feed:
        st, out = tx.step(st, items, ts)
        kept.append((out, st._replace(rb=None), _snapshot(out),
                     _snapshot(st._replace(rb=None))))
    for out, small, out0, small0 in kept:
        _assert_same(out, out0, "a kept output")
        _assert_same(small, small0, "a kept state")
    ex = _fresh(monkeypatch, fused=fused)
    with capture.disable():
        se, eager = _run(ex, ex.init_state(D), feed)
    assert ex.trace_count == 0
    for i, (a, b) in enumerate(zip([k[0] for k in kept], eager)):
        _assert_same(a, b, f"tick {i}")
    _assert_same(st, se, "final state")
    assert int(tx._lat_hist.sum()) == int(ex._lat_hist.sum()) - 1
    _assert_same(tx._lineage, ex._lineage, "lineage")


def test_foreign_state_is_copied_in(monkeypatch):
    """A ``clone_state`` copy, a state taken mid-run and a returned tensor
    changed in place all reach the tick: the results equal the same
    sequence run eagerly."""
    feed = _feed(steps=7)
    runs = []
    for eager in (False, True):
        tx = _fresh(monkeypatch)
        ctx = capture.disable() if eager else torch.no_grad()
        with ctx:
            st = tx.init_state(D)
            st, _ = _run(tx, st, feed[:2])
            st = clone_state(st)                   # a foreign state
            st, _ = _run(tx, st, feed[2:4])
            st.carry.add_(1.0)                     # changed in place
            st, outs = _run(tx, st, feed[4:])
        runs.append((st, outs))
    (sg, og), (se, oe) = runs
    _assert_same(sg, se, "state")
    _assert_same(og, oe, "outputs")


def test_mismatched_ring_raises():
    _, tx = _pair(capacity=128)
    _, other = _pair(capacity=256)
    items, ts = _feed(steps=1)[0]
    with pytest.raises(ValueError, match="ring"):
        tx.step(other.init_state(D), items, ts)


def test_pack_roundtrip_and_alignment():
    """The output slab: every dtype and shape (0-dim, empty, bool, a
    broadcast view) comes back bit for bit, each slot 16-byte aligned."""
    ts = [torch.tensor(3, dtype=torch.int32), torch.arange(5.0),
          torch.zeros((0, 3)), torch.tensor([True, False, True]),
          torch.full((), -0.0), torch.arange(6, dtype=torch.int64)
          .reshape(2, 3).t(), torch.ones(1).expand(4),
          torch.tensor([1.5, 2.5], dtype=torch.bfloat16)
          .view(torch.int16)]
    slots, nbytes = capture.layout(ts)
    assert all(s.off % 16 == 0 for s in slots) and nbytes % 16 == 0
    slab = capture.pack(ts, slots, nbytes, torch.zeros(16, dtype=torch.uint8))
    assert slab.shape == (nbytes,)
    for a, b in zip(ts, capture.unpack(slab, slots)):
        assert b.shape == a.shape and b.dtype == a.dtype
        assert_bitwise(b, a, "slot")


def test_donated_outputs_must_match_their_arguments():
    def bad(state, x):
        return x, (state[0].sum(),)
    step = capture.Step(bad, device="cpu", donate_argnums=(0,))
    with pytest.raises(ValueError, match="donated argument"):
        step((torch.zeros(3),), torch.ones(3))


# -- the registry's ahead-of-time cache ------------------------------------------

def test_start_function_caches_one_step_a_signature():
    """One step for each signature; a second signature is a second
    entry (``aot_cached == 2``); a module is keyed by identity."""
    reg = FunctionRegistry(device="cpu")
    reg.store_function("f", P.profile("t"), lambda m, x: (m(x),))
    lin = torch.nn.Linear(4, 4)
    x4 = torch.ones((2, 4))
    [(_, s1)] = reg.start_function(P.profile("t"), lin, x4)
    [(_, s2)] = reg.start_function(P.profile("t"), lin, torch.zeros((2, 4)))
    assert s1 is s2 and isinstance(s1, capture.Step)
    assert reg.statistics()["aot_cached"] == 1
    reg.start_function(P.profile("t"), lin, torch.ones((3, 4)))
    assert reg.statistics()["aot_cached"] == 2
    reg.start_function(P.profile("t"), torch.nn.Linear(4, 4), x4)
    assert reg.statistics()["aot_cached"] == 3
    for _ in range(3):
        (y,) = s1(lin, x4)
    assert s1.trace_count == 1 == s1.compile_count
    assert_bitwise(y, lin(x4), "step output")


def test_serve_run_replays_one_cached_step():
    """``serve.run`` resolves the decode step through the registry with
    the model, the caches and the lengths (donated): one cached step,
    built once, equal to the same run under ``capture.disable()``."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = smoke_config("yi_6b")
    model = T.init_params(cfg, seed=0, device="cpu")
    res = serve.run(cfg, 2, 6, 4, device="cpu", model=model)
    assert res.aot_cached == 1 and res.step.trace_count == 1
    with capture.disable():
        ref = serve.run(cfg, 2, 6, 4, device="cpu", model=model)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert_bitwise(_bits(res.logits), _bits(ref.logits), "final logits")
    assert_bitwise(res.lengths, ref.lengths, "final lengths")
