"""Executor parity: the PyTorch port (``repro_torch``, on the CPU)
against the JAX reference executor (``repro``), bit for bit.

The same numpy feed goes through both.  Every ``StepOutput`` field and
the final ``StreamState`` (ring, carry, clock, metrics, dedupe window)
must match through the int32 view of every float; ``outputs`` are
bitwise too, because the stage functions here are elementwise.  Both
executors stamp ring rows with wall time, so each module's clock is
replaced by its own fake that advances the same way; the step-latency
histogram still differs (the reference withholds its compile tick) and
is left out.  Lineage is also compared through ``ingest_and_window``
with an explicit ``now``, as the reference's own tests do.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import pipeline as jpipe
from repro.core import rules as jrules
from repro.obs import latency as jlat
from repro.stream import executor as JX
from repro.stream import ingest as JI
from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rules as trules
from repro_torch.obs import latency as tlat
from repro_torch.obs.trace import Tracer
from repro_torch.stream import executor as TX
from repro_torch.stream import ingest as TI
from repro_torch.testing import assert_bitwise

from test_ingest import _admission_feed

D, BATCH, WINDOW, STRIDE = 3, 32, 16, 8


class _Clock:
    """Stands in for the ``time`` module of one executor module: every
    ``perf_counter()`` call advances a quarter second."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


@pytest.fixture(autouse=True)
def _same_clock(monkeypatch):
    monkeypatch.setattr(JX, "time", _Clock())
    monkeypatch.setattr(TX, "time", _Clock())


def _engine(mod):
    """Two-rule conflict set, the same spec in either package."""
    return mod.RuleEngine([
        mod.threshold_rule("hot", 0, ">=", 0.5, mod.C_SEND_CORE, priority=1),
        mod.threshold_rule("sparse", 4, "<", 8.0, mod.C_STORE_EDGE)])


def _pair(fused=False, overlap=False, int8=False, admission=None,
          core_capacity=2, capacity=128, lateness=8.0):
    """(JAX staged executor, port executor on the CPU) on one config."""
    kw = dict(micro_batch=BATCH, window=WINDOW, stride=STRIDE,
              capacity=capacity, lateness=lateness)
    adm = admission or {}
    jcfg = JX.StreamConfig(**kw, admission=JI.AdmissionPlan(
        adm.get("k", 0), adm.get("contract") and
        JI.DataContract(**adm["contract"])))
    tcfg = TX.StreamConfig(**kw, fused=fused, overlap_ingest=overlap,
                           ingest_int8=int8, admission=TI.AdmissionPlan(
                               adm.get("k", 0), adm.get("contract") and
                               TI.DataContract(**adm["contract"])))
    fns = (lambda _, b: (b, b[:, :5]), lambda _, b: (b + 100.0, b[:, :5]))
    je, te = _engine(jrules), _engine(trules)
    jx = JX.StreamExecutor(jcfg, je, jpipe.two_tier_pipeline(
        *fns, je, core_capacity=core_capacity))
    tx = TX.StreamExecutor(tcfg, te, tpipe.two_tier_pipeline(
        *fns, te, core_capacity=core_capacity), device="cpu")
    return jx, tx


def _feed(seed=11, steps=8, straggle_at=3):
    rng = np.random.default_rng(seed)
    feed, t0 = [], 0.0
    for i in range(steps):
        items = rng.standard_normal((BATCH, D)).astype(np.float32)
        ts = np.asarray(t0 + np.arange(BATCH), np.float32)
        if i == straggle_at:
            ts[:2] -= 1000.0          # stragglers hit the watermark
        t0 += BATCH
        feed.append((items, ts))
    return feed


def _jax_state(s) -> dict:
    s = jax.device_get(s)
    return {"rb": {"buf": s.rb.buf, "head": s.rb.head, "tail": s.rb.tail},
            "carry": s.carry, "carry_valid": s.carry_valid,
            "max_ts": s.max_ts, "metrics": s.metrics._asdict(),
            "adm": {"seen": s.adm.seen, "seen_pos": s.adm.seen_pos}}


def _assert_tree(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree(a[k], b[k], f"{path}.{k}")
    else:
        assert_bitwise(a, b, path)


def _assert_out(t_out, j_out, tag):
    j_out = jax.device_get(j_out)
    for field in JX.StepOutput._fields:
        assert_bitwise(getattr(t_out, field), getattr(j_out, field),
                       f"{tag} {field}")


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_port_equals_jax_executor_bitwise(fused):
    """(a)/(b): staged and fused ports against the JAX staged executor,
    every tick, with live carry, stragglers past the watermark and a
    two-rule conflict set at core_capacity=2; then both packages resume
    from a mid-stream state taken from the JAX side."""
    jx, tx = _pair(fused=fused)
    js, ts_ = jx.init_state(D), tx.init_state(D)
    feed = _feed()
    for i, (items, ts) in enumerate(feed[:5]):
        js, jo = jx.step(js, jnp.asarray(items), jnp.asarray(ts))
        ts_, to = tx.step(ts_, items, ts)
        _assert_out(to, jo, f"tick {i}")
    _assert_tree(convert.state_to_numpy(ts_), _jax_state(js))
    assert_bitwise(convert.histograms_to_numpy(tx._lat_hist, tx._lineage)[1],
                   jx._lineage, "lineage bank")
    m = ts_.metrics.as_dict()
    assert m["items_late"] == 2 and m["windows_escalated"] > 0
    # resume both from the JAX side's mid-stream state
    ts_ = convert.state_from_numpy(jax.device_get(js), "cpu")
    for i, (items, ts) in enumerate(feed[5:], start=5):
        js, jo = jx.step(js, jnp.asarray(items), jnp.asarray(ts))
        ts_, to = tx.step(ts_, items, ts)
        _assert_out(to, jo, f"tick {i}")
    _assert_tree(convert.state_to_numpy(ts_), _jax_state(js))


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_marked_tick_equals_jax_and_the_unmarked(fused, monkeypatch):
    """A tracer with device marks changes no bit of a tick: the marked
    port against the JAX executor every tick, as above, and its
    outputs, state and lineage bitwise the unmarked port's on the same
    clock; the ring holds a row for each replayed tick."""
    jx, tx = _pair(fused=fused)
    tr = Tracer(device_marks=True)
    tx.set_tracer(tr)
    js, ts_ = jx.init_state(D), tx.init_state(D)
    feed = _feed()
    marked = []
    for i, (items, ts) in enumerate(feed):
        js, jo = jx.step(js, jnp.asarray(items), jnp.asarray(ts))
        ts_, to = tx.step(ts_, items, ts)
        _assert_out(to, jo, f"tick {i}")
        marked.append(to)
    _assert_tree(convert.state_to_numpy(ts_), _jax_state(js))
    monkeypatch.setattr(TX, "time", _Clock())
    _, plain = _pair(fused=fused)
    ps = plain.init_state(D)
    for i, (items, ts) in enumerate(feed):
        ps, po = plain.step(ps, items, ts)
        for f in po._fields:
            assert_bitwise(getattr(marked[i], f), getattr(po, f),
                           f"tick {i} {f}")
    _assert_tree(convert.state_to_numpy(ts_), convert.state_to_numpy(ps))
    assert_bitwise(tx._lineage, plain._lineage, "lineage bank")
    assert tx.trace_count == plain.trace_count == 1
    assert tr.device_stages()["ticks"] == len(feed) - 1


def test_run_overlap_equals_direct_and_int8_completes():
    """(c): overlapped ingest staging changes timing only -- bitwise the
    direct run; int8 staging is lossy but delivers every batch."""
    feed = _feed(seed=5, steps=5, straggle_at=-1)
    runs = {}
    for overlap in (False, True):
        _, tx = _pair(overlap=overlap)
        state, outs = tx.run(tx.init_state(D), iter(feed))
        assert len(outs) == len(feed)
        runs[overlap] = (outs, state.metrics.as_dict())
    for a, b in zip(runs[False][0], runs[True][0]):
        for field in TX.StepOutput._fields:
            assert_bitwise(getattr(b, field), getattr(a, field), field)
    assert runs[True][1] == runs[False][1]
    _, tx = _pair(overlap=True, int8=True)
    state, outs = tx.run(tx.init_state(D), iter(feed))
    m = state.metrics.as_dict()
    assert len(outs) == m["steps"] == len(feed)
    assert m["items_dequeued"] == BATCH * len(feed)
    assert m["items_late"] == 0               # timestamps are never quantized
    for q, e in zip(outs, runs[False][0]):
        np.testing.assert_allclose(q.aggregates.numpy(), e.aggregates.numpy(),
                                   rtol=0.05, atol=0.05)


def test_int8_stager_is_bitwise_the_jax_stager():
    """``IngestStager(int8=True)`` quantizes on the host (per-batch
    amax/127) and dequantizes on the device; the port's delivers bitwise
    the reference's payloads, stamps and modes: six [256, 16] batches at
    scales 1e-3 to 1e3, one of them all zeros (scale 1)."""
    from repro.runtime.overlap import IngestStager as JStager
    from repro_torch.runtime.overlap import IngestStager as TStager
    rng = np.random.default_rng(11)
    feed = [((rng.standard_normal((256, 16)) * scale).astype(np.float32),
             np.arange(256, dtype=np.float32) + 256 * i, i % 3)
            for i, scale in enumerate(np.logspace(-3, 3, 6))]
    feed[2] = (np.zeros((256, 16), np.float32), *feed[2][1:])
    js, ts = JStager(int8=True), TStager(int8=True, device="cpu")
    delivered = 0
    for got_j, got_t in [*((js.stage(*b), ts.stage(*b)) for b in feed),
                         (js.flush(), ts.flush())]:
        assert (got_j is None) == (got_t is None)
        if got_j is None:
            continue
        (jx, jts, jmode), (tx, tts, tmode) = got_j, got_t
        assert_bitwise(tx, np.asarray(jx), "int8 payload")
        assert_bitwise(tts, np.asarray(jts), "stamps")
        assert tmode == jmode and tx.dtype == torch.float32
        delivered += 1
    assert delivered == len(feed)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_admission_lane_equals_jax(rng, fused):
    """(d): dedupe + contract + a replay tick + a backfill tick, against
    the JAX executor; the conservation law holds on the port."""
    admission = {"k": 128, "contract": {"require_finite": True}}
    feed = _admission_feed(rng)
    assert {m for *_, m in feed} >= {JI.MODE_REPLAY, JI.MODE_BACKFILL}
    jx, tx = _pair(fused=fused, admission=admission, capacity=256)
    js, ts_ = jx.init_state(D), tx.init_state(D)
    for i, (items, ts, mode) in enumerate(feed):
        js, jo = jx.step(js, items, ts, mode=mode)
        ts_, to = tx.step(ts_, np.array(items), np.array(ts), mode=mode)
        _assert_out(to, jo, f"tick {i}")
    _assert_tree(convert.state_to_numpy(ts_), _jax_state(js))
    m = ts_.metrics.as_dict()
    assert m["items_offered"] == (m["items_accepted"] + m["items_rejected"]
                                  + m["items_deduped"])
    assert m["items_deduped"] == BATCH and m["items_backfilled"] == BATCH
    assert m["drift_counts"] == [4, 0, 0]


def test_core_budget_changes_between_ticks():
    """(e): set_core_budget between ticks, on both packages."""
    jx, tx = _pair(core_capacity=3)
    js, ts_ = jx.init_state(D), tx.init_state(D)
    for i, (items, ts) in enumerate(_feed(seed=3, steps=7)):
        budget = (3, 1, 0, 2, 3, 1, 3)[i]
        jx.set_core_budget(budget)
        tx.set_core_budget(budget)
        js, jo = jx.step(js, jnp.asarray(items + 0.5), jnp.asarray(ts))
        ts_, to = tx.step(ts_, items + 0.5, ts)
        _assert_out(to, jo, f"tick {i}")
    assert tx.core_budget == 3
    _assert_tree(convert.state_to_numpy(ts_), _jax_state(js))
    assert ts_.metrics.as_dict()["core_overflow"] > 0


def test_lineage_with_explicit_now_equals_jax():
    """(f): ingest_and_window + lineage_update with an explicit ``now``
    (``step()`` stamps wall time, so it cannot be compared)."""
    jx, tx = _pair()
    js, ts_ = jx.init_state(D), tx.init_state(D)
    jbank = jlat.lineage_init()
    tbank = convert.histograms_from_numpy(
        np.asarray(jlat.histogram_init()), np.asarray(jbank),
        device="cpu")[1]
    for i, (items, ts) in enumerate(_feed(seed=9, steps=5)):
        now = 0.25 + 0.0137 * i
        ji = JX.ingest_and_window(jx.cfg, jx.engine, js, jnp.asarray(items),
                                  jnp.asarray(ts), now=now)
        ti = TX.ingest_and_window(tx.cfg, tx.engine, ts_,
                                  torch.from_numpy(items),
                                  torch.from_numpy(ts), now=now)
        for leaf in ("q_lat", "q_mask", "w_birth", "aggregates", "features",
                     "consequence", "emit"):
            assert_bitwise(getattr(ti, leaf), getattr(ji, leaf),
                           f"tick {i} {leaf}")
        samples = {"queueing": ("q_lat", "q_mask"),
                   "window": ("w_lat", "emit"), "e2e": ("w_lat", "emit")}
        jbank = jlat.lineage_update(jbank, {
            k: ((now - ji.w_birth) if v == "w_lat" else getattr(ji, v),
                getattr(ji, m)) for k, (v, m) in samples.items()})
        tbank = tlat.lineage_update(tbank, {
            k: ((now - ti.w_birth) if v == "w_lat" else getattr(ti, v),
                getattr(ti, m)) for k, (v, m) in samples.items()})
        js = JX.StreamState(ji.rb, ji.carry, ji.carry_valid, ji.max_ts,
                            js.metrics, ji.adm)
        ts_ = TX.StreamState(ti.rb, ti.carry, ti.carry_valid, ti.max_ts,
                             ts_.metrics, ti.adm)
    assert_bitwise(tbank, jbank, "lineage bank")
    assert tlat.lineage_percentiles(tbank) == jlat.lineage_percentiles(jbank)
    assert int(tbank[0].sum()) > 0


def test_executor_without_device_needs_cuda(monkeypatch):
    """(g): ``device=None`` means the card; without one it raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tx = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        TX.StreamExecutor(tx.cfg, tx.engine, tx.pipeline)
    with pytest.raises(RuntimeError, match="CUDA"):
        TX.StreamExecutor(tx.cfg, tx.engine, tx.pipeline, device="cuda")


def test_enabled_tracer_marks_the_tick_in_a_profile():
    """An installed tracer's spans show on a torch.profiler timeline;
    the default tracer adds none."""
    _, tx = _pair()
    state = tx.init_state(D)
    (items, ts), = _feed(steps=1)
    names = []
    for tracer in (None, Tracer()):
        if tracer is not None:
            tx.set_tracer(tracer)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            state, _ = tx.step(state, items, ts)
        names.append({e.name for e in prof.events()})
    assert not {"stream.dispatch", "obs:window"} & names[0]
    assert {"stream.prepare", "stream.dispatch", "obs:window",
            "obs:pipeline"} <= names[1]


def test_stream_config_validation():
    for kw in (dict(micro_batch=30, window=16, stride=8),
               dict(micro_batch=32, window=8, stride=16),
               dict(micro_batch=32, window=8, stride=8, capacity=16),
               dict(micro_batch=32, window=16, stride=8, ingest_int8=True)):
        with pytest.raises(ValueError):
            TX.StreamConfig(**kw)


def test_fused_requires_tabular_engine():
    cfg = TX.StreamConfig(micro_batch=32, window=16, stride=8, fused=True)
    engine = trules.RuleEngine([trules.deadline_rule("slow", 4, 100.0)])
    p = tpipe.two_tier_pipeline(lambda _, b: (b, b[:, :5]),
                                lambda _, b: (b, b[:, :5]), engine)
    with pytest.raises(ValueError, match="tabular"):
        TX.StreamExecutor(cfg, engine, p, device="cpu")
