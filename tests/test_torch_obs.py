"""The port's host-side observability and runtime modules against the
JAX package, in-process: ``runtime.straggler``, ``runtime.health``,
``obs.events``, ``obs.slo``, ``obs.trace``, ``obs.export`` and
``obs.costmodel``, and the executors' ``step_cost``.

The host modules are numpy copies of the reference, so they are held to
equal outputs on the same seeded inputs.  The cost model differs by
design (the reference reads XLA's cost analysis; the port counts the
aten operations a tick runs, and the hand kernels' reported counts), so
it is held to its own contract: a stage is attributed, the kernels'
counts are the ones ``chip_smoke.py`` bounds them with, and a
``step_cost`` consumes nothing.
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as JO
from repro.core.overlay import Overlay as JOverlay
from repro.obs import export as JOX
from repro.obs.events import ENVELOPE_FIELDS as J_ENVELOPE
from repro.runtime.health import HealthMonitor as JHealthMonitor
from repro.runtime.straggler import StragglerDetector as JStragglerDetector
from repro_torch import convert
from repro_torch import obs as TO
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rules as trules
from repro_torch.core.overlay import Overlay as TOverlay
from repro_torch.kernels import cost
from repro_torch.obs import costmodel, export
from repro_torch.obs.events import ENVELOPE_FIELDS
from repro_torch.runtime import HealthMonitor, StragglerDetector
from repro_torch.stream import StreamConfig, StreamExecutor
from repro_torch.stream.fleet import FleetConfig, FleetExecutor
from repro_torch.testing import assert_bitwise

D = 3


# -- runtime.straggler and runtime.health --------------------------------------

@pytest.mark.parametrize("kw", [
    dict(window=10, threshold=1.5, patience=3),
    dict(window=4, threshold=3.0, patience=2, floor=0.5),
    dict(window=2, threshold=3.0, patience=1),
])
def test_straggler_detector_matches_the_reference(rng, kw):
    """The same telemetry (slow ranks, zeros as missing measurements,
    a warm-up of zeros) gives the same flags, stragglers and backup
    plans tick for tick."""
    n = 8
    t_, j = StragglerDetector(n, **kw), JStragglerDetector(n, **kw)
    for step in range(30):
        st = rng.lognormal(-2.0, 0.3, n)
        if step < 3:
            st[:] = 0.0                        # warm-up: no signal
        st[5] *= 6.0 if 8 <= step < 20 else 1.0
        st[rng.random(n) < 0.1] = 0.0          # dropped reports
        assert t_.observe(st) == j.observe(st)
        assert t_.stragglers() == j.stragglers()
        for away in ([], [5], [1, 5], list(range(n))):
            assert t_.reassignment(away) == j.reassignment(away)
    with pytest.raises(ValueError, match="one measurement per rank"):
        t_.observe(np.ones(n - 1))


def test_health_monitor_matches_the_reference(rng):
    """Heartbeats, a sweep and the overlay rebuild: the same dead ranks,
    and the port's Overlay with the reference's liveness and routing."""
    sides = [(HealthMonitor(16, timeout_s=5.0), TOverlay),
             (JHealthMonitor(16, timeout_s=5.0), JOverlay)]
    now = 1000.0
    lag = rng.uniform(0.0, 10.0, 16)
    results = []
    for hm, overlay in sides:
        for r in range(16):
            hm.heartbeat(r, t=now - lag[r])
        dead = hm.sweep(now=now)
        ov = hm.apply_to_overlay(overlay.from_mesh_shape(4, 4, capacity=2))
        assert isinstance(ov, overlay)
        results.append((dead, hm.alive, ov.alive,
                        ov.routing_table(granularity=4)))
    (d1, a1, o1, r1), (d2, a2, o2, r2) = results
    assert d1 == d2 and d1 == [int(r) for r in np.nonzero(lag > 5.0)[0]]
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(o1, o2)
    np.testing.assert_array_equal(r1, r2)


# -- obs.events ----------------------------------------------------------------

def test_event_schema_equals_the_reference():
    assert TO.EVENT_KINDS == JO.EVENT_KINDS
    assert ENVELOPE_FIELDS == J_ENVELOPE


def test_event_log_round_trip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = TO.EventLog(path)
    log.emit("leave", tick=3, shard=4, cause="decommissioned", backup=6)
    log.emit("backup_assign", tick=3, shard=6, cause="replay target",
             for_shard=4)
    log.emit("join", tick=9, shard=4, cause="rejoined")
    log.close()
    recs = TO.EventLog.load(path)
    assert recs == log.records
    TO.EventLog.validate(recs)
    JO.EventLog.validate(recs)                 # the reference reads it too
    assert [r["kind"] for r in log.of_kind("leave", "join")] == [
        "leave", "join"]
    assert TO.EventLog.load(log.dump(str(tmp_path / "c.jsonl"))) == recs
    assert log.to_jsonl() == "".join(json.dumps(r) + "\n" for r in recs)


def test_event_log_refusals_match_the_reference():
    """The same bad emits and the same causality violations are refused
    by both packages, with the same messages."""
    def rec(seq, wall, tick, kind="join"):
        return {"seq": seq, "wall_time": wall, "tick": tick,
                "kind": kind, "shard": None, "cause": None}
    bad_logs = [[rec(0, 1.0, 0), rec(0, 2.0, 1)],
                [rec(0, 2.0, 0), rec(1, 1.0, 1)],
                [rec(0, 1.0, 5), rec(1, 2.0, 3)],
                [{"seq": 0, "kind": "join"}],
                [rec(0, 1.0, 0, kind="nope")]]
    for records in bad_logs:
        msgs = []
        for mod in (TO, JO):
            with pytest.raises(ValueError) as e:
                mod.EventLog.validate(records)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for mod in (TO, JO):
        log = mod.EventLog()
        with pytest.raises(ValueError, match="unknown event kind"):
            log.emit("budget_resise", tick=0)
        with pytest.raises(ValueError, match="shadow the envelope"):
            log.emit("join", tick=0, **{"seq": 7})
        assert len(log) == 0


# -- obs.slo -------------------------------------------------------------------

def _bank_with(stage, good=0, bad=0, target=1e-3):
    """Cumulative bank: ``good`` samples under target, ``bad`` over."""
    bank = np.zeros((len(TO.LINEAGE_STAGES), len(TO.DEFAULT_EDGES) + 1),
                    np.int64)
    i = TO.LINEAGE_STAGES.index(stage)
    bank[i, 0] = good
    bank[i, np.searchsorted(TO.DEFAULT_EDGES, target) + 2] = bad
    return bank


def _slo_script(rng):
    """Thirty ticks of cumulative telemetry: latency banks with good and
    bad samples in bursts, ticks with no new samples, and drop
    counters."""
    bank = np.zeros_like(_bank_with("e2e"))
    dropped = emitted = 0
    for t in range(30):
        burst = 10 <= t < 16
        if t % 7 != 3:                         # some ticks bring no data
            bank = bank + _bank_with("e2e", 100, 60 if burst else 2)
            bank = bank + _bank_with("queueing", 50, 40 if t > 20 else 0)
        new = int(rng.integers(50, 100))
        emitted += new
        dropped += new if 5 <= t < 9 else 0
        yield bank, (dropped, emitted)


def test_slo_evaluator_matches_the_reference(rng):
    """Latency and drop SLOs over the same telemetry: every status (burn
    rates, level, transitions) equal tick for tick."""
    def slos(mod):
        return [mod.SLO("lat", target_seconds=1e-3, stage="e2e",
                        objective=0.9, fast_window=2, slow_window=3,
                        burn_threshold=2.0),
                mod.SLO("queue", target_seconds=float(
                    TO.DEFAULT_EDGES[40] * 1.01), stage="queueing",
                    objective=0.8, fast_window=1, slow_window=4),
                mod.SLO("drops", stage="drops", objective=0.5,
                        fast_window=1, slow_window=2, burn_threshold=1.5)]
    t_ev, j_ev = TO.SloEvaluator(slos(TO)), JO.SloEvaluator(slos(JO))
    edges = 0
    for bank, drops in _slo_script(rng):
        got = t_ev.observe(bank=bank, drops=drops)
        want = j_ev.observe(bank=bank, drops=drops)
        assert [tuple(s)[1:] for s in got] == [tuple(s)[1:] for s in want]
        assert t_ev.breaching == j_ev.breaching
        edges += sum(s.breached or s.recovered for s in got)
    assert edges == 5
    for bad in (dict(stage="nope", target_seconds=1.0),
                dict(target_seconds=1.0, objective=1.0),
                dict(stage="e2e"),
                dict(target_seconds=1.0, fast_window=9, slow_window=3),
                dict(target_seconds=1.0, burn_threshold=0.0)):
        for mod in (TO, JO):
            with pytest.raises(ValueError):
                mod.SLO("x", **bad)


# -- obs.trace -----------------------------------------------------------------

def test_tracer_spans_percentiles_and_chrome_trace(tmp_path):
    tr = TO.Tracer()
    with tr.span("outer", tick=np.int64(1)):
        assert tr.open_stage() is None
        with tr.span("obs:inner"):
            assert tr.open_stage() == "obs:inner"
    assert tr.open_stage() is None
    with tr.span("obs:inner"):
        pass
    sp = tr.stage_percentiles()
    assert set(sp) == {"outer", "obs:inner"}
    assert sp["obs:inner"]["count"] == 2
    assert set(sp["outer"]) == {"count", "mean_us", "total_us", "p50_us",
                                "p95_us", "p99_us"}
    assert sp["outer"]["p50_us"] >= sp["obs:inner"]["p50_us"] > 0
    doc = tr.to_chrome_trace()
    assert {e["name"] for e in doc["traceEvents"]} == {"outer", "obs:inner"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])
    outer = next(e for e in doc["traceEvents"] if e["name"] == "outer")
    assert outer["args"] == {"tick": 1}
    path = tr.export_chrome_trace(str(tmp_path / "trace.json"))
    assert json.load(open(path)) == json.loads(json.dumps(doc))
    name, t0, t1, tid, args = tr.spans[0]
    assert name == "obs:inner" and t1 >= t0 and args == {}
    tr.clear()
    assert tr.stage_percentiles() == {} and tr.spans == []


def test_null_tracer_records_nothing():
    with TO.NULL_TRACER.span("obs:x"):
        assert TO.NULL_TRACER.open_stage() is None
    with TO.NULL_TRACER.step_annotation("x", 1):
        pass
    assert TO.NULL_TRACER.spans == [] and not TO.NULL_TRACER.enabled
    assert TO.NULL_TRACER.span("a") is TO.NULL_TRACER.span("b")
    assert TO.NULL_TRACER.profile("unused") is TO.NULL_TRACER.span("c")
    assert TO.DEVICE_STAGES == JO.DEVICE_STAGES


def test_profile_captures_host_spans(tmp_path):
    """``profile(logdir)`` is a ``torch.profiler`` capture that writes a
    Chrome trace into ``logdir`` holding the tracer's ranges."""
    tr = TO.Tracer()
    with tr.profile(str(tmp_path / "prof")):
        with tr.span("obs:mix"):
            torch.ones(8).sum()
    files = list((tmp_path / "prof").iterdir())
    assert len(files) == 1
    assert "obs:mix" in files[0].read_text()


# -- obs.export ----------------------------------------------------------------

def _stream_executor():
    engine = trules.RuleEngine([
        trules.threshold_rule("hot", 0, ">=", 0.5, trules.C_SEND_CORE)])
    edge_fn = lambda p, b: (b, b[:, :5])  # noqa: E731
    scfg = StreamConfig(micro_batch=32, window=16, stride=16, capacity=128)
    ex = StreamExecutor(scfg, engine,
                        tpipe.two_tier_pipeline(edge_fn, edge_fn, engine),
                        device="cpu")
    return ex, ex.init_state(D)


def test_bench_payload_and_snapshot_keys_are_the_reference(tmp_path, rng):
    rows = [{"name": "suite/a", "us_per_call": 12.5,
             "derived": "items_per_s=100;traces=1;note=ok;flag"}]
    payload = TO.bench_payload("demo", rows, device="cpu")
    assert tuple(payload) == export.BENCH_KEYS == JOX.BENCH_KEYS
    assert payload["platform"]["backend"] == "cpu"
    assert payload["platform"]["torch"] == torch.__version__
    assert payload["rows"][0]["derived"] == {
        "items_per_s": 100, "traces": 1, "note": "ok", "flag": True}
    assert payload["rows"] == JO.bench_payload("demo", rows)["rows"]
    path = TO.write_bench(payload, str(tmp_path))
    assert json.load(open(path)) == json.loads(json.dumps(payload))
    assert not list(tmp_path.glob("*.tmp"))
    for s in ("", "a=1;b=2.5;c=x;d", "r=2..64"):
        assert TO.parse_derived(s) == JO.parse_derived(s)

    import jax.numpy as jnp
    from repro.core import pipeline as jpipe
    from repro.core import rules as jrules
    from repro.stream import executor as JX
    ex, state = _stream_executor()
    engine = jrules.RuleEngine([
        jrules.threshold_rule("hot", 0, ">=", 0.5, jrules.C_SEND_CORE)])
    edge_fn = lambda p, b: (b, b[:, :5])  # noqa: E731
    jx = JX.StreamExecutor(
        JX.StreamConfig(micro_batch=32, window=16, stride=16, capacity=128),
        engine, jpipe.two_tier_pipeline(edge_fn, edge_fn, engine))
    js = jx.init_state(D)
    tr = TO.Tracer()
    ex.set_tracer(tr)
    for i in range(3):
        items = rng.standard_normal((32, D)).astype(np.float32)
        ts = i * 32 + np.arange(32.0)
        state, _ = ex.step(state, items, ts)
        js, _ = jx.step(js, jnp.asarray(items), jnp.asarray(ts, jnp.float32))
    snap = TO.metrics_snapshot(ex, state)
    assert tuple(snap) == export.SNAPSHOT_KEYS == JOX.SNAPSHOT_KEYS
    # the tick built once, as the reference traced once on the same feed
    assert snap["kind"] == "StreamExecutor"
    assert snap["trace_count"] == 1 == JO.metrics_snapshot(
        jx, js)["trace_count"]
    assert isinstance(snap["trace_count"], int)
    assert snap["metrics"]["steps"] == 3
    assert snap["stages"]["stream.dispatch"]["count"] == 3
    json.dumps(snap)


# -- obs.costmodel -------------------------------------------------------------

def test_roofline_and_stage_table_are_the_reference(monkeypatch):
    monkeypatch.delenv("REPRO_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("REPRO_PEAK_BW", raising=False)
    for args in ((2e9, 1e9, 1.0), (0.0, 0.0, 0.0), (3.5e12, 7e10, 2e-3)):
        assert TO.roofline(*args) == JO.roofline(*args)
        assert TO.roofline(*args, peak_flops=4e9, peak_bw=8e9) == \
            JO.roofline(*args, peak_flops=4e9, peak_bw=8e9)
    monkeypatch.setenv("REPRO_PEAK_FLOPS", "4e9")
    monkeypatch.setenv("REPRO_PEAK_BW", "8e9")
    assert TO.roofline(2e9, 1e9, 1.0) == JO.roofline(2e9, 1e9, 1.0)
    a = {"stages": {"obs:a": {"ops": 3, "bytes": 10},
                    "obs:b": {"ops": 1, "bytes": 99}}}
    assert TO.stage_table(a) == JO.stage_table(a) == [
        ("obs:b", 1, 99), ("obs:a", 3, 10)]


def test_analyze_attributes_stages():
    """The reference's ``obs:mix`` example: the matmul's FLOPs, the tanh
    as transcendentals, each span's operations on its stage."""
    tr = TO.Tracer()

    def f(x, w):
        with tr.span("obs:mix"):
            y = torch.tanh(x @ w)
        with tr.span("obs:reduce"):
            return y.sum(dim=0)
    x, w = torch.ones(32, 16), torch.ones(16, 16)
    c = TO.analyze(f, x, w, tracer=tr)
    assert c["flops"] == 2 * 32 * 16 * 16 + 32 * 16     # mm + the sum
    assert c["transcendentals"] == 32 * 16
    assert c["stages"]["obs:mix"]["ops"] == 2
    # mm reads x, w and writes y; tanh reads y and writes y
    assert c["stages"]["obs:mix"]["bytes"] == 4 * (512 + 256 + 512 + 1024)
    assert c["stages"]["obs:reduce"] == {"ops": 1, "bytes": 4 * (512 + 16)}
    assert c["bytes_accessed"] == 4 * (2304 + 528)
    assert c["kernels"] == {} and costmodel.active() is None
    with pytest.raises(RuntimeError, match="nest"):
        TO.analyze(lambda: TO.analyze(f, x, w), tracer=tr)


def test_analyze_counts_gathers_and_in_place_writes():
    """A gather from a large tensor reads what it gathers, and an
    in-place scatter into it writes what it is given."""
    big = torch.zeros(1 << 16, 4)
    idx = torch.arange(8)
    c = TO.analyze(lambda: big[idx])
    assert c["bytes_accessed"] == 8 * 8 + 2 * 8 * 4 * 4
    c = TO.analyze(lambda: big.index_put_((idx,), torch.ones(8, 4)))
    assert c["bytes_accessed"] <= 2 * (8 * 8 + 8 * 4 * 4) + 8 * 4 * 4


def test_kernel_wrappers_report_the_bound_counts():
    """Each wrapper reports its function's counts (the numbers
    ``chip_smoke.py`` bounds the kernel with) and its plain version's
    own operations are not counted."""
    from repro_torch.core import profiles as P
    from repro_torch.kernels.armatch import armatch
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.fused_tick import fused_tick
    from repro_torch.kernels.hilbert import hilbert_xy2d
    from repro_torch.kernels.window_reduce.ops import sliding_reduce
    from repro_torch.kernels.checks import random_profiles
    t, w, s = 96, 16, 8
    nw = (t - w) // s + 1
    seq = torch.randn(t, 2 + D)
    valid = torch.ones(t, dtype=torch.bool)
    table = ((0, ">=", 0.5, trules.C_SEND_CORE),)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(random_profiles(rng, 5))
    ints = torch.from_numpy(random_profiles(rng, 3))
    q = torch.randn(2, 4, 16)
    kc, vc = torch.randn(2, 10, 2, 16), torch.randn(2, 10, 2, 16)
    lengths = torch.tensor([10, 3], dtype=torch.int32)
    xy = torch.arange(40, dtype=torch.int32)
    calls = {
        "fused_tick": (lambda: fused_tick(seq, valid, w, s, table=table),
                       cost.fused_tick(t, 1 + D, D, nw, w)),
        "window_reduce": (lambda: sliding_reduce(seq[:, 2:], w, s, nw,
                                                 "max"),
                          cost.window_reduce(D, w, s, nw)),
        "armatch": (lambda: armatch(data, ints), cost.armatch(data, ints)),
        "decode_attn": (lambda: decode_attention(q, kc, vc, lengths,
                                                 num_kv_heads=2),
                        cost.decode_attn(2, 4, 2, 16, 10, 4)),
        "hilbert": (lambda: hilbert_xy2d(xy, xy, 16), cost.hilbert(40, 16)),
    }
    for name, (fn, (nbytes, ops)) in calls.items():
        c = TO.analyze(fn)
        assert c["kernels"] == {name: {"calls": 1, "bytes": nbytes,
                                       "ops": ops}}, name
        assert c["bytes_accessed"] == nbytes and c["flops"] == ops, name
        assert nbytes > 0 and ops > 0
    assert cost.armatch_ops(data, ints) > 5 * 3
    assert P.PROFILE_WIDTH == 128


def _fleet(fused):
    engine = trules.RuleEngine([
        trules.threshold_rule("hot", 0, ">=", 0.5, trules.C_SEND_CORE,
                              priority=1),
        trules.threshold_rule("sparse", 4, "<", 8.0, trules.C_STORE_EDGE)])
    ex = FleetExecutor(
        FleetConfig(stream=StreamConfig(micro_batch=32, window=16, stride=8,
                                        capacity=128, fused=fused),
                    num_shards=4, num_regions=2, num_core=2, core_budget=6,
                    fog_budget=4),
        engine, tpipe.two_tier_pipeline(lambda p, b: (b * 1.5, b[:, :5]),
                                        lambda p, b: (torch.tanh(b),
                                                      b[:, :5]), engine),
        device="cpu")
    return ex, ex.init_state(D)


def _feed(rng, s, t):
    items = rng.standard_normal((s, 32, D)).astype(np.float32)
    return items, np.tile(t * 32 + np.arange(32, dtype=np.float32), (s, 1))


class _Clock:
    """Stands in for the fleet executor module's ``time``: every
    ``perf_counter()`` advances a quarter second, so two runs stamp the
    same wall times."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize("fused", [False, True])
def test_fleet_step_cost_consumes_nothing(monkeypatch, fused):
    """``step_cost`` between two ticks leaves the next tick bitwise what
    it is without it: the state, the outputs, the latency histogram and
    the lineage banks; the fused tick's kernel reports one call a shard,
    the staged tick's five."""
    from repro_torch.stream.fleet import executor as TFX
    runs = []
    for with_cost in (False, True):
        monkeypatch.setattr(TFX, "time", _Clock())
        r = np.random.default_rng(11)
        ex, st = _fleet(fused)
        st, _ = ex.step(st, *_feed(r, 4, 0))
        if with_cost:
            before = (ex.last_step_seconds, ex._skip_feed,
                      ex._lat_hist.clone(), ex._lineage.clone())
            c = ex.step_cost(st, *_feed(np.random.default_rng(3), 4, 1))
            assert ex.last_step_seconds == before[0]
            assert ex._skip_feed == before[1] and ex.tracer is TO.NULL_TRACER
            assert_bitwise(ex._lat_hist, before[2], "histogram")
            assert_bitwise(ex._lineage, before[3], "lineage")
            name = "fused_tick" if fused else "window_reduce"
            assert c["kernels"][name]["calls"] == 4 * (1 if fused else 5)
            assert c["kernels"][name]["bytes"] > 0
            assert c["transcendentals"] > 0 and c["flops"] > 0
            assert {"obs:exchange_core", "obs:ingest",
                    "obs:lineage"} <= set(c["stages"])
            assert ("obs:fused_tick" if fused else "obs:window") \
                in c["stages"]
        st, out = ex.step(st, *_feed(r, 4, 1))
        runs.append((st, out, ex._lat_hist, ex._lineage))
    (s1, o1, h1, l1), (s2, o2, h2, l2) = runs
    for f in o1._fields:
        assert_bitwise(getattr(o2, f), getattr(o1, f), f)
    assert s1.metrics.as_dict() == s2.metrics.as_dict()
    want, got = (_leaves(convert.fleet_state_to_numpy(x)) for x in (s1, s2))
    assert want.keys() == got.keys() and len(want) > 20
    for k in want:
        assert_bitwise(got[k], want[k], k)
    assert_bitwise(h2, h1, "latency histogram")
    assert_bitwise(l2, l1, "lineage banks")


def _leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _leaves(sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def test_stream_step_cost_consumes_nothing(rng):
    ex, state = _stream_executor()
    items = rng.standard_normal((32, D)).astype(np.float32)
    ts = np.arange(32, dtype=np.float32)
    twin, twin_state = _stream_executor()
    c = ex.step_cost(state, items, ts)
    assert c["flops"] > 0 and c["kernels"]["window_reduce"]["calls"] == 5
    assert {"obs:window", "obs:pipeline"} <= set(c["stages"])
    state, out = ex.step(state, items, ts)
    twin_state, twin_out = twin.step(twin_state, items, ts)
    for f in out._fields:
        assert_bitwise(getattr(out, f), getattr(twin_out, f), f)
    assert state.metrics.as_dict() == twin_state.metrics.as_dict()
    assert int(state.metrics.steps) == 1
