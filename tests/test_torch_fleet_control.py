"""The port's fleet control plane (``repro_torch.stream.fleet.control``,
on the CPU) against the JAX ``FleetController``, arc by arc.

As in ``test_torch_fleet.py``, one module-scoped subprocess runs every
arc of :data:`_ARCS` through the JAX package on 8 forced host devices
and writes each tick's record to an ``.npz``; the port then runs the
same arcs in-process.  Both sides execute the same ``_ARCS`` source,
seeded numpy inputs included, and both fleet executor modules' clocks
are the same fake (the ring's wall-time stamps and the lineage banks
agree).  Per-shard step times come from ``FaultSchedule.stall_time`` (or
are constant), never from the wall clock.

The arcs are the reference's own: a stall with catch-up and re-admission
(``tests/test_fleet_faults.py``), tumbling churn with backup replay and
sliding churn with the carry handoff (``tests/test_fleet_churn.py``),
the elastic core and fog budgets growing past their slot ceilings and
shrinking, a controller remesh (shrink, then grow) with the injector
translated through it, and the SLO lane (``tests/test_lineage.py``): a
latency and a drop SLO breaching and recovering, with contract rejects
and drift in the event log.

Held per tick: every ``ControlDecision`` field and every ``FleetState``
leaf bitwise, ``metrics.as_dict()`` equal, core outputs within 1e-6; at
the end the event log less its ``wall_time`` stamps, ``resizes``,
``_retraces``, ``max_trace_count`` and the lineage banks.  The port's
executor's own ``trace_count`` is held to ``max_trace_count`` (the JAX
executor's is not compared: under this jax its subprocess fleet counts
a second trace the reference's tests do not expect).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rules as trules
from repro_torch.obs import SLO, EventLog
from repro_torch.runtime import ElasticBudget, StragglerDetector
from repro_torch.stream import AdmissionPlan, DataContract, StreamConfig
from repro_torch.stream.fleet import (Churn, Fault, FaultInjector,
                                      FaultSchedule, FleetConfig,
                                      FleetController, FleetExecutor)
from repro_torch.stream.fleet import executor as TFX
from repro_torch.testing import assert_bitwise

SRC = Path(__file__).resolve().parents[1] / "src"

#: the arcs, as plain numpy and Python against an ``api`` namespace (one
#: package's classes and calls): executed on both sides
_ARCS = textwrap.dedent("""
    import json

    import numpy as np

    D, BATCH = 3, 32
    HOT = [("hot", 0, ">=", 1.0, "C_SEND_CORE", 2)]
    TIERS = {
        "scale": (lambda p, b: (b * 1.5, b[:, :5]),
                  lambda p, b: (b + 100.0, b[:, :5])),
        "same": (lambda p, b: (b, b[:, :5]), lambda p, b: (b, b[:, :5])),
    }
    TUMBLING = dict(micro_batch=BATCH, window=16, stride=16,
                    capacity=4 * BATCH, lateness=4.0)
    SLIDING = dict(micro_batch=BATCH, window=16, stride=8,
                   capacity=4 * BATCH, lateness=16.0)


    def plain(v):
        # a decision field or event payload as JSON-able Python
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if isinstance(v, dict):
            return {str(k): plain(x) for k, x in v.items()}
        return v


    def flatten(tree, prefix=""):
        # a nested NamedTuple or dict of arrays -> {"a.b.c": array}
        if isinstance(tree, dict):
            items = tree.items()
        elif hasattr(tree, "_fields"):
            items = zip(tree._fields, tree)
        else:
            return {prefix[:-1]: np.asarray(tree)}
        out = {}
        for k, v in items:
            out.update(flatten(v, f"{prefix}{k}."))
        return out


    class Clock:
        # stands in for an executor module's ``time``: every
        # perf_counter() call advances a quarter second
        def __init__(self):
            self.t = 100.0

        def perf_counter(self):
            self.t += 0.25
            return self.t


    class Recorder:
        def __init__(self, api, rec, tag):
            self.api, self.rec, self.tag = api, rec, tag

        def tick(self, i, st, out, dec):
            rec, tag = self.rec, self.tag
            for k, v in self.api.out(out).items():
                rec[f"{tag}/out{i}/{k}"] = v
            for k, v in self.api.state(st).items():
                rec[f"{tag}/state{i}/{k}"] = v
            rec[f"{tag}/metrics{i}"] = np.asarray(
                json.dumps(st.metrics.as_dict()))
            rec[f"{tag}/decision{i}"] = np.asarray(
                json.dumps(plain(dec._asdict())))

        def finish(self, ctl, ex, log):
            rec, tag = self.rec, self.tag
            events = [{k: v for k, v in r.items() if k != "wall_time"}
                      for r in log.records]
            rec[f"{tag}/events"] = np.asarray(json.dumps(plain(events)))
            rec[f"{tag}/counts"] = np.asarray(
                [ctl.resizes, ctl._retraces, ctl.max_trace_count])
            rec[f"{tag}/lineage"] = ex.lineage_counts()


    def zeros(e, n=BATCH):
        return (np.zeros((e, n, D), np.float32),
                np.zeros((e, n), np.float32))


    def feed_tick(rng, e, t, n=BATCH):
        items = rng.standard_normal((e, n, D)).astype(np.float32)
        items[:, :, 0] += (t % 3 == 0) * 1.5     # periodic hot regime
        ts = np.tile(t * n + np.arange(n, dtype=np.float32), (e, 1))
        return items, ts


    def arc_stall(api, rec):
        # tests/test_fleet_faults.py: shard 3 stalls for ticks 4..7; the
        # wall-time detector flags it, it catches up excluded, then is
        # re-admitted; drain ticks flush the backlog
        e, t_end = 8, 14
        ex = api.make(TUMBLING, dict(num_shards=e, num_core=2,
                                     core_budget=64), HOT)
        log = api.EventLog()
        ctl = api.FleetController(
            ex, budget_policy=api.ElasticBudget(min_budget=64,
                                                max_budget=64),
            wall_detector=api.StragglerDetector(e, window=2, threshold=3.0,
                                                patience=1),
            event_log=log)
        sched = api.FaultSchedule([api.Fault(shard=3, start=4, end=8)])
        inj = api.FaultInjector(sched, event_log=log)
        rng = np.random.default_rng(0)
        stream = [feed_tick(rng, e, t) for t in range(t_end)]
        st = ex.init_state(D)
        r = Recorder(api, rec, "stall")
        for t in range(t_end + 4 + 3):
            drain = t >= t_end
            base = zeros(e) if drain else stream[t]
            items, ts, offered, _ = inj.inject(t, *base, fresh=not drain)
            st, out = api.step(ex, st, items, ts, offered=offered)
            r.tick(t, st, out, ctl.tick(st, step_times=sched.stall_time(t, e)))
        assert inj.pending == 0
        r.finish(ctl, ex, log)


    def churn_arc(api, rec, tag, stream_kw, regions, shard, handoff):
        # tests/test_fleet_churn.py: ``shard`` leaves at tick 4 (its
        # batches replay on the backup leave() picks), a joiner takes
        # the slot back at tick 9; with ``handoff`` the departed
        # stream's window carry moves onto the backup and back
        e, t_end, leave, join = 8, 14, 4, 9
        ex = api.make(stream_kw, dict(num_shards=e, num_core=2,
                                      core_budget=64,
                                      num_regions=regions), HOT)
        log = api.EventLog()
        ctl = api.FleetController(
            ex, budget_policy=api.ElasticBudget(min_budget=64,
                                                max_budget=64),
            event_log=log)
        sched = api.FaultSchedule(churn=[api.Churn(shard=shard,
                                                   leave=leave, join=join)])
        inj = api.FaultInjector(sched, event_log=log)
        rng = np.random.default_rng(1)
        stream = [feed_tick(rng, e, t) for t in range(t_end)]
        st = ex.init_state(D)
        r = Recorder(api, rec, tag)
        backups, t = {}, 0
        while t < t_end or inj.pending or t < t_end + 4:
            if t == leave:
                backup = ctl.leave(shard)
                backups = {shard: backup}
                if handoff:
                    st = ctl.begin_replay_carry(st, shard, backup)
            if t == join:
                if handoff:
                    st = ctl.end_replay_carry(st, shard, backup)
                ctl.join(shard)
            drain = t >= t_end
            base = zeros(e) if drain else stream[t]
            items, ts, offered, replay = inj.inject(
                t, *base, fresh=not drain, backups=backups)
            st, out = api.step(ex, st, items, ts, offered=offered,
                               replay=replay)
            rec[f"{tag}/origin{t}"] = inj.origin.copy()
            r.tick(t, st, out, ctl.tick(st, step_times=sched.stall_time(t, e)))
            t += 1
        r.finish(ctl, ex, log)


    def arc_elastic(api, rec):
        # tests/test_fleet_faults.py's elastic loop on 2 regions: pressure
        # grows the core budget past its slot ceiling and each region's
        # fog budget past its own, idle ticks shrink both
        e = 8
        ex = api.make(dict(micro_batch=64, window=16, stride=16,
                           capacity=256, lateness=4.0),
                      dict(num_shards=e, num_regions=2, num_core=2,
                           core_budget=4, core_budget_max=8, fog_budget=4,
                           fog_budget_max=8), HOT)
        log = api.EventLog()
        ctl = api.FleetController(
            ex, budget_policy=api.ElasticBudget(min_budget=2, max_budget=32,
                                                patience=1),
            event_log=log)
        rng = np.random.default_rng(2)
        st = ex.init_state(D)
        r = Recorder(api, rec, "elastic")
        for t in range(10):
            items = rng.standard_normal((e, 64, D)).astype(np.float32)
            items[:, :, 0] += 2.0 if t < 5 else -2.0
            ts = np.tile(t * 64 + np.arange(64, dtype=np.float32), (e, 1))
            st, out = api.step(ex, st, items, ts)
            r.tick(t, st, out, ctl.tick(st, step_times=np.full(e, 0.1)))
        r.finish(ctl, ex, log)


    def arc_remesh(api, rec):
        # tests/test_fleet_churn.py's controller remesh on a stalled
        # fleet: 40 rows offered a tick against 32 dequeued (the rings
        # back up), shard 3 stalled for ticks 1..3; at tick 4 shard 1
        # dies (4 -> 3 shards: its unconsumed rows re-queue on its fold
        # target, the injector translates), at tick 7 a joiner arrives
        # (3 -> 4), then drain ticks
        e, n = 4, 40
        ex = api.make(TUMBLING, dict(num_shards=e, num_core=2,
                                     core_budget=64), HOT)
        log = api.EventLog()
        ctl = api.FleetController(
            ex, budget_policy=api.ElasticBudget(min_budget=64,
                                                max_budget=64),
            event_log=log)
        sched = api.FaultSchedule([api.Fault(shard=3, start=1, end=4)])
        inj = api.FaultInjector(sched, event_log=log)
        rng = np.random.default_rng(3)
        st = ex.init_state(D)
        r = Recorder(api, rec, "remesh")
        t = 0
        while t < 10 or inj.pending:
            for at, width, keep in ((4, 3, [0, 2, 3]),
                                    (7, 4, [0, 1, 2, None])):
                if t == at:
                    st, payload = api.remesh(ctl, st, width, keep=keep)
                    fold = log.of_kind("remesh")[-1]["fold"]
                    inj.translate(keep, t)
                    for k, rows in sorted(payload.items()):
                        rec[f"remesh/payload{t}/{k}"] = np.asarray(rows)
                        inj.requeue(keep.index(fold[str(k)]),
                                    np.asarray(rows), n)
                    e = width
            drain = t >= 10
            base = zeros(e, n) if drain else feed_tick(rng, e, t, n)
            items, ts, offered, _ = inj.inject(t, *base, fresh=not drain)
            st, out = api.step(ex, st, items, ts, offered=offered)
            r.tick(t, st, out, ctl.tick(st, step_times=sched.stall_time(t, e)))
            t += 1
        r.finish(ctl, ex, log)


    def arc_slo(api, rec):
        # tests/test_lineage.py's SLO arc: shard 2's uplink stalls, then
        # bursts (ring residency: queueing latency breaches the latency
        # SLO, then recovers); ticks 8..11 run cold enough for a drop
        # rule to drop most windows (the drop SLO breaches, recovers);
        # contract violations on shard 6 land as ingest_reject and
        # drift_detected events
        e, deq, n, stalled = 8, 32, 64, 2
        contract = api.DataContract(lo=(-50.0,) * D, hi=(50.0,) * D)
        ex = api.make(dict(micro_batch=deq, window=16, stride=16,
                           capacity=256, lateness=1e9,
                           admission=api.AdmissionPlan(contract=contract)),
                      dict(num_shards=e, num_core=2, core_budget=16,
                           num_regions=2, fog_budget=8),
                      [("hot", 0, ">=", 0.5, "C_SEND_CORE", 2),
                       ("calm", 0, "<", -0.5, "C_DROP", 1)], tiers="same")
        log = api.EventLog()
        slos = (api.SLO("queueing-100us", target_seconds=1e-4,
                        stage="queueing", objective=0.95, fast_window=2,
                        slow_window=4, burn_threshold=2.0),
                api.SLO("drops", stage="drops", objective=0.9,
                        fast_window=2, slow_window=4, burn_threshold=2.0))
        ctl = api.FleetController(
            ex, budget_policy=api.ElasticBudget(min_budget=16,
                                                max_budget=16),
            region_policies=[api.ElasticBudget(min_budget=8, max_budget=8)
                             for _ in range(2)],
            event_log=log, slos=slos)

        def offered_rows(t):
            if 4 <= t < 6:
                return 0                  # stalled uplink
            if 6 <= t < 10:
                return n                  # catch-up burst
            if 10 <= t < 14:
                return 0                  # drain the backlog
            return deq

        rng = np.random.default_rng(4)
        st = ex.init_state(D)
        r = Recorder(api, rec, "slo")
        for t in range(20):
            items = rng.standard_normal((e, n, D)).astype(np.float32)
            if 8 <= t < 12:
                items[:, :, 0] -= 1.0     # cold: the drop rule fires
            if t in (3, 15):
                items[6, :4, 1] = 1e3     # contract violations
            ts = np.tile(t * n + np.arange(n, dtype=np.float32), (e, 1))
            offered = np.zeros((e, n), bool)
            offered[:, :deq] = True
            offered[stalled] = np.arange(n) < offered_rows(t)
            st, out = api.step(ex, st, items, ts, offered=offered)
            r.tick(t, st, out, ctl.tick(st, step_times=np.full(e, 0.1)))
        r.finish(ctl, ex, log)


    ARCS = {
        "stall": arc_stall,
        "churn": lambda api, rec: churn_arc(api, rec, "churn", TUMBLING, 1,
                                            3, False),
        "sliding": lambda api, rec: churn_arc(api, rec, "sliding", SLIDING,
                                              2, 5, True),
        "elastic": arc_elastic,
        "remesh": arc_remesh,
        "slo": arc_slo,
    }
""")

_SCRIPT = textwrap.dedent("""
    import os, sys
    from types import SimpleNamespace
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax, jax.numpy as jnp
    jax.config.update("jax_threefry_partitionable", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.core import pipeline as pipe
    from repro.core import rules
    from repro.obs import SLO, EventLog
    from repro.runtime.elastic import ElasticBudget
    from repro.runtime.straggler import StragglerDetector
    from repro.stream import AdmissionPlan, DataContract, StreamConfig
    from repro.stream.fleet import (Churn, Fault, FaultInjector,
                                    FaultSchedule, FleetConfig,
                                    FleetController, FleetExecutor)
    from repro.stream.fleet import executor as FX

    exec(open(sys.argv[1]).read())
    FX.time = Clock()


    def make(stream, fleet, spec, tiers="scale"):
        engine = rules.RuleEngine([
            rules.threshold_rule(n, f, op, v, getattr(rules, c), priority=p)
            for n, f, op, v, c, p in spec])
        edge, core = TIERS[tiers]
        return FleetExecutor(
            FleetConfig(stream=StreamConfig(**stream), **fleet), engine,
            pipe.two_tier_pipeline(edge, core, engine))


    api = SimpleNamespace(
        FleetController=FleetController, ElasticBudget=ElasticBudget,
        StragglerDetector=StragglerDetector, EventLog=EventLog, SLO=SLO,
        Fault=Fault, Churn=Churn, FaultSchedule=FaultSchedule,
        FaultInjector=FaultInjector, AdmissionPlan=AdmissionPlan,
        DataContract=DataContract, make=make,
        step=lambda ex, st, items, ts, **kw: ex.step(
            st, jnp.asarray(items), jnp.asarray(ts),
            **{k: jnp.asarray(v) for k, v in kw.items()}),
        remesh=lambda ctl, st, n, **kw: ctl.remesh(st, jax.devices()[:n],
                                                   **kw),
        out=lambda out: flatten(jax.device_get(out)),
        state=lambda st: flatten(jax.device_get(st)))

    rec = {}
    for name, arc in ARCS.items():
        arc(api, rec)
        print("ARC_OK", name, flush=True)
    np.savez(sys.argv[2], **rec)
""")

#: the arcs' source, run on this side too
_NS: dict = {}
exec(_ARCS, _NS)


def _make(stream, fleet, spec, tiers="scale"):
    engine = trules.RuleEngine([
        trules.threshold_rule(n, f, op, v, getattr(trules, c), priority=p)
        for n, f, op, v, c, p in spec])
    edge, core = _NS["TIERS"][tiers]
    return FleetExecutor(
        FleetConfig(stream=StreamConfig(**stream), **fleet), engine,
        tpipe.two_tier_pipeline(edge, core, engine), device="cpu")


#: the port's executors and controllers of the arc being run: each
#: executor's ``trace_count`` is held to its controller's bound
_BUILT: list = []


def _make_kept(stream, fleet, spec, tiers="scale"):
    ex = _make(stream, fleet, spec, tiers)
    _BUILT.append(ex)
    return ex


class _Controller(FleetController):
    def __post_init__(self):
        super().__post_init__()
        _BUILT.append(self)


#: the port's side of the arcs, on the CPU
PORT = type("Port", (), dict(
    FleetController=_Controller, ElasticBudget=ElasticBudget,
    StragglerDetector=StragglerDetector, EventLog=EventLog, SLO=SLO,
    Fault=Fault, Churn=Churn, FaultSchedule=FaultSchedule,
    FaultInjector=FaultInjector, AdmissionPlan=AdmissionPlan,
    DataContract=DataContract, make=staticmethod(_make_kept),
    step=staticmethod(lambda ex, st, items, ts, **kw:
                      ex.step(st, items, ts, **kw)),
    remesh=staticmethod(lambda ctl, st, n, **kw: ctl.remesh(st, n, **kw)),
    out=staticmethod(lambda out: {k: v.numpy()
                                  for k, v in out._asdict().items()}),
    state=staticmethod(lambda st: _NS["flatten"](
        convert.fleet_state_to_numpy(st)))))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every arc through the JAX controller on 8 forced host devices, in
    one subprocess: ``{key: array}`` of its record."""
    tmp = tmp_path_factory.mktemp("jax_control")
    (tmp / "arcs.py").write_text(_ARCS)
    (tmp / "run.py").write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, str(tmp / "run.py"),
                        str(tmp / "arcs.py"), str(tmp / "ref.npz")],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def clock(monkeypatch):
    c = _NS["Clock"]()
    monkeypatch.setattr(TFX, "time", c)
    return c


def _json(a) -> object:
    return json.loads(str(a))


@pytest.mark.parametrize("arc", list(_NS["ARCS"]))
def test_control_arc_matches_the_jax_controller(ref, clock, arc):
    got = {}
    _BUILT.clear()
    _NS["ARCS"][arc](PORT, got)
    ex, ctl = (next(x for x in _BUILT if isinstance(x, cls))
               for cls in (FleetExecutor, FleetController))
    assert 1 <= ex.trace_count <= ctl.max_trace_count, \
        (ex.trace_count, ctl.max_trace_count)
    keys = sorted(k for k in ref if k.startswith(arc + "/"))
    assert keys and keys == sorted(k for k in got
                                   if k.startswith(arc + "/"))
    for k in keys:
        if k.endswith("/outputs"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        elif k.split("/")[-1].startswith(("metrics", "decision", "events")):
            assert _json(got[k]) == _json(ref[k]), k
        else:
            assert_bitwise(got[k], ref[k], k)


def _decisions(ref, arc):
    n = sum(k.startswith(f"{arc}/decision") for k in ref)
    return [_json(ref[f"{arc}/decision{i}"]) for i in range(n)]


def _events(ref, arc, *kinds):
    return [e for e in _json(ref[f"{arc}/events"]) if e["kind"] in kinds]


def test_arcs_exercise_what_they_name(ref):
    """The reference's own record shows each arc does what it is for."""
    def md(arc):
        n = sum(k.startswith(f"{arc}/metrics") for k in ref)
        return _json(ref[f"{arc}/metrics{n - 1}"])
    # stall: shard 3 excluded, counted late-excluded, re-admitted
    dec = _decisions(ref, "stall")
    assert any(not d["healthy"][3] for d in dec) and dec[-1]["healthy"][3]
    assert md("stall")["late_excluded"][3] > 0
    assert md("stall")["shard"]["items_late"] == [0] * 8
    causes = [e["cause"] for e in _events(ref, "stall", "health_change")]
    assert "straggler flagged" in causes
    assert "re-admitted after catch-up" in causes
    # churn: replayed on a backup; sliding: the backup in the region
    for arc, shard in (("churn", 3), ("sliding", 5)):
        m = md(arc)
        assert sum(m["shard"]["items_replayed"]) > 0
        assert m["shard"]["items_late"] == [0] * 8
        assign = _events(ref, arc, "backup_assign")
        assert assign[0]["shard"] == shard
    handoff = _events(ref, "sliding", "backup_assign")
    assert len(handoff) == 3 and "intra-region" in handoff[0]["cause"]
    assert handoff[0]["backup"] // 4 == 5 // 4
    # elastic: both budgets grew past their ceilings and shrank
    counts = ref["elastic/counts"]
    dec = _decisions(ref, "elastic")
    budgets = [d["budget"] for d in dec]
    assert max(budgets) > 8 and budgets[-1] < max(budgets)
    assert counts[1] >= 2 and counts[2] == 1 + counts[1]
    assert _events(ref, "elastic", "fog_budget_resize")
    # remesh: two width changes, rows re-queued, injector translated
    assert ref["remesh/counts"][2] == 3
    assert len(ref["remesh/payload4/1"]) > 0
    assert _events(ref, "remesh", "requeue")[0]["rows"] > 0
    # two from the controller, two from the injector
    assert len(_events(ref, "remesh", "remesh")) == 4
    # slo: both SLOs breach and recover; rejects and drift logged
    for name in ("queueing-100us", "drops"):
        br = [e for e in _events(ref, "slo", "slo_breach")
              if e["slo"] == name]
        rc = [e for e in _events(ref, "slo", "slo_recover")
              if e["slo"] == name]
        assert len(br) == 1 and len(rc) == 1 and br[0]["tick"] < rc[0]["tick"]
    assert [e["tick"] for e in _events(ref, "slo", "ingest_reject")] \
        == [3, 15]
    assert len(_events(ref, "slo", "drift_detected")) == 2
    assert _decisions(ref, "slo")[-1]["slo_breached"] == []


def test_fault_injector_matches_the_jax_injector():
    """The injector is host numpy on both sides: the same schedule over
    the same feed gives the same offers, replay flags and origins, tick
    for tick (the reference's, in-process)."""
    from repro.stream.fleet import control as JC
    from repro_torch.stream.fleet import control as TC
    e, n = 6, 8
    rng = np.random.default_rng(5)
    faults, churn = [(1, 2, 5), (4, 0, 3)], [(3, 1, 6), (5, 4, None)]
    sides = [mod.FaultInjector(mod.FaultSchedule(
        [mod.Fault(*f) for f in faults], [mod.Churn(*c) for c in churn]))
        for mod in (JC, TC)]
    for t in range(12):
        items = rng.standard_normal((e, n, 2)).astype(np.float32)
        ts = np.tile(t * n + np.arange(n, dtype=np.float32), (e, 1))
        outs = [inj.inject(t, items, ts, fresh=t < 8,
                           backups={3: 0, 5: None}) for inj in sides]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sides[0].origin, sides[1].origin)
        assert sides[0].pending == sides[1].pending


def test_injector_translate_across_remesh():
    """The reference's translate cases on the port's injector: queues and
    the schedule renumber through a keep map; unmappable pending work is
    a loud error."""
    e, batch, d = 8, 8, 2
    inj = FaultInjector(FaultSchedule(
        faults=[Fault(shard=1, start=2, end=12)],
        churn=[Churn(shard=5, leave=1, join=None),
               Churn(shard=6, leave=0, join=2)]))
    base = (np.zeros((e, batch, d), np.float32),
            np.zeros((e, batch), np.float32))
    for t in range(4):
        inj.inject(t, *base, fresh=True)
    with pytest.raises(ValueError, match="pending replay"):
        inj.translate([0, 1, 2, 3], tick=4)
    inj.translate([0, 1, 5, 6], tick=4)
    assert {f.shard for f in inj.schedule.faults} == {1}
    assert {c.shard for c in inj.schedule.churn} == {2, 3}
    assert inj.origin is None and len(inj._replay[2]) == 3
    items, ts, offered, replay = inj.inject(
        4, np.zeros((4, batch, d), np.float32),
        np.zeros((4, batch), np.float32), fresh=True, backups={2: 0})
    assert replay[0] and inj.origin[0] == 2
    assert not offered[1].any() and inj.origin[3] == 3
    inj2 = FaultInjector(FaultSchedule(faults=[Fault(shard=2, start=6,
                                                     end=9)]))
    with pytest.raises(ValueError, match="fault window"):
        inj2.translate([0, 1], tick=4)
    inj3 = FaultInjector(FaultSchedule(faults=[Fault(shard=2, start=0,
                                                     end=3)]))
    inj3.translate([0, 1], tick=4)
    assert inj3.schedule.faults == ()


def test_injector_tolerates_none_backup():
    """A backups entry of None (no healthy rank left) makes the replay
    queue wait; it never broadcasts the chunk over the fleet."""
    inj = FaultInjector(FaultSchedule(churn=[Churn(shard=1, leave=0)]))
    base_items = np.arange(4 * 8 * 2, dtype=np.float32).reshape(4, 8, 2)
    base_ts = np.tile(np.arange(8, dtype=np.float32), (4, 1))
    for tick in range(2):
        items, ts, offered, replay = inj.inject(
            tick, base_items + tick, base_ts + 8 * tick, backups={1: None})
        assert not replay.any() and not offered[1].any()
        np.testing.assert_array_equal(items[[0, 2, 3]],
                                      (base_items + tick)[[0, 2, 3]])
    assert inj.pending == 2


def _sliding_fleet():
    ex = _make(_NS["SLIDING"], dict(num_shards=4, num_core=1,
                                    core_budget=8), _NS["HOT"])
    return ex, FleetController(ex), ex.init_state(_NS["D"])


def test_carry_handoff_writes_new_tensors_and_guards_misuse(clock):
    """``begin_replay_carry``/``end_replay_carry`` return a state whose
    carry leaves are new tensors (the caller's stay as they were), the
    round trip restores both slots, and every misuse is a loud error:
    double begin or end, a self-handoff, a remesh mid-handoff."""
    ex, ctl, st = _sliding_fleet()
    rng = np.random.default_rng(6)
    for t in range(2):
        st, _ = ex.step(st, *_NS["feed_tick"](rng, 4, t))
    carry0 = st.shard.carry.clone()
    valid0 = st.shard.carry_valid.clone()
    mid = ctl.begin_replay_carry(st, 2, 1)
    assert mid.shard.carry is not st.shard.carry
    assert_bitwise(st.shard.carry, carry0, "caller's carry untouched")
    assert_bitwise(st.shard.carry_valid, valid0, "caller's validity")
    assert_bitwise(mid.shard.carry[1], carry0[2], "stream carry on backup")
    assert not mid.shard.carry_valid[2].any()
    with pytest.raises(ValueError, match="already live"):
        ctl.begin_replay_carry(mid, 2, 1)
    with pytest.raises(ValueError, match="end_replay_carry"):
        ctl.remesh(mid, 4)
    back = ctl.end_replay_carry(mid, 2, 1)
    assert_bitwise(back.shard.carry, carry0, "carry round trip")
    assert_bitwise(back.shard.carry_valid, valid0, "validity round trip")
    with pytest.raises(ValueError, match="no live carry handoff"):
        ctl.end_replay_carry(back, 2, 1)
    with pytest.raises(ValueError, match="must differ"):
        ctl.begin_replay_carry(back, 1, 1)


def test_control_tick_reads_the_device_once(clock, monkeypatch):
    """A control tick moves its whole snapshot to the host in one
    transfer (a drop-only SLO lane adds none); the lineage bank is read
    only for a latency SLO."""
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)
    ex = _make(_NS["TUMBLING"], dict(num_shards=4, num_core=1,
                                     core_budget=8), _NS["HOT"])
    st, _ = ex.step(ex.init_state(_NS["D"]),
                    *_NS["feed_tick"](np.random.default_rng(7), 4, 0))
    for slos, want in (((), 1), ((SLO("d", stage="drops"),), 1),
                       ((SLO("q", target_seconds=1e-3, stage="queueing"),),
                        2)):
        ctl = FleetController(ex, slos=slos)
        calls.clear()
        monkeypatch.setattr(torch.Tensor, "cpu", counting)
        ctl.tick(st, step_times=np.full(4, 0.1))
        monkeypatch.setattr(torch.Tensor, "cpu", real)
        assert len(calls) == want, (slos, calls)


def test_max_trace_count_is_host_counting(clock):
    """``max_trace_count`` is ``1 + retraces + remeshes`` from host
    counters; a resize past the slot ceiling counts one retrace, and the
    executor's own ``trace_count`` meets the bound once a tick has
    followed each retrace and the remesh."""
    ex = _make(_NS["TUMBLING"], dict(num_shards=4, num_core=1,
                                     core_budget=2, core_budget_max=2),
               [("always", 0, ">=", -1e9, "C_SEND_CORE", 0)])
    ctl = FleetController(ex, budget_policy=ElasticBudget(
        min_budget=1, max_budget=16, patience=1))
    st = ex.init_state(_NS["D"])
    rng = np.random.default_rng(8)
    for t in range(2):
        st, _ = ex.step(st, *_NS["feed_tick"](rng, 4, t))
        dec = ctl.tick(st, step_times=np.full(4, 0.1))
    assert dec.retraced and ctl._retraces >= 1 and ex.core_slots > 2
    st, _ = ex.step(st, *_NS["feed_tick"](rng, 4, 2))
    # every retrace was followed by a tick: the bound is met exactly
    assert ex.trace_count == 1 + ctl._retraces == ctl.max_trace_count
    st, _ = ctl.remesh(st, 2)
    assert ctl.max_trace_count == 1 + ctl._retraces + 1
    assert ex.cfg.num_shards == 2
    st, _ = ex.step(st, *_NS["feed_tick"](rng, 2, 3))
    assert ex.trace_count == ctl.max_trace_count
