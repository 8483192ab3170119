"""The port's fleet control plane across ranks (``FleetController`` over
a ``FleetExecutor`` laid over gloo ranks, one process a rank, the CPU)
against the same controller on one card.

The controller arcs of ``test_torch_fleet_control.py`` (its ``_ARCS``
source, executed here as there) run over 2 and 4 ranks, each rank count
one ``launch.mesh.spawn`` that runs every arc: a stall with catch-up,
tumbling churn, sliding churn with the carry handoff, the elastic
budgets, the controller's ``remesh``, the SLO lane, the elastic budgets
under a controller that ticks without ``step_times`` (rank 0's own wall
time, a fake clock here), and a carry handoff between shards that lie
on different ranks.  The remesh arc's widths 4 -> 3 -> 4 take the
largest prefix of the ranks that holds them: on 4 ranks one shard a
rank (as the reference has one a device), rank 3 idle while the fleet
is 3 wide; on 2 ranks the 3 shards lie on rank 0 alone.  Each rank
feeds its rows of the arc's fleet-wide feed, and records, for every
tick it is a member, the fleet-wide (gathered) outputs, state and
counters, its ``ControlDecision`` and the remesh payloads on its host.
Held bitwise against the one-card port (which
``test_torch_fleet_control`` holds to the JAX controller arc by arc):
every decision on every rank, every output and state leaf, the
counters, rank 0's event log less its wall times (the other ranks' logs
hold only the injector's records), the payloads, ``resizes``,
``_retraces`` and ``max_trace_count``, the tick-latency percentiles (a
rank that sat out takes rank 0's histogram back at the remesh), and
each rank's executor ``trace_count <= max_trace_count``.

The same spawns run the misuse guards: a remesh during a live carry
handoff raises on every rank, and a width the rank set cannot hold
raises before any row moves (no byte sent, nothing changed).
"""
import json
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_fleet_control as C
from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rules as trules
from repro_torch.launch import mesh as M
from repro_torch.stream import StreamConfig
from repro_torch.stream.fleet import (FleetConfig, FleetController,
                                      FleetExecutor)
from repro_torch.stream.fleet import executor as TFX
from repro_torch.stream.fleet import routing as FR
from repro_torch.testing import assert_bitwise

RANKS = (2, 4)
#: every arc of ``test_torch_fleet_control``: the six, the arc without
#: step_times and a carry handoff between shards on two ranks (the
#: sliding arc's backup shares its stream's rank)
ARCS = tuple(C._NS["ARCS"])
#: the controller's event kinds (what only rank 0's log holds)
_CONTROLLER = {"budget_resize", "health_change", "leave", "join",
               "backup_assign", "fog_budget_resize", "slo_breach",
               "slo_recover", "ingest_reject", "drift_detected"}

#: the arcs' source, run here with a rank-aware recorder
_RNS: dict = {}
exec(C._ARCS, _RNS)


class _RankRecorder(_RNS["Recorder"]):
    """The arcs' recorder on one rank: every record fleet-wide (gathered)
    on the ticks this rank is a member, an ``idle`` mark on the others."""

    def tick(self, i, st, out, dec):
        rec, tag, ex = self.rec, self.tag, self.api.ex
        if dec is None:
            rec[f"{tag}/idle{i}"] = np.asarray(i)
            return
        for k, v in self.api.out(out).items():
            rec[f"{tag}/out{i}/{k}"] = v
        for k, v in self.api.state(st).items():
            rec[f"{tag}/state{i}/{k}"] = v
        rec[f"{tag}/metrics{i}"] = np.asarray(
            json.dumps(ex.gather(st.metrics).as_dict()))
        rec[f"{tag}/decision{i}"] = np.asarray(
            json.dumps(_RNS["plain"](dec._asdict())))

    def finish(self, ctl, ex, log):
        super().finish(ctl, ex, log)
        self.rec[f"{self.tag}/traces"] = np.asarray(
            [ex.trace_count, ctl.max_trace_count])
        self.rec[f"{self.tag}/latency"] = np.asarray(
            json.dumps(ex.latency_percentiles()))


_RNS["Recorder"] = _RankRecorder


def _holds(regions: int, edges: int, ranks: int) -> bool:
    try:
        FR.rank_mesh_shape(regions, edges, ranks)
    except ValueError:
        return False
    return True


class _RankApi:
    """The arcs' ``api`` on one rank: the fleet laid over the ranks
    (``rank_mesh``), each rank feeding its rows of the fleet-wide feed,
    the records gathered."""
    ElasticBudget = C.ElasticBudget
    StragglerDetector = C.StragglerDetector
    EventLog = C.EventLog
    SLO = C.SLO
    Fault, Churn = C.Fault, C.Churn
    FaultSchedule, FaultInjector = C.FaultSchedule, C.FaultInjector
    AdmissionPlan, DataContract = C.AdmissionPlan, C.DataContract

    FleetController = FleetController

    def __init__(self):
        self.ex = None

    def make(self, stream, fleet, spec, tiers="scale"):
        engine = trules.RuleEngine([
            trules.threshold_rule(n, f, op, v, getattr(trules, c),
                                  priority=p)
            for n, f, op, v, c, p in spec])
        edge, core = _RNS["TIERS"][tiers]
        cfg = FleetConfig(stream=StreamConfig(**stream), **fleet)
        self.ex = FleetExecutor(cfg, engine,
                                tpipe.two_tier_pipeline(edge, core, engine),
                                device="cpu", mesh=TFX.rank_mesh(cfg, "cpu"))
        return self.ex

    @staticmethod
    def step(ex, st, items, ts, **kw):
        rows = slice(ex.shard_offset, ex.shard_offset + ex.local_shards)
        return ex.step(st, items[rows], ts[rows],
                       **{k: v[rows] for k, v in kw.items()})

    @staticmethod
    def remesh(ctl, st, n, **kw):
        """Width ``n`` over the largest prefix of the world's ranks that
        holds it (the region count stays)."""
        rr = ctl.executor.cfg.num_regions
        k = next(k for k in range(min(n, dist.get_world_size()), 0, -1)
                 if _holds(rr, n // rr, k))
        return ctl.remesh(st, n, ranks=list(range(k)), **kw)

    @staticmethod
    def fold(ctl, log):
        return {str(k): v for k, v in ctl.remesh_fold.items()}

    def out(self, out):
        return {k: v.numpy() for k, v in self.ex.gather(out)._asdict().items()}

    def state(self, st):
        return _RNS["flatten"](convert.fleet_state_to_numpy(
            self.ex.gather(st)))


def _guards(rec: dict) -> None:
    """The misuse guards on this rank, recorded under ``guard/``."""
    ns = _RNS
    api = _RankApi()
    n = dist.get_world_size()
    rng = np.random.default_rng(6)
    # a remesh during a live handoff raises on every rank; the handoff
    # then closes and the fleet ticks on
    ex = api.make(ns["SLIDING"], dict(num_shards=8, num_core=2,
                                      core_budget=64, num_regions=2),
                  ns["HOT"])
    ctl = FleetController(ex)
    st = ex.init_state(ns["D"])
    for t in range(2):
        st, _ = api.step(ex, st, *ns["feed_tick"](rng, 8, t))
        ctl.tick(st, step_times=np.full(8, 0.1))
    backup = ctl.leave(5)
    mid = ctl.begin_replay_carry(st, 5, backup)
    try:
        ctl.remesh(mid, 8)
        rec["guard/live"] = "no error"
    except ValueError as err:
        rec["guard/live"] = str(err)
    back = ctl.end_replay_carry(mid, 5, backup)
    rec["guard/round_trip"] = bool(
        torch.equal(ex.gather(back.shard.carry), ex.gather(st.shard.carry))
        and torch.equal(ex.gather(back.shard.carry_valid),
                        ex.gather(st.shard.carry_valid)))
    ctl.join(5)
    st, _ = api.step(ex, back, *ns["feed_tick"](rng, 8, 2))
    rec["guard/after_handoff"] = ctl.tick(st).budget
    # 3 shards over every rank: the ranks cannot hold them; nothing moves
    ex = api.make(ns["TUMBLING"], dict(num_shards=4, num_core=2,
                                       core_budget=64), ns["HOT"])
    ctl = FleetController(ex)
    st, _ = api.step(ex, ex.init_state(ns["D"]),
                     *ns["feed_tick"](rng, 4, 0))
    ctl.tick(st)
    sent = M.COLLECTIVES.sent_bytes
    try:
        ctl.remesh(st, 3, keep=[0, 1, 2], ranks=list(range(n)))
        rec["guard/width"] = "no error"
    except ValueError as err:
        rec["guard/width"] = str(err)
    rec["guard/width_moved"] = M.COLLECTIVES.sent_bytes - sent
    rec["guard/width_after"] = (ex.cfg.num_shards, ex.remeshes,
                                ex.local_shards)
    st, _ = api.step(ex, st, *ns["feed_tick"](rng, 4, 1))
    rec["guard/after_width"] = ctl.tick(st).budget


def _rank_arcs(rank: int, device) -> dict:
    """One rank's side: every arc of :data:`ARCS` under a fresh fake
    clock, then the misuse guards."""
    rec: dict = {}
    saved = TFX.time
    try:
        for name in ARCS:
            TFX.time = _RNS["Clock"]()
            _RNS["ARCS"][name](_RankApi(), rec)
        _guards(rec)
    finally:
        TFX.time = saved
    return rec


_RANKED: dict = {}


def _ranked(n: int) -> list:
    """Each rank's record of ``n`` gloo ranks (one spawn a rank count,
    kept for the module)."""
    if n not in _RANKED:
        _RANKED[n] = M.spawn(_rank_arcs, n, "cpu")
    return _RANKED[n]


@pytest.fixture(scope="module")
def one_card():
    """Every arc on the port's one-card controller (the CPU), each under
    a fresh fake clock, as ``test_torch_fleet_control`` runs them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = TFX.time
    rec: dict = {}
    try:
        for name in ARCS:
            TFX.time = C._NS["Clock"]()
            C._BUILT.clear()
            C._NS["ARCS"][name](C.PORT, rec)
            ex = next(x for x in C._BUILT if isinstance(x, FleetExecutor))
            rec[f"{name}/latency"] = np.asarray(
                json.dumps(ex.latency_percentiles()))
    finally:
        TFX.time = saved
        C._BUILT.clear()
        torch.set_num_threads(threads)
    return rec


_PER_TICK = re.compile(r"^(out|state|metrics|decision)(\d+)$")


def _tick_of(key: str) -> int | None:
    m = _PER_TICK.match(key.split("/")[1])
    return None if m is None else int(m.group(2))


def _plain_events(a) -> list:
    return [{k: v for k, v in e.items() if k != "seq"}
            for e in json.loads(str(a))]


@pytest.mark.parametrize("n,arc", [(n, a) for n in RANKS for a in ARCS])
def test_control_arc_across_ranks_is_the_one_card_arc(one_card, n, arc):
    """Every rank's record of the arc equals the one-card controller's
    bitwise on every tick it was a member of the fleet: the decision,
    every output and state leaf, the counters, the payloads; rank 0's
    event log equal, the others' only the injector's records; the
    counts equal and ``trace_count <= max_trace_count`` on every rank."""
    want = {k: v for k, v in one_card.items() if k.startswith(arc + "/")}
    assert want
    events = json.loads(str(want.pop(f"{arc}/events")))
    latency = json.loads(str(want.pop(f"{arc}/latency")))
    for rank, rec in enumerate(_ranked(n)):
        got = {k: v for k, v in rec.items() if k.startswith(arc + "/")}
        idle = {int(v) for k, v in got.items() if "/idle" in k}
        assert not idle or rank > 0, "rank 0 never leaves the fleet"
        trace, bound = got.pop(f"{arc}/traces")
        assert 1 <= trace <= bound, (rank, trace, bound)
        assert json.loads(str(got.pop(f"{arc}/latency"))) == latency, rank
        mine = json.loads(str(got.pop(f"{arc}/events")))
        if rank == 0:
            assert mine == events
        else:
            assert all(e["kind"] not in _CONTROLLER and "fold" not in e
                       for e in mine), rank
            assert _plain_events(json.dumps(mine)) == _plain_events(
                json.dumps([e for e in events
                            if e["kind"] not in _CONTROLLER
                            and "fold" not in e]))
        expect = {k for k in want if _tick_of(k) not in idle}
        assert set(got) - {k for k in got if "/idle" in k} == expect, rank
        for k in expect:
            if k.split("/")[-1].startswith(("metrics", "decision")):
                assert json.loads(str(got[k])) == json.loads(str(want[k])), \
                    (rank, k)
            else:
                assert_bitwise(got[k], want[k], f"rank {rank} {k}")


def test_arcs_across_ranks_do_what_they_name():
    """The rank runs exercise what the slice is for: the ``handoff``
    arc's stream and backup lie on different ranks on both rank counts,
    and the remesh arc leaves a rank idle (4 -> 3 -> 4: rank 3; 2 -> 1 ->
    2: rank 1) and its payload comes back on every rank."""
    for n in RANKS:
        per = 8 // n
        assert 1 // per != 6 // per
        recs = _ranked(n)
        idle = {r: sorted(int(v) for k, v in rec.items()
                          if k.startswith("remesh/idle"))
                for r, rec in enumerate(recs)}
        assert idle[n - 1] == [4, 5, 6], (n, idle)
        assert all(not v for r, v in idle.items() if r != n - 1), idle
        for rec in recs:
            assert len(rec["remesh/payload4/1"]) > 0


@pytest.mark.parametrize("n", RANKS)
def test_remesh_during_a_live_handoff_raises_on_every_rank(n):
    for rec in _ranked(n):
        assert "end_replay_carry" in rec["guard/live"], rec["guard/live"]
        assert rec["guard/round_trip"] is True
    assert len({rec["guard/after_handoff"] for rec in _ranked(n)}) == 1


@pytest.mark.parametrize("n", RANKS)
def test_a_width_the_ranks_cannot_hold_raises_before_rows_move(n):
    for rank, rec in enumerate(_ranked(n)):
        assert "cannot hold" in rec["guard/width"], rec["guard/width"]
        assert rec["guard/width_moved"] == 0
        assert rec["guard/width_after"] == (4, 0, 4 // n), rank
    assert len({rec["guard/after_width"] for rec in _ranked(n)}) == 1
