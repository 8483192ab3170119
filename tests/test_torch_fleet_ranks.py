"""The port's fleet laid over ranks (``FleetExecutor(mesh=rank_mesh(...))``,
one process a rank on gloo, the CPU), against the port's one-card fleet
and the JAX ``FleetExecutor``.

Each rank count (2, 4, 8) is one ``launch.mesh.spawn``: every rank runs
every arc of :data:`ARCS`, staged and fused, on its ``S / N`` rows of
the feed, with the same health and membership flips and budget cuts,
and returns its rows of each tick's outputs and state, the fleet
counters (gathered), ``lineage_counts()`` and its trace counts.  Here
the rows are stacked in rank order and held bitwise against the same
arcs on one card; the ``regions`` and ``degraded`` arcs also against
the JAX fleet's record (one subprocess on 8 forced host devices), with
``tests/test_torch_fleet.py``'s rules: core outputs within 1e-6, the
rest bitwise.  Both executor modules' clocks are the same fake on
every side (``test_torch_fleet.Clock``); across ranks the tick uses
rank 0's.  Trace counts are compared with the one-card fleet's, never
the reference's.

The layouts: 8 shards in 2 regions of 4 give ``(2, 1)``, ``(2, 2)`` and
``(2, 4)`` rank meshes (a rank's shards in one region); the ``quad``
arc's 4 regions of 2 give ``(2, 1)`` (two whole regions a rank) and
``(4, 1)``.  The same spawns run the flat fleet's exchange and
watermark (``federate_escalations``, ``fleet_watermark``) over a
``(1, N)`` mesh.  The fleet example runs on 2 and 4 ranks against one.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rules as trules
from repro_torch.launch import mesh as M
from repro_torch.stream import StreamConfig
from repro_torch.stream.fleet import FleetConfig, FleetExecutor
from repro_torch.stream.fleet import executor as TFX
from repro_torch.stream.fleet import federation as TF
from repro_torch.stream.fleet import routing as FR
from repro_torch.testing import assert_bitwise
from test_torch_fleet import _ARCS, SRC

_NS: dict = {}
exec(_ARCS, _NS)

RANKS = (2, 4, 8)
ARCS = ("regions", "degraded", "quad")
#: the arcs each rank count runs (8 ranks leave out ``quad``, whose
#: layouts 2 and 4 ranks cover: whole regions a rank, a region a rank)
ARCS_AT = {2: ARCS, 4: ARCS, 8: ("regions", "degraded")}
MODES = ("staged", "fused")
#: the arcs held against the JAX fleet too
JAX_ARCS = ("regions", "degraded")
D = _NS["D"]


def _spec(name: str, mode: str) -> dict:
    """Arc ``name`` of ``test_torch_fleet``'s, or ``quad``: 8 shards in
    4 regions of 2 under both budgets, hot from tick 2, with a health
    flip, a membership flip and a budget cut; ``mode`` sets the stream
    config's ``fused``."""
    if name == "quad":
        rng = np.random.default_rng(3)
        ticks = _NS["feed"](rng, 8, 7, hot_from=2)
        sick = np.ones(8, bool)
        sick[5] = False
        away = np.ones(8, bool)
        away[3] = False
        ticks[2]["health"], ticks[3]["active"] = sick, away
        ticks[4]["core_budget"] = 3
        ticks[4]["region_budget"] = np.asarray([2, 4, 1, 3], np.int32)
        ticks[5]["health"] = ticks[5]["active"] = np.ones(8, bool)
        spec = dict(stream=_NS["stream_kw"](), rules=_NS["HOT"], fleet=dict(
            num_shards=8, num_regions=4, num_core=2, core_budget=8,
            core_budget_max=8, fog_budget=4, fog_budget_max=6), ticks=ticks)
    else:
        spec = _NS["arcs"]()[name]
    spec["stream"] = dict(spec["stream"], fused=mode == "fused")
    return spec


def _make(spec: dict, device="cpu", mesh=None):
    """``_Port.make``'s fleet, on ``device``, over ``mesh`` if given."""
    engine = trules.RuleEngine([
        trules.threshold_rule(n, f, op, v, getattr(trules, c), priority=p)
        for n, f, op, v, c, p in spec["rules"]])
    return FleetExecutor(
        FleetConfig(stream=StreamConfig(**spec["stream"]), **spec["fleet"]),
        engine, tpipe.two_tier_pipeline(lambda p, b: (b * 1.5, b[:, :5]),
                                        lambda p, b: (b + 100.0, b[:, :5]),
                                        engine), device=device, mesh=mesh)


def _record(spec: dict, tag: str, rec: dict, device="cpu", mesh=None,
            full: bool = True) -> dict:
    """Drive ``spec`` on one fleet (one card, or this rank's rows over
    ``mesh``) under a fresh fake clock, recording each tick under
    ``tag`` as ``test_torch_fleet``'s ``run_arc`` does (``full=False``:
    the outputs only); the metrics are the gathered fleet-wide
    counters."""
    saved = TFX.time
    TFX.time = _NS["Clock"]()
    try:
        ex = _make(spec, device, mesh)
        st = ex.init_state(D)
        rows = slice(ex.shard_offset, ex.shard_offset + ex.local_shards)
        for i, t in enumerate(spec["ticks"]):
            for knob in ("health", "active"):
                if knob in t:
                    getattr(ex, "set_" + knob)(t[knob])
            if "core_budget" in t:
                ex.set_core_budget(t["core_budget"])
            if "region_budget" in t:
                ex.set_region_budget(t["region_budget"])
            kw = {k: t[k][rows] for k in ("offered", "mode", "replay")
                  if k in t}
            st, out = ex.step(st, t["items"][rows], t["ts"][rows], **kw)
            for k, v in out._asdict().items():
                rec[f"{tag}/out{i}/{k}"] = v.cpu().numpy()
            if not full:
                continue
            for k, v in _NS["flatten"](
                    convert.fleet_state_to_numpy(st)).items():
                rec[f"{tag}/state{i}/{k}"] = v
            rec[f"{tag}/metrics{i}"] = np.asarray(json.dumps(
                ex.gather(st.metrics).as_dict()))
        if full:
            rec[f"{tag}/lineage"] = ex.lineage_counts()
        rec[f"{tag}/traces"] = np.asarray([ex.trace_count,
                                           ex._compile_count()])
        if mesh is not None:
            rec[f"{tag}/mesh"] = np.asarray(mesh.mesh.shape)
    finally:
        TFX.time = saved
    return rec


def _flat_inputs():
    """A flat fleet's exchange inputs: 8 shards' ``[32, 5]`` records, an
    escalation mask, the max event times and two masks, from seed 5."""
    rng = np.random.default_rng(5)
    rec = torch.from_numpy(rng.standard_normal((8, 32, 5)).astype(np.float32))
    esc = torch.from_numpy(rng.random((8, 32)) < 0.4)
    max_ts = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    healthy = torch.from_numpy(rng.random(8) < 0.7)
    active = torch.from_numpy(rng.random(8) < 0.8)
    return rec, esc, max_ts, healthy, active


def _flat(rec, esc, ranks=None):
    """``federate_escalations`` of a flat 8-shard fleet, 2 core ranks
    under a budget of 20, the outputs and every counter as numpy."""
    out = TF.federate_escalations(
        rec, esc, lambda b: (b * 2.0 + 1.0, b[:, :3]), num_shards=8,
        num_core=2, core_budget=20, capacity=16, ranks=ranks)
    return [x.numpy() for x in out[:3]] + [x.numpy() for x in out[3]]


def _rank_arcs(rank: int, device, arcs: tuple) -> dict:
    """One rank's side: every arc of ``arcs`` and both modes, on its rows
    over the rank mesh the arc's layout takes; and the flat exchange and
    watermark of :func:`_flat_inputs` over a ``(1, N)`` mesh."""
    n = torch.distributed.get_world_size()
    mesh = M.RankMesh("cpu", range(n), (1, n), ("region", "edge"))
    ranks = TF.ranks_of(mesh, 1, 8)
    rec_, esc, max_ts, healthy, active = _flat_inputs()
    rows = slice(ranks.layout.first_shard,
                 ranks.layout.first_shard + ranks.layout.shards)
    rec: dict = {f"flat-exchange/{i}": v for i, v in enumerate(
        _flat(rec_[rows], esc[rows], ranks))}
    rec["flat-watermark/wm"] = TF.fleet_watermark(
        max_ts[rows], healthy[rows], active[rows], ranks=ranks).numpy()
    rec["flat-watermark/plain"] = TF.fleet_watermark(
        max_ts[rows], ranks=ranks).numpy()
    for name in arcs:
        for mode in MODES:
            spec = _spec(name, mode)
            cfg = FleetConfig(stream=StreamConfig(**spec["stream"]),
                              **spec["fleet"])
            _record(spec, f"{name}-{mode}", rec, device,
                    TFX.rank_mesh(cfg, device))
    return rec


#: leaves replicated over the ranks (each rank returns the fleet's)
_WHOLE = ("/metrics", "/lineage", "/traces", "/mesh", "/wm", "/plain")


def _stack(recs: list) -> dict:
    """The ranks' records as one fleet's: per-shard leaves concatenated
    in rank order; the replicated ones taken from rank 0, after checking
    every rank returned the same."""
    out = {}
    for k in recs[0]:
        if "/metrics" in k:
            assert all(str(r[k]) == str(recs[0][k]) for r in recs), k
            out[k] = recs[0][k]
        elif k.endswith(_WHOLE):
            for r in recs[1:]:
                assert_bitwise(r[k], recs[0][k], f"{k}: rank 0 vs another")
            out[k] = recs[0][k]
        else:
            out[k] = np.concatenate([r[k] for r in recs])
    return out


_RANKED: dict = {}


def _ranked(n: int) -> dict:
    """The fleet's record stacked from ``n`` gloo ranks (one spawn a
    rank count, kept for the module)."""
    if n not in _RANKED:
        _RANKED[n] = _stack(M.spawn(_rank_arcs, n, "cpu", ARCS_AT[n]))
    return _RANKED[n]


@pytest.fixture(scope="module", params=RANKS, ids=lambda n: f"{n}ranks")
def ranked(request):
    """``(N, the fleet's record stacked from N gloo ranks)``."""
    return request.param, _ranked(request.param)


@pytest.fixture(scope="module")
def one_card():
    """Every arc and mode on the port's one-card fleet (the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec: dict = {}
        for name in ARCS:
            for mode in MODES:
                _record(_spec(name, mode), f"{name}-{mode}", rec)
        return rec
    finally:
        torch.set_num_threads(n)


_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
script = open(sys.argv[1]).read()
head, tail = script.split("rec = {}")
exec(head)
rec = {}
for name in sys.argv[3].split(","):
    spec = arcs()[name]
    run_arc(spec, Api, rec, name, ticks=list(enumerate(spec["ticks"])))
np.savez(sys.argv[2], **rec)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """:data:`JAX_ARCS` through the JAX fleet on 8 forced host devices
    (``test_torch_fleet``'s producer, run for these arcs only)."""
    from test_torch_fleet import _SCRIPT
    tmp = tmp_path_factory.mktemp("jax_fleet_ranks")
    (tmp / "arcs.py").write_text(_ARCS)
    (tmp / "producer.py").write_text(
        _SCRIPT.replace("exec(open(sys.argv[1]).read())",
                        f"exec(open({str(tmp / 'arcs.py')!r}).read())"))
    (tmp / "run.py").write_text(_JAX)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, str(tmp / "run.py"),
                        str(tmp / "producer.py"), str(tmp / "ref.npz"),
                        ",".join(JAX_ARCS)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}


def _tagged(rec: dict, tag: str) -> dict:
    return {k: v for k, v in rec.items() if k.startswith(tag + "/")}


@pytest.mark.parametrize("n,arc,mode", [
    (n, arc, mode) for n in RANKS for arc in ARCS_AT[n] for mode in MODES])
def test_fleet_over_ranks_is_the_one_card_fleet(one_card, n, arc, mode):
    """Every output, state leaf, counter, the pooled lineage bank and the
    trace counts of the arc over N ranks equal the one-card fleet's,
    bitwise."""
    got = _ranked(n)
    tag = f"{arc}-{mode}"
    want = _tagged(one_card, tag)
    have = _tagged(got, tag)
    mesh = tuple(have.pop(f"{tag}/mesh"))
    assert np.prod(mesh) == n
    assert want and set(have) == set(want)
    for k, v in want.items():
        if "/metrics" in k:
            assert json.loads(str(have[k])) == json.loads(str(v)), k
        else:
            assert_bitwise(have[k], v, k)


def test_flat_exchange_and_watermark_over_ranks(ranked):
    """The flat fleet's ``federate_escalations`` and ``fleet_watermark``
    over a ``(1, N)`` mesh equal their one-card forms, bitwise: the core
    outputs, features, processed mask and every counter."""
    _, got = ranked
    rec, esc, max_ts, healthy, active = _flat_inputs()
    for i, want in enumerate(_flat(rec, esc)):
        assert_bitwise(got[f"flat-exchange/{i}"], want, f"exchange {i}")
    assert_bitwise(got["flat-watermark/wm"],
                   TF.fleet_watermark(max_ts, healthy, active).numpy(), "wm")
    assert_bitwise(got["flat-watermark/plain"],
                   TF.fleet_watermark(max_ts).numpy(), "plain")
    assert got["flat-exchange/6"][0] > 20       # the budget binds


def test_layouts_cover_both_kinds(ranked):
    """The rank meshes the arcs took: a region over several ranks, and
    several whole regions on one rank (2 ranks, 4 regions)."""
    n, got = ranked
    shapes = {k.split("/")[0].split("-")[0]: tuple(v)
              for k, v in got.items() if k.endswith("/mesh")}
    assert shapes["regions"] == shapes["degraded"] == (2, n // 2)
    if "quad" in ARCS_AT[n]:
        assert shapes["quad"] == ((2, 1) if n == 2 else (4, n // 4))


@pytest.mark.parametrize("arc", JAX_ARCS)
def test_fleet_over_ranks_matches_the_jax_fleet(ranked, jax_ref, arc):
    """The staged arc over N ranks against the JAX ``FleetExecutor``'s
    record: core outputs within 1e-6, everything else bitwise (the
    metrics as equal dicts), as ``test_torch_fleet`` holds one card."""
    _, got = ranked
    ref = _tagged(jax_ref, arc)
    assert ref
    for k, v in ref.items():
        mine = got[f"{arc}-staged/" + k.split("/", 1)[1]]
        if k.endswith("/outputs"):
            np.testing.assert_allclose(mine, v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        elif "/metrics" in k:
            assert json.loads(str(mine)) == json.loads(str(v)), k
        else:
            assert_bitwise(mine, v, k)


def test_the_degraded_arc_flips_and_cuts(one_card):
    """The ``degraded`` and ``quad`` arcs do what they are for: a shard
    excluded, one away, a budget cut, both budgets binding."""
    deg = json.loads(str(one_card["degraded-staged/metrics9"]))
    assert sum(deg["late_excluded"]) > 0 and sum(deg["fog_shed"]) > 0
    assert deg["fleet_core_overflow"] > 0
    quad = json.loads(str(one_card["quad-fused/metrics6"]))
    assert sum(quad["fog_shed"]) > 0 and quad["fleet_core_overflow"] > 0
    # both slot ceilings grow once: three signatures
    assert tuple(one_card["degraded-fused/traces"]) == (3, 3)
    assert tuple(one_card["quad-fused/traces"]) == (1, 1)


@pytest.mark.parametrize("shape", [(3, 8, 2), (2, 4, 3), (2, 6, 3),
                                   (4, 2, 8 * 3), (3, 4, 9)])
def test_a_layout_the_ranks_cannot_hold_raises(shape):
    """``rank_mesh_shape`` (and so ``rank_mesh``) raises where N does not
    divide the shards, or a rank would hold parts of two regions."""
    regions, edges, ranks = shape
    with pytest.raises(ValueError, match="cannot hold"):
        FR.rank_mesh_shape(regions, edges, ranks)


@pytest.mark.parametrize("shape,mesh", [
    ((2, 4, 1), (1, 1)), ((2, 4, 2), (2, 1)), ((2, 4, 8), (2, 4)),
    ((4, 2, 2), (2, 1)), ((1, 8, 4), (1, 4)), ((4, 2, 8), (4, 2))])
def test_rank_mesh_shape(shape, mesh):
    assert FR.rank_mesh_shape(*shape) == mesh


def test_rank_layout_rows_are_consecutive():
    """Every rank of every valid layout holds ``S / N`` consecutive
    region-major shards, and together they hold each shard once."""
    for rr, ee, n in ((2, 4, 2), (2, 4, 4), (2, 4, 8), (4, 2, 2), (4, 2, 8),
                      (1, 8, 4), (3, 6, 9)):
        grid = FR.rank_mesh_shape(rr, ee, n)
        held = []
        for row in range(grid[0]):
            for col in range(grid[1]):
                lay = FR.rank_layout(rr, ee, *grid, row, col)
                ids = [r * ee + c
                       for r in range(lay.first_region,
                                      lay.first_region + lay.regions)
                       for c in range(lay.first_col,
                                      lay.first_col + lay.edges)]
                assert ids == list(range(lay.first_shard,
                                         lay.first_shard + lay.shards))
                held += ids
        assert held == list(range(rr * ee))
    with pytest.raises(ValueError, match="cannot hold"):
        FR.rank_layout(2, 4, 1, 2)


def test_a_device_mesh_is_refused():
    """A fleet is laid over ranks by ``rank_mesh`` alone: a
    ``DeviceMesh`` raises rather than run every shard on every rank."""
    host = M.make_host_mesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="rank_mesh"):
            _make(_spec("regions", "staged"), "cpu", host)
    finally:
        M.release_host_mesh()


def _nccl_fleet(rank: int, device, arcs: tuple) -> dict:
    """The fused arcs on this rank's card (NCCL), the outputs on the
    host."""
    rec: dict = {}
    for name in arcs:
        spec = _spec(name, "fused")
        cfg = FleetConfig(stream=StreamConfig(**spec["stream"]),
                          **spec["fleet"])
        _record(spec, name, rec, device, TFX.rank_mesh(cfg, device),
                full=False)
    return rec


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards (decided at run time)")


def test_fleet_on_two_nccl_ranks_equals_one_card(two_cards):
    """Card only: the fused ``regions`` and ``quad`` arcs on 2 NCCL ranks
    (captured ticks) against the same arcs on one card, bitwise; one
    signature on each rank."""
    arcs = ("regions", "quad")
    got = _stack(M.spawn(_nccl_fleet, 2, "cuda", arcs))
    for name in arcs:
        want = _record(_spec(name, "fused"), name, {}, "cuda", full=False)
        for k, v in want.items():
            if not k.endswith("/traces"):
                assert_bitwise(got[k], v, k)
        assert tuple(got[f"{name}/traces"]) == (1, 1)


@pytest.fixture(scope="module")
def example():
    """``examples/fleet_stream_analytics_torch.py`` on one rank (the
    CPU, one intra-op thread)."""
    sys.path.insert(0, str(SRC.parent / "examples"))
    import fleet_stream_analytics_torch as ex
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ex, ex.main(device="cpu")
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("ranks", [2, 4])
def test_fleet_example_across_ranks_gives_the_one_rank_results(example,
                                                               ranks):
    """The fleet example with ``ranks=N``: its 8 bridges over N gloo
    ranks, each rank's controller on the gathered fleet; every result
    number (counters, each tick's escalations, budget and stragglers,
    the drain, the budget's resizes, the event kinds, the trace count)
    equals the one-rank run's."""
    ex, one = example
    assert ex.main(device="cpu", ranks=ranks) == one
    assert one["metrics"]["shard"]["windows_escalated"] == \
        [0, 0, 12, 12, 12, 12, 0, 0]
