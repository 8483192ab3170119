"""The port's fleet (``repro_torch.stream.fleet``, on the CPU) against
the JAX ``FleetExecutor``, arc by arc.

The JAX fleet needs 8 devices, and XLA fixes the device count when JAX
starts, so one module-scoped subprocess runs every arc of
:data:`_ARCS` on 8 forced host devices and writes each tick's outputs,
state and metrics to an ``.npz``; the port then runs the same arcs
in-process.  Both sides build the arcs from the same source (the
``_ARCS`` text, executed on each side), seeded numpy inputs included.
Both executors stamp ring rows with wall time, so each executor
module's clock is a fake that advances the same way on both sides.

Held bitwise: aggregates, features, window counts, consequences,
escalations, every ``FleetState`` leaf, ``metrics.as_dict()``, the
departed ring rows of a remesh and ``lineage_counts()``.  Core outputs
are held within 1e-6.  Trace counts are not compared: they are the
reference's jit discipline, which PyTorch has no counterpart of.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch import convert
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rules as trules
from repro_torch.stream import StreamConfig, StreamExecutor
from repro_torch.stream.fleet import FleetConfig, FleetExecutor
from repro_torch.stream.fleet import executor as TFX
from repro_torch.testing import assert_bitwise

SRC = Path(__file__).resolve().parents[1] / "src"

#: the arcs, as plain numpy and Python: executed on both sides
_ARCS = textwrap.dedent("""
    import json

    import numpy as np

    D, BATCH = 3, 32
    HOT = [("hot", 0, ">=", 1.0, "C_SEND_CORE", 2),
           ("sparse", 4, "<", 8.0, "C_STORE_EDGE", 1)]
    ALWAYS = [("always", 0, ">=", -1e9, "C_SEND_CORE", 0)]
    NEVER = [("never", 0, ">=", 1e9, "C_SEND_CORE", 0)]
    MODE_REPLAY, MODE_BACKFILL = 1, 2


    def stream_kw(**kw):
        return {**dict(micro_batch=BATCH, window=16, stride=8,
                       capacity=128, lateness=8.0), **kw}


    def tick(rng, s, t0, n=BATCH, hot=False, **actions):
        items = rng.standard_normal((s, n, D)).astype(np.float32)
        if hot:
            items[:, :, 0] += 1.5          # hot regime: escalations
        ts = np.tile(t0 + np.arange(n, dtype=np.float32), (s, 1))
        return dict(items=items, ts=ts, **actions)


    def feed(rng, s, steps, hot_from=99, n=BATCH):
        return [tick(rng, s, i * n, n, hot=i >= hot_from)
                for i in range(steps)]


    def degraded(rng):
        s = 8
        ticks = feed(rng, s, 10, hot_from=2)
        for t in ticks[1:]:
            t["ts"][5] -= 40.0             # shard 5 lags the fleet
        sick = np.ones(s, bool)
        sick[5] = False
        away = np.ones(s, bool)
        away[6] = False
        ticks[1]["health"] = sick
        ticks[2]["active"] = away
        offered = np.ones((s, BATCH), bool)
        offered[3] = False                 # a stalled uplink
        offered[4, ::2] = False            # half an uplink
        ticks[3]["offered"] = offered
        mode = np.zeros(s, np.int32)
        mode[2], mode[7] = MODE_REPLAY, MODE_BACKFILL
        ticks[4]["mode"] = mode
        ticks[4]["ts"][[2, 7]] -= 300.0    # old, lateness-exempt rows
        replay = np.zeros(s, bool)
        replay[1] = True
        ticks[5]["replay"] = replay
        ticks[5]["ts"][1] -= 200.0
        ticks[6]["core_budget"] = 4        # within the ceiling
        ticks[7]["core_budget"] = 12       # past it
        ticks[8]["health"] = np.ones(s, bool)
        ticks[8]["active"] = np.ones(s, bool)
        ticks[8]["region_budget"] = np.asarray([3, 7], np.int32)
        return ticks


    def remesh_ticks(rng):
        n = 48                             # > micro_batch: rows queue up
        ticks, t0 = [], 0.0
        layout = [8, 8, 8, 6, 6, 8, 8, 4, 4]
        for i, s in enumerate(layout):
            ticks.append(tick(rng, s, t0, n, hot=i % 2 == 1))
            t0 += n
        ticks[3]["remesh"] = dict(num_shards=6, keep=[0, 1, 2, 4, 6, 7],
                                  fold_counters={3: 2, 5: 4})
        ticks[5]["remesh"] = dict(num_shards=8,
                                  keep=[0, 1, 2, None, 3, 4, 5, None])
        ticks[7]["remesh"] = dict(num_shards=4, num_regions=1,
                                  keep=[0, 1, 2, 3],
                                  fold_counters={4: 0, 5: 1, 6: 2, 7: 3})
        return ticks


    def arcs():
        rng = np.random.default_rng(0)
        zeros = np.zeros((2, BATCH, D), np.float32)
        lag_a = np.stack([1000.0 + np.arange(BATCH, dtype=np.float32),
                          np.arange(BATCH, dtype=np.float32)])
        lag_b = np.stack([500.0 + np.arange(BATCH, dtype=np.float32),
                          32.0 + np.arange(BATCH, dtype=np.float32)])
        return {
            "flat": dict(stream=stream_kw(), rules=HOT, fleet=dict(
                num_shards=8, num_core=2, core_budget=256),
                ticks=feed(rng, 8, 8, hot_from=4)),
            "budget": dict(stream=stream_kw(), rules=ALWAYS, fleet=dict(
                num_shards=4, num_core=2, core_budget=5),
                ticks=feed(rng, 4, 3)),
            "laggard": dict(
                stream=stream_kw(capacity=256, lateness=4.0), rules=NEVER,
                fleet=dict(num_shards=2, num_core=1, core_budget=4),
                ticks=[dict(items=zeros, ts=lag_a),
                       dict(items=zeros, ts=lag_b),
                       dict(items=zeros, ts=lag_b + BATCH)]),
            "regions": dict(stream=stream_kw(), rules=HOT, fleet=dict(
                num_shards=8, num_regions=2, num_core=2, core_budget=10,
                fog_budget=6, fog_budget_max=12),
                ticks=feed(rng, 8, 8, hot_from=3)),
            "degraded": dict(stream=stream_kw(), rules=HOT, fleet=dict(
                num_shards=8, num_regions=2, num_core=2, core_budget=6,
                core_budget_max=8, fog_budget=5),
                ticks=degraded(rng)),
            "remesh": dict(stream=stream_kw(), rules=HOT, fleet=dict(
                num_shards=8, num_regions=2, num_core=2, core_budget=9,
                fog_budget=7), ticks=remesh_ticks(rng)),
        }


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


    def run_arc(spec, api, rec, tag, ticks=None, ex=None, st=None):
        # drive one arc through ``api`` (one package's executor calls),
        # recording every tick under ``tag``
        if ex is None:
            ex = api.make(spec)
            st = ex.init_state(D)
        todo = spec["ticks"] if ticks is None else ticks
        for i, t in todo:
            if "remesh" in t:
                st, departed = api.remesh(ex, st, **t["remesh"])
                for k, rows in departed.items():
                    rec[f"{tag}/departed{i}/{k}"] = np.asarray(rows)
            for knob in ("health", "active"):
                if knob in t:
                    getattr(ex, "set_" + knob)(t[knob])
            if "core_budget" in t:
                ex.set_core_budget(t["core_budget"])
            if "region_budget" in t:
                ex.set_region_budget(t["region_budget"])
            kw = {k: t[k] for k in ("offered", "mode", "replay") if k in t}
            st, out = api.step(ex, st, t["items"], t["ts"], **kw)
            for k, v in api.out(out).items():
                rec[f"{tag}/out{i}/{k}"] = v
            for k, v in api.state(st).items():
                rec[f"{tag}/state{i}/{k}"] = v
            rec[f"{tag}/metrics{i}"] = np.asarray(
                json.dumps(st.metrics.as_dict()))
        rec[f"{tag}/lineage"] = ex.lineage_counts()
        return ex, st
""")

_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax, jax.numpy as jnp
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.core import pipeline as pipe
    from repro.core import rules
    from repro.stream import StreamConfig
    from repro.stream.fleet import FleetConfig, FleetExecutor
    from repro.stream.fleet import executor as FX

    exec(open(sys.argv[1]).read())
    FX.time = Clock()


    class Api:
        @staticmethod
        def make(spec):
            engine = rules.RuleEngine([
                rules.threshold_rule(n, f, op, v, getattr(rules, c),
                                     priority=p)
                for n, f, op, v, c, p in spec["rules"]])
            return FleetExecutor(
                FleetConfig(stream=StreamConfig(**spec["stream"]),
                            **spec["fleet"]), engine,
                pipe.two_tier_pipeline(lambda p, b: (b * 1.5, b[:, :5]),
                                       lambda p, b: (b + 100.0, b[:, :5]),
                                       engine))

        @staticmethod
        def step(ex, st, items, ts, **kw):
            kw = {k: jnp.asarray(v) for k, v in kw.items()}
            return ex.step(st, jnp.asarray(items), jnp.asarray(ts), **kw)

        @staticmethod
        def remesh(ex, st, num_shards, **kw):
            return ex.remesh(st, jax.devices()[:num_shards], **kw)

        @staticmethod
        def out(out):
            return flatten(jax.device_get(out))

        @staticmethod
        def state(st):
            return flatten(jax.device_get(st))


    rec = {}
    for name, spec in arcs().items():
        run_arc(spec, Api, rec, name,
                ticks=list(enumerate(spec["ticks"])))
        print("ARC_OK", name, flush=True)
    np.savez(sys.argv[2], **rec)
""")

#: the arcs' source, run on this side too
_NS: dict = {}
exec(_ARCS, _NS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every arc through the JAX fleet on 8 forced host devices, in one
    subprocess: ``{key: array}`` of its record."""
    tmp = tmp_path_factory.mktemp("jax_fleet")
    (tmp / "arcs.py").write_text(_ARCS)
    (tmp / "run.py").write_text(_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, str(tmp / "run.py"),
                        str(tmp / "arcs.py"), str(tmp / "ref.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}


class _Port:
    """The port's side of ``run_arc``, on the CPU."""

    @staticmethod
    def make(spec, fleet=None):
        engine = trules.RuleEngine([
            trules.threshold_rule(n, f, op, v, getattr(trules, c),
                                  priority=p)
            for n, f, op, v, c, p in spec["rules"]])
        return FleetExecutor(
            FleetConfig(stream=StreamConfig(**spec["stream"]),
                        **(fleet or spec["fleet"])), engine,
            tpipe.two_tier_pipeline(lambda p, b: (b * 1.5, b[:, :5]),
                                    lambda p, b: (b + 100.0, b[:, :5]),
                                    engine), device="cpu")

    @staticmethod
    def step(ex, st, items, ts, **kw):
        return ex.step(st, items, ts, **kw)

    @staticmethod
    def remesh(ex, st, num_shards, **kw):
        return ex.remesh(st, num_shards, **kw)

    @staticmethod
    def out(out):
        return {k: v.numpy() for k, v in out._asdict().items()}

    @staticmethod
    def state(st):
        return _NS["flatten"](convert.fleet_state_to_numpy(st))


@pytest.fixture
def clock(monkeypatch):
    c = _NS["Clock"]()
    monkeypatch.setattr(TFX, "time", c)
    return c


def _compare(ref: dict, got: dict, tag: str):
    """Every key the reference recorded under ``tag``: core outputs
    within 1e-6, the rest bitwise (metrics as equal dicts)."""
    keys = sorted(k for k in ref if k.startswith(tag + "/"))
    assert keys and set(keys) == {k for k in got if k.startswith(tag + "/")}
    for k in keys:
        if k.endswith("/outputs"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        elif "/metrics" in k:
            assert json.loads(str(got[k])) == json.loads(str(ref[k])), k
        else:
            assert_bitwise(got[k], ref[k], k)


@pytest.mark.parametrize("arc", ["flat", "budget", "laggard", "regions",
                                 "degraded", "remesh"])
def test_fleet_arc_matches_the_jax_fleet(ref, clock, arc):
    spec = _NS["arcs"]()[arc]
    got = {}
    _NS["run_arc"](spec, _Port, got, arc,
                   ticks=list(enumerate(spec["ticks"])))
    _compare(ref, got, arc)


def test_arcs_exercise_what_they_name(ref):
    """The reference's own record shows each arc does what it is for:
    the budgets bind, the watermark holds laggards back, the degraded
    run sheds, excludes and replays, and the remesh returns rows."""
    def md(arc, i):
        return json.loads(str(ref[f"{arc}/metrics{i}"]))
    flat = md("flat", 7)
    assert flat["fleet_core_overflow"] == 0 \
        and flat["fleet"]["windows_escalated"] > 0
    assert md("budget", 2)["fleet_core_overflow"] > 0
    assert md("laggard", 1)["shard"]["items_late"] == [0, 0]
    regions = md("regions", 7)
    assert sum(regions["fog_shed"]) > 0 and regions["fleet_core_overflow"] > 0
    deg = md("degraded", 9)
    assert sum(deg["late_excluded"]) > 0
    assert sum(deg["fog_shed"]) > 0 and deg["fleet_core_overflow"] > 0
    assert deg["shard"]["items_replayed"][1] > 0
    assert deg["shard"]["items_replayed"][2] > 0
    assert deg["shard"]["items_backfilled"][7] > 0
    assert md("degraded", 3)["shard"]["items_offered"][3] == \
        md("degraded", 2)["shard"]["items_offered"][3]
    departed = [k for k in ref if k.startswith("remesh/departed")]
    assert len(departed) == 6 and all(len(ref[k]) for k in departed)


def test_state_carried_over_from_the_jax_fleet(ref, clock):
    """A JAX fleet state after 4 ticks, carried across with
    ``convert.fleet_state_from_numpy``, continues on the port as it did
    on the reference for 4 more ticks."""
    spec = _NS["arcs"]()["regions"]
    k = 4

    def ns(prefix):
        """The recorded state as the reference's nested attributes."""
        tree: dict = {}
        for key, v in ref.items():
            if key.startswith(prefix):
                *path, leaf = key[len(prefix):].split(".")
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v

        def to_ns(d):
            return SimpleNamespace(**{a: to_ns(b) if isinstance(b, dict)
                                      else b for a, b in d.items()})
        return to_ns(tree)
    ex = _Port.make(spec)
    clock.t += 0.25 * 3 * k          # the reference's clock after k ticks
    st = convert.fleet_state_from_numpy(ns(f"regions/state{k - 1}/"),
                                        device="cpu")
    got = {}
    _NS["run_arc"](spec, _Port, got, "regions",
                   ticks=list(enumerate(spec["ticks"]))[k:], ex=ex, st=st)
    got.pop("regions/lineage")       # the banks started empty here
    assert len(got) > 4 * 20
    for key, v in got.items():
        if key.endswith("/outputs"):
            np.testing.assert_allclose(v, ref[key], rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        elif "/metrics" in key:
            assert json.loads(str(v)) == json.loads(str(ref[key])), key
        else:
            assert_bitwise(v, ref[key], key)


def test_one_shard_fleet_is_the_stream_executor(clock):
    """A 1-shard port fleet equals the port's own StreamExecutor, every
    output and counter (the reference's SINGLE arc, here bitwise)."""
    spec = _NS["arcs"]()["flat"]
    ex = _Port.make(spec, dict(num_shards=1, num_core=1, core_budget=3))
    st = ex.init_state(_NS["D"])
    engine = ex.engine
    sx = StreamExecutor(StreamConfig(**spec["stream"]), engine,
                        tpipe.two_tier_pipeline(
                            lambda p, b: (b * 1.5, b[:, :5]),
                            lambda p, b: (b + 100.0, b[:, :5]), engine,
                            core_capacity=3), device="cpu")
    ss = sx.init_state(_NS["D"])
    for i, t in enumerate(spec["ticks"]):
        st, fo = ex.step(st, t["items"][:1], t["ts"][:1])
        ss, so = sx.step(ss, t["items"][0], t["ts"][0])
        for f in so._fields:
            assert_bitwise(getattr(fo, f)[0], getattr(so, f), f"{i} {f}")
    fm, sm = st.metrics.as_dict(), ss.metrics.as_dict()
    assert {k: v[0] for k, v in fm["shard"].items() if k != "drift_counts"} \
        == {k: v for k, v in sm.items() if k != "drift_counts"}
    assert fm["shard"]["drift_counts"][0] == sm["drift_counts"]
    assert fm["shard"]["core_overflow"][0] > 0      # the budget bound


def test_ring_storage_stays_in_place(clock):
    """The tick writes each shard's ring through a row view of the
    stacked storage: the storage tensor never moves or grows."""
    spec = _NS["arcs"]()["regions"]
    ex = _Port.make(spec)
    st = ex.init_state(_NS["D"])
    ptr = st.shard.rb.store.data_ptr()
    for t in spec["ticks"][:3]:
        st, _ = ex.step(st, t["items"], t["ts"])
        assert st.shard.rb.store.data_ptr() == ptr
    assert int(st.shard.rb.head.sum()) > 0
