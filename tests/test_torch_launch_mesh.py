"""The host mesh, the activation-constraint context and the mesh
arguments given back (``repro_torch.launch.mesh``, ``shardctx``,
``steps``, ``serve``, the registry, the fleet), on the CPU.

* ``make_host_mesh(device="cpu")``: a one-rank gloo ``DeviceMesh`` of
  shape (1, 1) ``("data", "model")``, made once a process; the module's
  fixture ends the process group it started.
* ``build_train_step(mesh=host, sequence_shard=True)`` equals
  ``mesh=None`` bitwise over 3 steps at a dense and a MoE smoke config
  (losses, grad norms, parameters); a serve run through the mesh equals
  one without bitwise (ids, logits, caches), with the registry's cache
  keyed on the mesh.
* ``shardctx.constrain`` returns its input itself outside a context and
  on a plain tensor; its template resolution equals the reference's
  ``constrain`` (the ``NamedSharding`` it hands
  ``with_sharding_constraint``) on a 1 x 1 mesh and on the production
  meshes; on a ``DTensor`` it redistributes to the resolved placements.
* ``FleetExecutor(mesh=...)`` raises the reference's error on a layout
  that does not match its config; ``remesh`` of the executor and the
  controller take a device list as the reference's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.launch import shardctx as rctx
from repro_torch import optim
from repro_torch.configs.registry import smoke_config
from repro_torch.core import pipeline as tpipe
from repro_torch.core import profiles as P
from repro_torch.core import rules as R
from repro_torch.core.serverless import FunctionRegistry
from repro_torch.launch import mesh as M
from repro_torch.launch import serve, shardctx
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T
from repro_torch.stream import StreamConfig
from repro_torch.stream.fleet import (FleetConfig, FleetController,
                                      FleetExecutor)
from repro_torch.testing import assert_bitwise


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host():
    mesh = M.make_host_mesh(device="cpu")
    yield mesh
    M.release_host_mesh()
    assert not dist.is_initialized()


def test_host_mesh_is_one_gloo_rank(host):
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.mesh.shape) == (1, 1)
    assert host.device_type == "cpu"
    assert M.axis_sizes(host) == {"data": 1, "model": 1}
    assert M.dp_axes(host) == ("data",) and M.model_axis(host) == "model"
    assert M.dp_size(host) == 1
    assert M.make_host_mesh(device="cpu") is host      # once a process
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="does not divide"):
        M.make_host_mesh(model=2, device="cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x7b"])
def test_train_step_on_the_host_mesh_is_bitwise_meshless(host, arch):
    cfg = smoke_config(arch)
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(3)]
    runs = []
    for mesh in (None, host):
        model = T.init_params(cfg, seed=1, device="cpu", trainable=True)
        if mesh is not None:
            model = S.place(model, S.param_shardings(cfg, mesh, model), mesh)
        opt_cfg = optim.AdamWConfig(lr=1e-3)
        state = optim.init(model, opt_cfg)
        step = steps_mod.build_train_step(cfg, opt_cfg, mesh=mesh,
                                          sequence_shard=mesh is not None)
        metrics = []
        for b in batches:
            model, state, m = step(model, state, b)
            metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
        runs.append((model, metrics))
    (m0, met0), (m1, met1) = runs
    for (l0, g0), (l1, g1) in zip(met0, met1):
        assert_bitwise(l1, l0, "loss")
        assert_bitwise(g1, g0, "grad norm")
    p1 = dict(m1.named_parameters())
    for name, p in m0.named_parameters():
        assert_bitwise(_bits(p1[name].detach()), _bits(p.detach()), name)


def test_serve_on_the_host_mesh_is_bitwise_meshless(host):
    cfg = smoke_config("yi_6b")
    runs = [serve.run(cfg, 3, 6, 5, device="cpu", mesh=mesh)
            for mesh in (None, host)]
    a, b = runs
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert_bitwise(_bits(b.logits), _bits(a.logits), "logits")
    for ca, cb in zip(a.caches, b.caches):
        for k in ca:
            assert_bitwise(_bits(cb[k]), _bits(ca[k]), f"cache {k}")
    assert b.aot_cached == a.aot_cached == 1


def test_registry_keys_its_cache_on_the_mesh(host):
    reg = FunctionRegistry(device="cpu")
    reg.store_function("f", P.profile("t"), lambda x: x * 2)
    spec = torch.empty((4,), device="meta")
    for mesh in (host, host, None, M.make_production_mesh()):
        reg.start_function(P.profile("t"), spec, mesh=mesh)
    assert reg.statistics()["aot_cached"] == 3


def test_constrain_is_the_identity_without_a_dtensor(host):
    x = torch.ones((2, 8, 4))
    assert shardctx.constrain(x, ("dp", "seq", None)) is x
    assert shardctx.dp_axes() is None
    assert shardctx.resolve(("dp", None), (2, 8)) is None
    with shardctx.activation_sharding(host, M.dp_axes(host),
                                      sequence_axis="model"):
        assert shardctx.constrain(x, ("dp", "seq", None)) is x
        assert shardctx.constrain_residual(x) is x
        assert shardctx.dp_axes() == ("data",)
    assert shardctx.dp_axes() is None


#: the templates the models place, and shapes on both sides of each
#: divisibility rule
TEMPLATES = [("dp", "seq", None, None), ("dp", None, None, None),
             ("dp", "seq", None), ("dp", None, "seq", None),
             ("dp", None, None, "seq"), ("dp", None, None),
             ("dp", "ep", "cap", None)]
SHAPES = [(32, 64, 8, 128), (16, 48, 4, 16), (3, 8, 7, 5), (64, 32, 16, 16)]


def _ref_spec(monkeypatch, ref_mesh, dp, seq, moe, template, shape):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    with rctx.activation_sharding(ref_mesh, dp, sequence_axis=seq,
                                  moe_axes=moe):
        rctx.constrain(jax.ShapeDtypeStruct(shape[:len(template)],
                                            jnp.float32), template)
    return tuple(seen[0].spec)


@pytest.mark.parametrize("mesh_name", ["1x1", "16x16", "2x16x16"])
def test_template_resolution_equals_the_reference(monkeypatch, host,
                                                  mesh_name):
    ref_mesh, mine = {
        "1x1": (AbstractMesh((1, 1), ("data", "model")), host),
        "16x16": (AbstractMesh((16, 16), ("data", "model")),
                  M.make_production_mesh()),
        "2x16x16": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                    M.make_production_mesh(multi_pod=True))}[mesh_name]
    dp = M.dp_axes(mine)
    n = 0
    for seq in ("model", None):
        for moe in (None, ("model", None), (None, "model")):
            for template in TEMPLATES:
                for shape in SHAPES:
                    want = _ref_spec(monkeypatch, ref_mesh, dp, seq, moe,
                                     template, shape)
                    with shardctx.activation_sharding(
                            mine, dp, sequence_axis=seq, moe_axes=moe):
                        got = shardctx.resolve(template,
                                               shape[:len(template)])
                    assert got == want, (template, shape, seq, moe)
                    n += 1
    assert n == 2 * 3 * len(TEMPLATES) * len(SHAPES)


def test_constrain_redistributes_a_dtensor(host):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    d = distribute_tensor(x, host, [Replicate(), Replicate()])
    with shardctx.activation_sharding(host, M.dp_axes(host),
                                      sequence_axis="model"):
        y = shardctx.constrain(d, ("dp", "seq", None))
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert_bitwise(y.full_tensor(), x, "redistributed values")
    assert S.placements(("data", None, "model"), host) == [Shard(0),
                                                           Shard(2)]
    assert S.placements((None, None), host) == [Replicate(), Replicate()]


BATCH, D = 32, 3


def _engine():
    return R.RuleEngine([
        R.threshold_rule("hot", 0, ">=", 0.5, R.C_SEND_CORE, priority=1),
        R.threshold_rule("sparse", 4, "<", 4.0, R.C_STORE_EDGE, priority=2)])


def _fleet(mesh=None):
    engine = _engine()
    scfg = StreamConfig(micro_batch=BATCH, window=16, stride=16,
                        capacity=4 * BATCH, lateness=4.0)
    cfg = FleetConfig(stream=scfg, num_shards=4, num_core=2, core_budget=4,
                      core_budget_max=8, num_regions=2, fog_budget=4,
                      fog_budget_max=8)
    return FleetExecutor(cfg, engine, tpipe.two_tier_pipeline(
        lambda p, b: (b * 1.5, b[:, :5]),
        lambda p, b: (b + 100.0, b[:, :5]), engine), device="cpu", mesh=mesh)


def _feed(rng, e, t):
    items = rng.standard_normal((e, BATCH, D)).astype(np.float32)
    ts = np.tile(t * BATCH + np.arange(BATCH, dtype=np.float32), (e, 1))
    return items, ts


def test_fleet_mesh_layout_and_remesh_device_list():
    ok = M.AbstractMesh((2, 2), ("region", "edge"))
    ex = _fleet(ok)
    assert ex.mesh is ok
    assert M.axis_sizes(_fleet().mesh) == {"region": 2, "edge": 2}
    for bad in (M.AbstractMesh((4, 1), ("region", "edge")),
                M.AbstractMesh((2, 2), ("data", "model"))):
        with pytest.raises(ValueError, match="does not match config"):
            _fleet(bad)
    # a device list and its length re-lay the fleet alike
    runs = []
    for devices in (["d0", "d1", "d2", "d3", "d4", "d5"], 6):
        ex = _fleet()
        st = ex.init_state(D)
        for t in range(3):
            st, _ = ex.step(st, *_feed(np.random.default_rng(t), 4, t))
        st, departed = ex.remesh(st, devices)
        st, out = ex.step(st, *_feed(np.random.default_rng(9), 6, 3))
        runs.append((st, out, ex))
    (s0, o0, e0), (s1, o1, e1) = runs
    assert e0.cfg.num_shards == e1.cfg.num_shards == 6
    assert M.axis_sizes(e0.mesh) == {"region": 2, "edge": 3}
    for field in o0._fields:
        assert_bitwise(getattr(o1, field), getattr(o0, field), field)
    # the controller's remesh takes the surviving devices too
    ex = _fleet()
    ctl = FleetController(ex)
    st = ex.init_state(D)
    st, _ = ex.step(st, *_feed(np.random.default_rng(1), 4, 0))
    ctl.tick(st)
    st, payload = ctl.remesh(st, ["d0", "d1"], keep=[0, 1],
                             num_regions=1)
    assert ex.cfg.num_shards == 2 and ex.cfg.num_regions == 1
    assert M.axis_sizes(ex.mesh) == {"region": 1, "edge": 2}
    assert sorted(payload) == [2, 3]
