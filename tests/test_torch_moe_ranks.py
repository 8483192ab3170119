"""The MoE layer and MoE training over data ranks (``models.moe`` under
``shardctx.batch_split``, ``launch.steps.build_train_step`` and
``launch.train.run`` on a host mesh of N gloo ranks, one process a rank
through ``launch.mesh.spawn``), on the CPU.

One spawn of 2 ranks and one of 4 run every case; the one-process
references run here.  Each rank holds the r-th of N contiguous parts of
the global batch, and the layer must compute what one process computes
on the whole batch: the group count and capacity of the global tokens,
the global plan.

The layer, ``[16, 3, 64]`` float32 tokens (48 in all) through the MoE
layers of Mixtral-8x7B's and Kimi-K2's smoke configs (E 4 top-2; E 8
top-2 and a shared expert), in four regimes: one group spanning every
rank; 3 groups, whose 16 tokens neither a rank's share divides nor
divide it; two whole groups a rank; and a router built so that every
token's first choice is expert 0, which makes the global capacity bind
(the test asserts that the per-rank plans would keep other choices).
Tolerances:

* ``pos`` and ``keep`` of each rank's choices, and the global counts
  and overflow: bitwise the one-process plan's;
* the outputs, and the gradients of the tokens and the router from a
  loss through outputs and aux: within 1e-6 of the largest magnitude
  (``RTOL``; each rank's GEMMs take fewer rows);
* ``overflow_frac`` and ``load_max``: equal (ratios of the same
  integers);
* the ranks' aux-loss shares sum to the one-process aux loss within
  1e-6 relative.

Training, Mixtral's and Kimi-K2's smoke configs in float32 compute,
``SyntheticTokens`` batches of 8 x 32, 3 steps at K = 1 and 2
microbatches through ``train.run``: each loss and grad norm within 1e-6
relative of one process on the whole batch, each parameter leaf within
1e-5 of its largest magnitude (``tests/test_torch_train_ranks.py``'s
``RTOL`` and ``PARAM_TOL``, for its reasons), the replicas bitwise equal
after every step.  The step's ``ce`` and ``aux`` metrics against one
process's, within 1e-6 relative.  4 ranks of Mixtral against the JAX
reference's data-parallel loop on a ``(4, 1)`` mesh of forced host
devices, in a subprocess, from its weights: each loss within 1e-4
relative (``JAX_RTOL``).
"""
import dataclasses
import hashlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert, optim
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import shardctx
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models import transformer as T

SRC = Path(__file__).resolve().parents[1] / "src"
RANKS = (2, 4)
KS = (1, 2)
ARCHS = ("mixtral_8x7b", "kimi_k2_1t_a32b")
#: the layer's global batch: 16 rows of 3 tokens
ROWS, SEQ_L = 16, 3
CASES = ("spanning", "straddling", "whole", "binding")
STEPS, BATCH, SEQ, LR = 3, 8, 32, 2e-3
RTOL = 1e-6
PARAM_TOL = 1e-5
JAX_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str):
    return dataclasses.replace(smoke_config(arch),
                               compute_dtype=torch.float32)


def _groups(case: str, n: int) -> int | None:
    """The global group count of a layer case on ``n`` ranks: 1 (a group
    spans the ranks), 3 (16 tokens a group, 48 / n a rank: neither
    divides the other), 2n (two whole groups a rank)."""
    return {"spanning": None, "binding": None, "straddling": 3,
            "whole": 2 * n}[case]


def _layer_inputs(arch: str, case: str):
    """The MoE parameters of ``arch``'s smoke config (seed 3) and the
    ``[16, 3, D]`` tokens.  ``binding``: every token carries a common
    direction ``u``, which the router's expert-0 column reads 4-fold, so
    that every token's first choice is expert 0."""
    cfg = smoke_config(arch)
    d = cfg.d_model
    p = moe.init_moe(torch.Generator().manual_seed(3), d, cfg.moe,
                     torch.float32, "cpu")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((ROWS, SEQ_L, d)).astype(np.float32)
    if case == "binding":
        u = rng.standard_normal(d).astype(np.float32)
        x += u
        p["router"][:, 0] = torch.from_numpy(4 * u / np.dot(u, u) ** 0.5)
    return cfg.moe, p, torch.from_numpy(x)


def _layer(cfg, p, x, groups, row0: int = 0):
    """One call with gradients on rows ``row0`` onward of the batch:
    (outputs, stats, the token and router gradients of ``sum(out * w) +
    aux``, ``w`` a fixed weight of each global element), on the host."""
    p = {k: (v.clone().requires_grad_(True) if k == "router" else v)
         for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    out, stats = moe.moe_apply(p, x, cfg, num_groups=groups)
    w = torch.sin(0.37 * (torch.arange(out.numel()) + row0 * out[0].numel())
                  ).reshape(out.shape)
    (torch.sum(out * w) + stats["aux_loss"]).backward()
    return dict(out=out.detach(), grad_x=x.grad, grad_router=p["router"].grad,
                **{k: float(v) for k, v in stats.items()})


def _route_ids(cfg, p, x) -> torch.Tensor:
    """Each token's top-k experts, token-major ``[tokens * k]``."""
    _, _, ids = moe.route(x.reshape(1, -1, x.shape[-1]), p["router"],
                          cfg.top_k)
    return ids.reshape(-1)


def _rank_layers(split, n: int) -> dict:
    """Every layer case on this rank's share of the tokens."""
    out = {}
    for arch in ARCHS:
        for case in CASES:
            cfg, p, x = _layer_inputs(arch, case)
            per = ROWS // n
            share = x[split.rank * per:(split.rank + 1) * per]
            g = _groups(case, n) or moe._pick_groups(ROWS * SEQ_L)
            with shardctx.batch_split(split):
                rec = _layer(cfg, p, share, _groups(case, n),
                             split.rank * per)
                plan = moe.rank_plan(_route_ids(cfg, p, share),
                                     cfg.num_experts, g,
                                     moe.capacity(cfg, ROWS * SEQ_L // g),
                                     split)
            rec["plan"] = plan
            out[arch, case] = rec
    return out


def _digest(model, opt_state) -> str:
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        for t in (p.detach(), opt_state.m[name], opt_state.v[name]):
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _train(arch: str, k: int, model, mesh=None) -> dict:
    """``train.run`` for 3 steps (on ``mesh``: this rank's share of the
    global batch): losses, grad norms, final parameters, a digest after
    every step."""
    digests = []
    res = train.run(_cfg(arch), STEPS, BATCH, SEQ, microbatches=k, lr=LR,
                    device="cpu", model=model, mesh=mesh,
                    on_step=lambda s, m, o: digests.append(_digest(m, o)))
    return dict(losses=res.losses, gnorms=res.grad_norms,
                params=_params(res.model), digests=digests)


def _metrics(arch: str, model, mesh=None) -> dict:
    """One step of ``build_train_step`` at K = 2 on the first
    ``SyntheticTokens`` batch: its ``loss``, ``ce`` and ``aux``."""
    from repro_torch.data import SyntheticTokens
    if mesh is not None:
        M.broadcast_params(model, M.data_group(mesh))
    opt_cfg = optim.AdamWConfig(lr=LR)
    step = steps_mod.build_train_step(_cfg(arch), opt_cfg,
                                      num_microbatches=2, mesh=mesh)
    b = {key: torch.from_numpy(v) for key, v in
         SyntheticTokens(_cfg(arch).vocab, SEQ, BATCH).batch_at(0).items()}
    if mesh is not None:
        b = S.batch_share(b, mesh, 2)
    _, _, m = step(model, optim.init(model, opt_cfg), b)
    return {key: float(m[key]) for key in ("loss", "ce", "aux")}


def _model(arch: str, seed: int):
    return T.init_params(_cfg(arch), seed=seed, device="cpu", trainable=True)


def _rank_moe(rank: int, device, jax_params) -> dict:
    """Every case on one rank of a gloo spawn.  Rank 0 trains from the
    seed-1 weights (the JAX reference's for its case); the others from
    other weights, which the broadcast must replace."""
    mesh = M.make_host_mesh(device="cpu")
    n = M.dp_size(mesh)
    out = {"rank": rank, "layers": _rank_layers(shardctx.mesh_split(mesh), n),
           "train": {}, "metrics": {}}
    seed = 1 if rank == 0 else 50 + rank
    for arch in ARCHS:
        for k in KS:
            out["train"][arch, k] = _train(arch, k, _model(arch, seed), mesh)
        out["metrics"][arch] = _metrics(arch, _model(arch, seed), mesh)
    if jax_params is not None:
        model = convert.train_model_from_numpy(
            _cfg("mixtral_8x7b"), jax_params, "cpu") if rank == 0 \
            else _model("mixtral_8x7b", seed)
        out["jax"] = train.run(_cfg("mixtral_8x7b"), STEPS, BATCH, SEQ,
                               microbatches=2, lr=LR, device="cpu",
                               model=model, mesh=mesh).losses
    return out


_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro import optim
    from repro.configs.registry import smoke_config
    from repro.data import SyntheticTokens
    from repro.launch import sharding as shd
    from repro.launch import steps as steps_mod
    from repro.models import transformer as T
    from repro.optim.schedule import cosine_with_warmup

    jax.config.update("jax_threefry_partitionable", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    out, arch = sys.argv[1], sys.argv[2]
    steps, batch, seq, k = map(int, sys.argv[3:7])
    lr = float(sys.argv[7])
    cfg = dataclasses.replace(smoke_config(arch), compute_dtype=jnp.float32)
    # launch/train.py's loop on make_host_mesh()'s (4, 1) layout, with
    # Auto axes (the Explicit axes jax.make_mesh gives by default fail
    # the embedding gather on jax 0.9)
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    init = lambda: T.init_params(cfg, jax.random.PRNGKey(0))
    psh = shd.param_shardings(cfg, mesh, jax.eval_shape(init))
    ocfg = optim.AdamWConfig(lr=lr)
    with mesh:
        params = jax.jit(init, out_shardings=psh)()
        opt = jax.jit(lambda p: optim.init(p, ocfg),
                      out_shardings=shd.opt_shardings(psh))(params)
    first = [np.asarray(x) for x in jax.tree.leaves(params)]
    sched = lambda s: cosine_with_warmup(s, warmup=10, total=steps * 10)
    step = jax.jit(steps_mod.build_train_step(
        cfg, ocfg, num_microbatches=k, schedule=sched, mesh=mesh,
        sequence_shard=False), donate_argnums=(0, 1))
    src = SyntheticTokens(cfg.vocab, seq, batch)
    losses = []
    with mesh:
        for i in range(steps):
            b = {n: jnp.asarray(v) for n, v in src.batch_at(i).items()}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
    np.savez(out, losses=np.asarray(losses),
             **{f"p{i}": x for i, x in enumerate(first)})
""")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The reference's data-parallel loop on Mixtral's smoke config on 4
    forced host devices: its initial parameters and its 3 losses."""
    import jax
    from repro.configs.registry import smoke_config as jax_smoke
    from repro.models import transformer as JT
    out = tmp_path_factory.mktemp("moe_ranks") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                        "mixtral_8x7b", str(STEPS), str(BATCH), str(SEQ),
                        "2", str(LR)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    got = dict(np.load(out))
    tree = jax.tree.structure(jax.eval_shape(
        lambda: JT.init_params(jax_smoke("mixtral_8x7b"),
                               jax.random.PRNGKey(0))))
    params = jax.tree.unflatten(tree, [got[f"p{i}"]
                                       for i in range(tree.num_leaves)])
    return params, got["losses"].tolist()


_RANKED: dict = {}


@pytest.fixture(scope="module")
def ranked(jax_ref):
    """``n`` -> every rank's record (one spawn a rank count)."""
    def get(n):
        if n not in _RANKED:
            _RANKED[n] = M.spawn(_rank_moe, n, "cpu",
                                 jax_ref[0] if n == 4 else None)
        return _RANKED[n]
    return get


_ONE: dict = {}


@pytest.fixture(scope="module")
def one():
    """The one-process references, by what they are of."""
    def get(*key):
        if key not in _ONE:
            if key[0] == "layer":
                _, arch, case, n = key
                cfg, p, x = _layer_inputs(arch, case)
                _ONE[key] = _layer(cfg, p, x, _groups(case, n))
            elif key[0] == "train":
                _, arch, k = key
                _ONE[key] = _train(arch, k, _model(arch, 1))
            else:
                _ONE[key] = _metrics(key[1], _model(key[1], 1))
        return _ONE[key]
    return get


def _global_plan(arch: str, case: str, n: int):
    """The one-process plan of a layer case's whole batch."""
    cfg, p, x = _layer_inputs(arch, case)
    g = _groups(case, n) or moe._pick_groups(ROWS * SEQ_L)
    dest = _route_ids(cfg, p, x).reshape(g, -1)
    return moe.dispatch_plan(dest, cfg.num_experts,
                             moe.capacity(cfg, ROWS * SEQ_L // g))


def _near(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= RTOL, f"{what}: {err:.3e} of the largest > {RTOL}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_rank_plan_is_the_global_plan(ranked, n, arch, case):
    """Each rank's ``pos`` and ``keep`` are its slice of the one-process
    plan of the whole batch, bit for bit, and every rank holds the
    global counts and overflow."""
    want = _global_plan(arch, case, n)
    pos, keep = want.pos.reshape(-1), want.keep.reshape(-1)
    for part in ranked(n):
        got = part["layers"][arch, case]["plan"]
        lo = part["rank"] * pos.numel() // n
        hi = lo + pos.numel() // n
        assert torch.equal(got.pos, pos[lo:hi]), part["rank"]
        assert torch.equal(got.keep, keep[lo:hi]), part["rank"]
        assert torch.equal(got.counts, want.counts)
        assert torch.equal(got.overflow, want.overflow)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_moe_over_ranks_equals_one_process(ranked, one, n, arch, case):
    """The ranks' outputs, in rank order, are one process's on the whole
    batch, and so are the gradients of the tokens and (summed over the
    ranks) of the router; ``overflow_frac`` and ``load_max`` are the
    global batch's on every rank."""
    want = one("layer", arch, case, n)
    parts = [p["layers"][arch, case] for p in ranked(n)]
    _near(torch.cat([p["out"] for p in parts]), want["out"], "outputs")
    _near(torch.cat([p["grad_x"] for p in parts]), want["grad_x"],
          "token gradients")
    _near(sum(p["grad_router"] for p in parts), want["grad_router"],
          "router gradients")
    for p in parts:
        assert p["overflow_frac"] == want["overflow_frac"]
        assert p["load_max"] == want["load_max"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_aux_shares_sum_to_the_global_loss(ranked, one, n, arch, case):
    """Each rank's ``aux_loss`` is its share: the shares sum to the
    one-process load-balance loss."""
    want = one("layer", arch, case, n)["aux_loss"]
    got = sum(p["layers"][arch, case]["aux_loss"] for p in ranked(n))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_constructed_router_binds_the_global_capacity(ranked, one, n, arch):
    """With every token's first choice expert 0, the global capacity
    binds (choices overflow) and the plan each rank would make of its
    own tokens keeps other choices than the global plan: the equality
    above is not vacuous."""
    cfg, p, x = _layer_inputs(arch, "binding")
    assert one("layer", arch, "binding", n)["overflow_frac"] > 0
    ids = _route_ids(cfg, p, x)
    per = ids.numel() // n
    local = torch.cat([moe.dispatch_plan(
        ids[r * per:(r + 1) * per][None], cfg.num_experts,
        moe.capacity(cfg, ROWS * SEQ_L // n)).keep[0] for r in range(n)])
    glob = _global_plan(arch, "binding", n).keep.reshape(-1)
    assert not torch.equal(local, glob)
    assert torch.equal(torch.cat([q["layers"][arch, "binding"]["plan"].keep
                                  for q in ranked(n)]), glob)


def _leaf_err(got: dict, want: dict) -> dict:
    return {k: float(np.abs(got[k] - w).max() / np.abs(w).max())
            for k, w in want.items()}


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_moe_train_over_ranks_equals_one_process(ranked, one, n, arch, k):
    """``train.run`` of an MoE config on N ranks equals one process on
    the whole batch: losses, grad norms and parameters, on every
    rank."""
    want = one("train", arch, k)
    for part in ranked(n):
        got = part["train"][arch, k]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["gnorms"], want["gnorms"], rtol=RTOL)
        err = _leaf_err(got["params"], want["params"])
        assert max(err.values()) <= PARAM_TOL, err


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_moe_replicas_stay_bitwise_equal(ranked, n, arch, k):
    """After every step every replica holds the same parameters and
    moments, bit for bit, and reports the same losses and grad norms."""
    parts = ranked(n)
    first = parts[0]["train"][arch, k]
    assert len(first["digests"]) == STEPS
    for part in parts[1:]:
        got = part["train"][arch, k]
        assert got["digests"] == first["digests"], part["rank"]
        assert got["losses"] == first["losses"]
        assert got["gnorms"] == first["gnorms"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", RANKS)
def test_step_metrics_are_the_global_batchs(ranked, one, n, arch):
    """The step's ``loss``, ``ce`` and ``aux`` (the last microbatch's) on
    every rank are one process's on the whole batch."""
    want = one("metrics", arch)
    assert want["aux"] > 0
    for part in ranked(n):
        got = part["metrics"][arch]
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)


def test_four_ranks_match_the_jax_reference_loop(ranked, jax_ref):
    """Mixtral's smoke config on 4 ranks, from the reference's weights
    handed to rank 0, follows the reference's own data-parallel loop on
    a (4, 1) mesh: ``SyntheticTokens`` batches of 8 x 32 in 2
    microbatches, lr 2e-3 under the cosine schedule."""
    for part in ranked(4):
        np.testing.assert_allclose(part["jax"], jax_ref[1], rtol=JAX_RTOL)
