"""Data-parallel training across ranks (``launch.train.run`` and
``launch.steps.build_train_step`` on a host mesh of N gloo ranks, one
process a rank through ``launch.mesh.spawn``), on the CPU.

One spawn of 2 ranks and one of 4 run every case; the one-process
references run here.  Yi-6B's smoke config in float32 compute.

Tolerances, each stated where it is used:

* N ranks against one process on the same global batch, 3 steps at
  K = 1 and 2 microbatches: each loss and grad norm within 1e-6
  relative, and with labels below 0 masking rows unevenly across the
  ranks the gradients the first step hands AdamW within 1e-6 of each
  leaf's largest magnitude -- the ranks sum each gradient in another
  order (their shares', then the all-reduce); each parameter leaf
  within 1e-5 of its largest magnitude (``chip_smoke.py``'s
  ``TRAIN_CARD_VS_CPU``), since AdamW divides each gradient by its own
  magnitude plus 1e-8: a gradient element near 1e-7 turns that rounding
  into up to 1e-3 of its update (3.1e-6 of the embedding's largest
  value after 3 steps of the uneven batch on 2 ranks);
* the replicas against each other: bitwise, parameters and moments
  after every step, and the losses and grad norms;
* 4 ranks against the JAX reference's data-parallel loop (its
  ``build_train_step(mesh=)`` on a ``(4, 1)`` Auto-axes mesh of forced
  host devices, in a subprocess): each loss within 1e-4 relative,
  ``tests/test_torch_train_entry.py``'s tolerance;
* a run resumed on 2 ranks from rank 0's checkpoint against an
  uninterrupted one: within ``test_torch_train_entry.py``'s 1e-6.
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
from repro_torch.launch import sharding as S
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.testing import assert_bitwise

SRC = Path(__file__).resolve().parents[1] / "src"
RANKS = (2, 4)
KS = (1, 2)
STEPS, BATCH, SEQ, LR = 3, 8, 32, 2e-3
#: a batch neither 2 x 2 nor 4 x 2 divides
ODD = 6
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


def _cfg(arch: str = "yi_6b"):
    return dataclasses.replace(smoke_config(arch),
                               compute_dtype=torch.float32)


def _model(seed: int):
    return T.init_params(_cfg(), seed=seed, device="cpu", trainable=True)


def _digest(model, opt_state) -> str:
    """A hash of every parameter's and moment's bytes."""
    h = hashlib.sha256()
    for n, p in model.named_parameters():
        for t in (p.detach(), opt_state.m[n], opt_state.v[n]):
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _params(model) -> dict:
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _uneven(step: int) -> dict:
    """A global batch whose labels below 0 fall unevenly over the ranks:
    rows 2 and 3 keep 3 labels, row 5 every other one, row 7 none (on 4
    ranks with 2 microbatches one rank's second microbatch holds no
    label)."""
    rng = np.random.default_rng(100 + step)
    tok = rng.integers(0, _cfg().vocab, (BATCH, SEQ + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[2:4, 3:] = -1
    labels[5, ::2] = -1
    labels[7, :] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def _step_loop(k: int, model, mesh=None) -> dict:
    """3 train steps of :func:`_uneven` batches (on a mesh of N ranks,
    from rank 0's weights, this rank's share) at ``train.run``'s lr and
    schedule: losses, grad norms, the gradients the first step hands
    AdamW, the final parameters and a digest after every step."""
    if mesh is not None:
        M.broadcast_params(model, M.data_group(mesh))
    grads = {}
    real = optim.update

    def update(g, *a, **kw):        # the gradients AdamW takes first
        if not grads:
            grads.update({n: t.detach().numpy().copy() for n, t in g.items()})
        return real(g, *a, **kw)
    optim.update = update
    opt_cfg = optim.AdamWConfig(lr=LR)
    state = optim.init(model, opt_cfg)
    step = steps_mod.build_train_step(
        _cfg(), opt_cfg, num_microbatches=k, mesh=mesh,
        schedule=lambda s: cosine_with_warmup(s, warmup=10,
                                              total=STEPS * 10))
    out = {"losses": [], "gnorms": [], "digests": []}
    for i in range(STEPS):
        b = {key: torch.from_numpy(v) for key, v in _uneven(i).items()}
        if mesh is not None:
            b = S.batch_share(b, mesh, k)
        model, state, m = step(model, state, b)
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["grad_norm"]))
        out["digests"].append(_digest(model, state))
    optim.update = real
    out["params"], out["grads"] = _params(model), grads
    return out


def _rank_train(rank: int, device, tmp: str, jax_params) -> dict:
    """Every case on one rank of a gloo spawn.  Rank 0 starts from the
    seed-1 weights (the JAX reference's for its case); the others from
    other weights, which the broadcast must replace."""
    from repro_torch.checkpoint import CheckpointManager
    mesh = M.make_host_mesh(device="cpu")
    n = M.dp_size(mesh)
    seed = 1 if rank == 0 else 50 + rank
    out = {"rank": rank, "synthetic": {}, "uneven": {}}
    for k in KS:
        digests = []
        res = train.run(_cfg(), STEPS, BATCH, SEQ, microbatches=k, lr=LR,
                        device="cpu", model=_model(seed), mesh=mesh,
                        on_step=lambda s, m, o: digests.append(
                            _digest(m, o)))
        out["synthetic"][k] = dict(
            losses=res.losses, gnorms=res.grad_norms,
            params=_params(res.model), digests=digests,
            monitors=(res.health.num_ranks, res.stragglers.num_ranks,
                      res.health.alive.tolist()))
        out["uneven"][k] = _step_loop(k, _model(seed), mesh)

    # a batch N x K does not divide: every rank trains all of it
    res = train.run(_cfg(), 2, ODD, SEQ, microbatches=2, lr=LR,
                    device="cpu", model=_model(seed), mesh=mesh)
    out["replicated"] = (res.losses, _params(res.model))

    # the shares of a global batch, and one the ranks do not divide
    rows = np.arange(BATCH * 3, dtype=np.int32).reshape(BATCH, 3)
    out["shares"] = {k: S.batch_share({"tokens": rows}, mesh, k)["tokens"]
                     for k in KS}
    odd = {"tokens": rows[:6]}
    out["odd"] = (S.batch_splits(odd, mesh, 2),
                  S.batch_share(odd, mesh, 2)["tokens"])

    # the in-place collectives: the same tensor back, its bytes counted
    x = torch.full((5,), float(rank + 1))
    sent0 = M.COLLECTIVES.sent_bytes
    y = M.all_reduce_(x, torch.distributed.ReduceOp.SUM, M.data_group(mesh))
    z = torch.full((3,), float(rank))
    w = M.broadcast_(z, M.data_group(mesh))
    out["in_place"] = (y is x, x.tolist(), w is z, z.tolist(),
                       M.COLLECTIVES.sent_bytes - sent0)

    if jax_params is not None:
        model = convert.train_model_from_numpy(_cfg(), jax_params, "cpu") \
            if rank == 0 else _model(seed)
        out["jax"] = train.run(_cfg(), STEPS, BATCH, SEQ, microbatches=2,
                               lr=LR, device="cpu", model=model,
                               mesh=mesh).losses
    if n == 2:
        saves = []
        real = CheckpointManager.save

        def save(self, step, tree):
            saves.append(step)
            return real(self, step, tree)
        CheckpointManager.save = save
        kw = dict(lr=LR, device="cpu", mesh=mesh)
        full = train.run(_cfg(), 4, 4, 16, model=_model(seed), **kw)
        first = train.run(_cfg(), 2, 4, 16, model=_model(seed),
                          ckpt_dir=tmp, ckpt_every=2, **kw)
        rest = train.run(_cfg(), 4, 4, 16, ckpt_dir=tmp, ckpt_every=2,
                         resume=True, model=_model(seed), **kw)
        CheckpointManager.save = real
        out["resume"] = dict(
            saves=saves, first=first.checkpoints, rest=rest.checkpoints,
            start=rest.start_step, losses=(first.losses + rest.losses,
                                           full.losses),
            params=(_params(rest.model), _params(full.model)))
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
    out = sys.argv[1]
    steps, batch, seq, k = map(int, sys.argv[2:6])
    lr = float(sys.argv[6])
    cfg = dataclasses.replace(smoke_config("yi_6b"),
                              compute_dtype=jnp.float32)
    # launch/train.py's loop on make_host_mesh()'s (4, 1) layout, with
    # Auto axes: on jax 0.9 the Explicit axes jax.make_mesh gives by
    # default fail the embedding gather
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
    """The reference's data-parallel loop on 4 forced host devices: its
    initial parameters (the tree of ``init_params(PRNGKey(0))``) and its
    3 losses."""
    import jax
    from repro.configs.registry import smoke_config as jax_smoke
    from repro.models import transformer as JT
    out = tmp_path_factory.mktemp("train_ranks") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out),
                        str(STEPS), str(BATCH), str(SEQ), "2", str(LR)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    got = dict(np.load(out))
    tree = jax.tree.structure(jax.eval_shape(
        lambda: JT.init_params(jax_smoke("yi_6b"), jax.random.PRNGKey(0))))
    params = jax.tree.unflatten(tree, [got[f"p{i}"]
                                       for i in range(tree.num_leaves)])
    return params, got["losses"].tolist()


_RANKED: dict = {}


@pytest.fixture(scope="module")
def ranked(jax_ref, tmp_path_factory):
    """``n`` -> every rank's record (one spawn a rank count)."""
    def get(n):
        if n not in _RANKED:
            tmp = tmp_path_factory.mktemp(f"ckpt{n}")
            _RANKED[n] = M.spawn(_rank_train, n, "cpu", str(tmp),
                                 jax_ref[0] if n == 4 else None)
        return _RANKED[n]
    return get


_ONE: dict = {}


@pytest.fixture(scope="module")
def one():
    """The one-process runs from rank 0's weights, by case and K."""
    def get(case, k):
        if (case, k) not in _ONE:
            if case == "synthetic":
                res = train.run(_cfg(), STEPS, BATCH, SEQ, microbatches=k,
                                lr=LR, device="cpu", model=_model(1))
                _ONE[case, k] = dict(losses=res.losses, gnorms=res.grad_norms,
                                     params=_params(res.model))
            else:
                _ONE[case, k] = _step_loop(k, _model(1))
        return _ONE[case, k]
    return get


def _leaf_err(got: dict, want: dict) -> dict:
    """Each leaf's largest difference over its largest magnitude."""
    return {n: float(np.abs(got[n] - w).max() / np.abs(w).max())
            for n, w in want.items()}


def _close_to_one(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
    np.testing.assert_allclose(got["gnorms"], want["gnorms"], rtol=RTOL)
    if "grads" in want:
        err = _leaf_err(got["grads"], want["grads"])
        assert max(err.values()) <= RTOL, err
    err = _leaf_err(got["params"], want["params"])
    assert max(err.values()) <= PARAM_TOL, err


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", RANKS)
def test_train_run_over_ranks_equals_one_process(ranked, one, n, k):
    """``train.run`` on N ranks (each its share of the same global
    ``SyntheticTokens`` batches) equals one process on the whole batch:
    losses, grad norms and parameters, on every rank."""
    for part in ranked(n):
        _close_to_one(part["synthetic"][k], one("synthetic", k))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", RANKS)
def test_uneven_label_masks_over_ranks_equal_one_process(ranked, one, n, k):
    """Labels below 0 that mask rows unevenly across the ranks (one rank's
    microbatch holds none on 4 ranks): each microbatch's loss is divided
    by its count over all ranks, so the step equals one process's."""
    for part in ranked(n):
        _close_to_one(part["uneven"][k], one("uneven", k))


@pytest.mark.parametrize("case", ["synthetic", "uneven"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", RANKS)
def test_replicas_stay_bitwise_equal(ranked, n, k, case):
    """After every step every replica holds the same parameters and
    moments, bit for bit, and reports the same loss and grad norm."""
    parts = ranked(n)
    first = parts[0][case][k]
    assert len(first["digests"]) == STEPS
    for part in parts[1:]:
        got = part[case][k]
        assert got["digests"] == first["digests"], part["rank"]
        assert got["losses"] == first["losses"]
        assert got["gnorms"] == first["gnorms"]


@pytest.mark.parametrize("n", RANKS)
def test_a_batch_the_ranks_do_not_divide_replicates(ranked, n):
    """6 rows in 2 microbatches over N ranks: every rank trains the whole
    batch, nothing summed, bitwise one process's run."""
    res = train.run(_cfg(), 2, ODD, SEQ, microbatches=2, lr=LR,
                    device="cpu", model=_model(1))
    for part in ranked(n):
        losses, params = part["replicated"]
        assert losses == res.losses
        for name, p in res.model.named_parameters():
            assert_bitwise(params[name], p.detach(), name)


@pytest.mark.parametrize("n", RANKS)
def test_monitors_count_every_rank(ranked, n):
    """The health and straggler monitors hold N ranks, every one alive."""
    for part in ranked(n):
        for k in KS:
            assert part["synthetic"][k]["monitors"] == (n, n, [True] * n)


@pytest.mark.parametrize("n", RANKS)
def test_batch_share_follows_the_microbatch_split(ranked, n):
    """Rank r holds the r-th of N parts of every microbatch: for each
    microbatch m, the ranks' slice m in rank order is global microbatch
    m.  A batch N x K does not divide is every rank's whole."""
    rows = np.arange(BATCH * 3, dtype=np.int32).reshape(BATCH, 3)
    parts = ranked(n)
    for k in KS:
        shares = [p["shares"][k] for p in parts]
        assert all(s.shape == (BATCH // n, 3) for s in shares)
        per = BATCH // n // k
        for m in range(k):
            got = np.concatenate([s[m * per:(m + 1) * per] for s in shares])
            np.testing.assert_array_equal(
                got, rows[m * BATCH // k:(m + 1) * BATCH // k])
    for p in parts:
        splits, share = p["odd"]
        assert splits is (6 % (2 * n) == 0)
        if not splits:
            np.testing.assert_array_equal(share, rows[:6])


@pytest.mark.parametrize("n", RANKS)
def test_in_place_collectives_count_their_bytes(ranked, n):
    """``all_reduce_`` and ``broadcast_`` write the tensor they are given
    and count the bytes as their copying forms do."""
    for p in ranked(n):
        same_r, reduced, same_b, broadcast, sent = p["in_place"]
        assert same_r and same_b
        assert reduced == [float(n * (n + 1) // 2)] * 5
        assert broadcast == [0.0] * 3
        assert sent == 5 * 4 * (n - 1) + (3 * 4 * (n - 1) if p["rank"] == 0
                                          else 0)


def test_four_ranks_match_the_jax_reference_loop(ranked, jax_ref):
    """The port on 4 ranks, from the reference's weights handed to rank 0,
    follows the reference's own data-parallel loop on a (4, 1) mesh:
    ``SyntheticTokens`` batches of 8 x 32 in 2 microbatches, lr 2e-3
    under the cosine schedule."""
    want = jax_ref[1]
    for part in ranked(4):
        np.testing.assert_allclose(part["jax"], want, rtol=JAX_RTOL)


def test_resume_over_two_ranks_from_rank_0s_checkpoint(ranked):
    """A checkpoint at step 2, written by rank 0 alone, resumed on both
    ranks and run to step 4, equals 4 uninterrupted steps."""
    for part in ranked(2):
        rec = part["resume"]
        assert rec["saves"] == ([2, 4] if part["rank"] == 0 else [])
        assert rec["first"] == [2] and rec["rest"] == [2, 4]
        assert rec["start"] == 2
        np.testing.assert_allclose(*rec["losses"], rtol=1e-6)
        got, want = rec["params"]
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=1e-7,
                                       err_msg=name)


@pytest.fixture(scope="module")
def host():
    mesh = M.make_host_mesh(device="cpu")
    yield mesh
    M.release_host_mesh()


def test_one_rank_train_run_is_the_meshless_path(host):
    """On the one-rank host mesh ``train.run`` is the path without a
    mesh, bitwise: losses, grad norms, parameters; its monitors hold one
    rank and its batch is not split."""
    runs = [train.run(_cfg(), STEPS, BATCH, SEQ, microbatches=2, lr=LR,
                      device="cpu", model=_model(1), mesh=mesh)
            for mesh in (None, host)]
    a, b = runs
    assert a.losses == b.losses and a.grad_norms == b.grad_norms
    pb = dict(b.model.named_parameters())
    for name, p in a.model.named_parameters():
        assert_bitwise(pb[name].detach(), p.detach(), name)
    assert b.health.num_ranks == b.stragglers.num_ranks == 1
    assert M.data_group(host) is None and M.data_rank(host) == 0
    batch = {"tokens": np.zeros((6, 2), np.int32)}
    assert not S.batch_splits(batch, host, 2)
    assert S.batch_share(batch, host, 2) is batch
