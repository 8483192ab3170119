"""The port's ``CheckpointManager`` against ``repro.checkpoint``: the
same on-disk format, so a directory either package writes restores in
the other, bitwise; and training resumed across the two packages.

The resume test's tolerance: parameters within 1e-5 of each leaf's
largest magnitude after the port's 2 steps on the reference's 3 (float32
compute: two frameworks' rounding through 2 train steps of Yi-6B's
smoke config)."""
import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import convert, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import steps
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



def test_checkpoint_roundtrip_bf16_and_retention(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16) * 1.5,
                  "i": torch.tensor(7, dtype=torch.int32)}}
    for s in (1, 2, 3):
        cm.save(s, tree)
    assert cm.all_steps() == [2, 3]
    got, step = cm.restore(tree)
    assert step == 3
    for (k, x), (_, y) in zip(_flatten(got), _flatten(tree)):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["['b']['c']"] == {
        "file": "__b____c__.npy", "dtype": "bfloat16", "shape": [4]}
    assert np.load(tmp_path / "step_00000003" / "__b____c__.npy").dtype \
        == np.uint16


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"x": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000002.tmp")   # crashed writer
    assert cm.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"x": 0})


def test_keys_render_as_jax_keystr():
    """dicts (sorted), lists, tuples and NamedTuples render as
    ``jax.tree_util.keystr``; ``None`` holds no leaf."""
    tree = ({"b": [np.zeros(1), (np.zeros(2), None)], "a": np.ones(3)},
            optim.AdamWState({"w": np.zeros(1)}, {"w": np.zeros(1)},
                             np.zeros((), np.int32)))
    want = [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [k for k, _ in _flatten(tree)] == want
    assert want[0] == "[0]['a']" and want[-1] == "[1].step"


def _jax_state(moments=jnp.float32, steps_=1):
    """Yi-6B smoke ``(params, AdamWState)`` after ``steps_`` updates, so
    that the moments are not zero."""
    cfg = jax_smoke_config("yi_6b")
    ocfg = jopt.AdamWConfig(moment_dtype=moments)
    p = JT.init_params(cfg, jax.random.PRNGKey(0))
    o = jopt.init(p, ocfg)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, a.dtype), p)
    for _ in range(steps_):
        p, o, _ = jopt.update(g, o, p, ocfg)
    return p, o


def _assert_trees_bitwise(got, want):
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(k) for k, _ in gl] == \
        [jax.tree_util.keystr(k) for k, _ in wl]
    for (k, a), (_, b) in zip(gl, wl):
        a, b = _f32(a), _f32(b)
        assert a.dtype == b.dtype, jax.tree_util.keystr(k)
        assert_bitwise(a, b, jax.tree_util.keystr(k))


def _f32(a) -> np.ndarray:
    """A leaf as numpy, bfloat16 (torch's or ml_dtypes') as float32,
    which holds every bfloat16 value exactly."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, moments):
    """A ``(params, AdamWState)`` directory the reference writes loads
    into the port's trainable model and AdamW state, bitwise."""
    jdt = getattr(jnp, moments)
    p, o = _jax_state(jdt)
    JaxCheckpointManager(str(tmp_path)).save(1, (p, o))
    cfg = smoke_config("yi_6b")
    model = convert.train_model_from_numpy(
        cfg, jax.tree.map(np.asarray, JT.init_params(
            jax_smoke_config("yi_6b"), jax.random.PRNGKey(1))), "cpu")
    state = optim.init(model, optim.AdamWConfig(
        moment_dtype=getattr(torch, moments)))
    (params, ref_state), step = CheckpointManager(str(tmp_path)).restore(
        convert.train_state_tree(cfg, model, state))
    assert step == 1
    model = convert.train_model_from_numpy(cfg, params, "cpu")
    state = convert.adamw_state_from_numpy(cfg, model, ref_state, "cpu")
    got = convert.train_state_to_numpy(cfg, model, state)
    _assert_trees_bitwise(got, (jax.tree.map(np.asarray, p),
                                jax.tree.map(np.asarray, o)))
    assert all(m.dtype == getattr(torch, moments) for m in state.m.values())


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, moments):
    """A directory the port writes from its training state restores in
    ``repro.checkpoint`` into the reference's tree, bitwise."""
    jdt = getattr(jnp, moments)
    p, o = _jax_state(jdt, steps_=2)
    cfg = smoke_config("yi_6b")
    model = convert.train_model_from_numpy(cfg, jax.tree.map(np.asarray, p),
                                           "cpu")
    state = convert.adamw_state_from_numpy(
        cfg, model, jax.tree.map(np.asarray, o), "cpu")
    CheckpointManager(str(tmp_path)).save(
        2, convert.train_state_tree(cfg, model, state))
    tmpl = _jax_state(jdt, steps_=0)
    (jp, jo), step = JaxCheckpointManager(str(tmp_path)).restore(tmpl)
    assert step == 2 and jo.m["embed"].dtype == jdt
    _assert_trees_bitwise(jax.tree.map(np.asarray, (jp, jo)),
                          jax.tree.map(np.asarray, (p, o)))
    _assert_trees_bitwise(convert.adamw_state_to_numpy(cfg, state), o)


def test_resume_from_a_jax_checkpoint_matches_jax(tmp_path):
    """The reference trains Yi-6B's smoke config 3 steps and saves; the
    port restores and trains 2 more: the result equals the reference's
    5 uninterrupted steps."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config("yi_6b"),
                               compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
               for _ in range(5)]
    batches = [{"tokens": b[:, :-1].copy(), "labels": b[:, 1:].copy()}
               for b in batches]
    ocfg = jopt.AdamWConfig(lr=1e-3)
    jstep = jax.jit(jsteps.build_train_step(jcfg, ocfg))
    p = JT.init_params(jcfg, jax.random.PRNGKey(0))
    o = jopt.init(p, ocfg)
    for i, b in enumerate(batches):
        if i == 3:
            JaxCheckpointManager(str(tmp_path)).save(3, (p, o))
        p, o, _ = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()})

    model = convert.train_model_from_numpy(
        tcfg, jax.tree.map(np.asarray, JT.init_params(
            jcfg, jax.random.PRNGKey(7))), "cpu")
    tocfg = optim.AdamWConfig(lr=1e-3)
    state = optim.init(model, tocfg)
    (params, ref_state), step = CheckpointManager(str(tmp_path)).restore(
        convert.train_state_tree(tcfg, model, state))
    model = convert.train_model_from_numpy(tcfg, params, "cpu")
    state = convert.adamw_state_from_numpy(tcfg, model, ref_state, "cpu")
    tstep = steps.build_train_step(tcfg, tocfg)
    for b in batches[step:]:
        model, state, _ = tstep(model, state, {k: torch.from_numpy(v)
                                               for k, v in b.items()})
    assert int(state.step) == int(o.step) == 5
    got = convert.train_state_to_numpy(tcfg, model, state)
    for (k, a), b in zip(jax.tree_util.tree_flatten_with_path(got[0])[0],
                         jax.tree_util.tree_leaves(
                             jax.tree.map(np.asarray, p))):
        err = float(np.abs(a - b).max() / np.abs(b).max())
        assert err <= 1e-5, (jax.tree_util.keystr(k), err)


def test_train_state_resume_equivalence(tmp_path):
    """The reference's quadratic resume case on the port: save mid-way,
    restore, continue: identical to uninterrupted."""
    cfg = optim.AdamWConfig(lr=0.05, weight_decay=0.0)

    def fresh():
        return {"w": torch.tensor([2.0, -1.0])}

    def run(p, s, n):
        for _ in range(n):
            p, s, _ = optim.update({"w": 2 * p["w"]}, s, p, cfg)
        return p, s

    p_ref, _ = run(fresh(), optim.init(fresh(), cfg), 10)
    p = fresh()
    p, s = run(p, optim.init(p, cfg), 5)
    cm = CheckpointManager(str(tmp_path))
    cm.save(5, (p, s))
    (p, s), _ = cm.restore((p, s))
    p, s = run(p, s, 5)
    assert int(s.step) == 10
    assert torch.equal(p["w"], p_ref["w"])
