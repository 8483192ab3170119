"""The port's train step (``launch.steps.build_train_step``) and
``runtime.overlap.microbatched_grads`` against the JAX package, on the
CPU (the entry point ``launch.train.run``: ``test_torch_train_entry.py``).

Tolerances, each stated where it is used:

* the train step at each config's own compute dtype (bfloat16 but for
  none): the loss falls over two steps on a repeated batch (as
  ``tests/test_archs_smoke.py::test_smoke_train_step``), and each
  step's loss is within 3e-2 relative of the reference's -- the
  bfloat16 tolerance of ``tests/test_torch_transformer.py``: the port
  and XLA round bfloat16 intermediates at different points;
* microbatched gradients, float32: the loss within 1e-6 relative and
  the gradients within 1e-5 (the reference's
  ``test_microbatched_grads_match_full``), each against JAX at the same
  K and against the port's K = 1: relative for the linear regression,
  of each leaf's largest magnitude at Yi-6B's smoke config (K = 2),
  whose leaves hold values near 0.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jopt
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.runtime import microbatched_grads as jax_microbatched_grads
from repro_torch import convert, optim
from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.runtime import microbatched_grads

BF16_RTOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _params(jcfg):
    return jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch(cfg, b=2, s=32, seed=1):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)
    host = {"tokens": tokens, "labels": tokens}
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    tb = {k: torch.from_numpy(v) for k, v in host.items()}
    if cfg.vlm:
        jb["vision_embeds"] = jnp.zeros((b, s, cfg.d_model), jnp.bfloat16)
        jb["vision_mask"] = jnp.zeros((b, s), bool)
        tb["vision_embeds"] = torch.zeros((b, s, cfg.d_model),
                                          dtype=torch.bfloat16)
        tb["vision_mask"] = torch.zeros((b, s), dtype=torch.bool)
    return jb, tb


def _two_steps(jcfg, tcfg, k=1):
    """Two train steps on one batch on each side, from the same
    weights: (JAX losses, port losses, the port's final state)."""
    params = _params(jcfg)
    jb, tb = _batch(tcfg)
    jstep = jax.jit(jsteps.build_train_step(
        jcfg, jopt.AdamWConfig(
            lr=1e-3, moment_dtype=jnp.bfloat16
            if jcfg.param_dtype == jnp.bfloat16 else jnp.float32),
        num_microbatches=k))
    p = jax.tree.map(jnp.asarray, params)
    o = jopt.init(p, jopt.AdamWConfig(moment_dtype=jnp.bfloat16
                                      if jcfg.param_dtype == jnp.bfloat16
                                      else jnp.float32))
    want = []
    for _ in range(2):
        p, o, m = jstep(p, o, jb)
        want.append(float(m["loss"]))
    model = convert.train_model_from_numpy(tcfg, params, "cpu")
    ocfg = optim.AdamWConfig(lr=1e-3, moment_dtype=tcfg.param_dtype)
    st = optim.init(model, ocfg)
    step = steps.build_train_step(tcfg, ocfg, num_microbatches=k)
    got = []
    for _ in range(2):
        model, st, m = step(model, st, tb)
        got.append(float(m["loss"]))
        assert set(m) == {"loss", "grad_norm", "ce", "aux"}
        assert all(isinstance(v, torch.Tensor) for v in m.values())
    return want, got, (model, st)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_two_train_steps_lower_the_loss_as_jax(arch):
    jcfg, tcfg = jax_smoke_config(arch), smoke_config(arch)
    want, got, (model, st) = _two_steps(jcfg, tcfg)
    assert np.isfinite(got).all()
    assert got[1] < got[0]                 # same batch: must improve
    assert int(st.step) == 2
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL)
    assert all(p.grad is None for p in model.parameters())


def test_bf16_params_take_bf16_moments():
    """With bfloat16 parameters (Kimi-K2's ``param_dtype``) the train
    step keeps bfloat16 moments and, over 2 microbatches, sums the
    gradients in float32 beside the parameters, as the reference."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"),
                               param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(smoke_config("yi_6b"),
                               param_dtype=torch.bfloat16)
    want, got, (model, st) = _two_steps(jcfg, tcfg, k=2)
    assert got[1] < got[0]
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert all(m.dtype == torch.bfloat16 for m in st.m.values())
    default = steps.build_train_step(tcfg)
    model2 = convert.train_model_from_numpy(tcfg, _params(jcfg), "cpu")
    st2 = optim.init(model2, optim.AdamWConfig(moment_dtype=torch.bfloat16))
    _, tb = _batch(tcfg)
    default(model2, st2, tb)        # the default config's moment dtype
    assert all(m.dtype == torch.bfloat16 for m in st2.m.values())


@pytest.mark.parametrize("k", [1, 4])
def test_microbatched_grads_linear_regression(k):
    """The reference's linear-regression case, at K = 1 and 4, against
    JAX at the same K and against the port's K = 1."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 2)).astype(np.float32)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    y = rng.standard_normal((8, 2)).astype(np.float32)

    def jlf(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}

    jl, _, jg = jax_microbatched_grads(
        jlf, {"w": jnp.asarray(w)}, {"x": jnp.asarray(x),
                                     "y": jnp.asarray(y)}, k)

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))

    def tlf(m, b):
        return torch.mean((b["x"] @ m.w - b["y"]) ** 2), {}

    model = Lin()
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    tl, _, tg = microbatched_grads(tlf, model, batch, k)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-5)
    l1, _, g1 = microbatched_grads(tlf, Lin(), batch, 1)
    np.testing.assert_allclose(float(tl), float(l1), rtol=1e-6)
    np.testing.assert_allclose(tg["w"].numpy(), g1["w"].numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="not a multiple of 3"):
        microbatched_grads(tlf, Lin(), batch, 3)


def test_microbatched_grads_yi_smoke_k2():
    """Yi-6B's smoke config in float32 at K = 2: the loss, the last aux
    and every gradient against the reference's scan, and against the
    port's K = 1."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config("yi_6b"),
                               compute_dtype=torch.float32)
    params = _params(jcfg)
    jb, tb = _batch(tcfg, b=4)
    jl, jaux, jg = jax_microbatched_grads(
        lambda p, b: JT.loss_fn(jcfg, p, b),
        jax.tree.map(jnp.asarray, params), jb, 2)

    def lf(m, b):
        return T.loss_fn(tcfg, m, b)

    model = convert.train_model_from_numpy(tcfg, params, "cpu")
    tl, taux, tg = microbatched_grads(lf, model, tb, 2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-6)
    got = convert._map(convert._np, convert._ref_tree(tcfg, tg))
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jg)), jax.tree_util.tree_leaves(got)):
        _assert_within(b, a, jax.tree_util.keystr(k))
    l1, _, g1 = microbatched_grads(
        lf, convert.train_model_from_numpy(tcfg, params, "cpu"), tb, 1)
    np.testing.assert_allclose(float(tl), float(l1), rtol=1e-6)
    for n, g in tg.items():
        _assert_within(g.numpy(), g1[n].numpy(), n)


def _assert_within(got, want, what, tol=1e-5):
    """``got`` within ``tol`` of ``want``'s largest magnitude: a model's
    gradient leaf holds values near 0, whose last bits two summation
    orders set differently."""
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, (what, err)
