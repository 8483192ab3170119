"""The port's training forward and backward (``transformer.loss_fn``
on the trainable build, per-call casts, remat) against
``repro.models.transformer.loss_fn`` and ``jax.grad`` at all ten smoke
configs, on the CPU.

Each test takes the JAX ``init_params(PRNGKey(0))`` tree, turns it into
the port's trainable model with ``convert.train_model_from_numpy`` and
feeds both the same seeded numpy batch (a quarter of the labels masked
with -1; the VLM's patch embeddings at half the positions).  Compute is
float32, MoE capacity raised so that no token drops (as
``tests/test_archs_smoke.py:56-70``).  Tolerances: the loss within
1e-5 relative; each gradient leaf within 1e-4 of its largest magnitude
(two frameworks' float32 matmuls, softmax and transcendental functions
summed in different orders through two layers and the backward pass;
the recurrent kinds step their float32 recurrences one by one)."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import ARCH_IDS, smoke_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _configs(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(smoke_config(arch),
                               compute_dtype=torch.float32, **kw)
    if tcfg.moe is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=jcfg.moe._replace(capacity_factor=8.0))
        tcfg = dataclasses.replace(
            tcfg, moe=tcfg.moe._replace(capacity_factor=8.0))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, tie=False):
    cfg = dataclasses.replace(jax_smoke_config(arch), tie_embeddings=tie)
    return jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))


def _batches(cfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.25] = -1
    host = {"tokens": tokens, "labels": labels}
    if cfg.vlm:
        host["vision_embeds"] = (rng.standard_normal(
            (B, S, cfg.d_model)) * 0.02).astype(np.float32)
        host["vision_mask"] = rng.random((B, S)) < 0.5
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v) for k, v in host.items()})


def _jax_loss_and_grads(jcfg, params, jb):
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, jb), has_aux=True))(
            jax.tree.map(jnp.asarray, params))
    return loss, aux, jax.tree.map(np.asarray, grads)


def _port_grads(tcfg, model) -> dict:
    """The model's ``.grad`` tensors in the reference's tree layout."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    return convert._map(convert._np, convert._ref_tree(tcfg, grads))


def _assert_grads_close(want, got, arch):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(k) for k, _ in wl] == \
        [jax.tree_util.keystr(k) for k, _ in gl], arch
    for (k, w), (_, g) in zip(wl, gl):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g, np.float32) - w).max()) / scale
        assert err <= GRAD_TOL, (arch, jax.tree_util.keystr(k), err)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    params = _jax_params(arch)
    jb, tb = _batches(tcfg)
    want, want_aux, want_grads = _jax_loss_and_grads(jcfg, params, jb)
    model = convert.train_model_from_numpy(tcfg, params, "cpu")
    loss, aux = T.loss_fn(tcfg, model, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ce"].detach()), float(want_aux["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["aux"].detach()), float(want_aux["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    assert (float(aux["aux"].detach()) > 0) == (tcfg.moe is not None)
    _assert_grads_close(want_grads, _port_grads(tcfg, model), arch)


def test_tied_embeddings_train_through_embed():
    """With tied embeddings the trainable model has no ``unembed``: the
    head reads ``embed.t()`` on each call, so ``embed``'s gradient sums
    the lookup's and the head's, as the reference's does."""
    jcfg, tcfg = _configs("yi_6b", tie_embeddings=True)
    params = _jax_params("yi_6b", tie=True)
    jb, tb = _batches(tcfg)
    want, _, want_grads = _jax_loss_and_grads(jcfg, params, jb)
    model = convert.train_model_from_numpy(tcfg, params, "cpu")
    assert model.unembed is None
    loss, _ = T.loss_fn(tcfg, model, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=LOSS_RTOL)
    _assert_grads_close(want_grads, _port_grads(tcfg, model), "tied")


def test_trainable_build_keeps_master_weights():
    """The trainable build holds ``param_dtype`` parameters that take a
    gradient and casts them on each call: gradients land in float32 while
    the layers compute in bfloat16.  The serving build is cast once and
    takes none, and both give the same logits."""
    cfg = smoke_config("yi_6b")
    params = _jax_params("yi_6b")
    train = convert.train_model_from_numpy(cfg, params, "cpu")
    serve = convert.model_from_numpy(cfg, params, "cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    assert not any(p.requires_grad for p in serve.parameters())
    assert serve.layers[0].attn.p["wq"].dtype == torch.bfloat16
    _, tb = _batches(cfg)
    with torch.no_grad():
        a, _, _ = T.forward(cfg, train, tb)
        b, _, _ = T.forward(cfg, serve, tb)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    loss, _ = T.loss_fn(cfg, train, tb)
    loss.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in train.parameters())


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_7b", "recurrentgemma_2b"])
def test_remat_recomputes_without_changing_values(arch, monkeypatch):
    """Each layer, each attention query chunk and each ``chunked_scan``
    chunk runs under ``torch.utils.checkpoint`` when autograd records
    it, and the gradients equal those of the same pass without it, bit
    for bit; a call that records no graph checkpoints nothing."""
    _, tcfg = _configs(arch)
    params = _jax_params(arch)
    _, tb = _batches(tcfg)
    calls = []
    real = L._checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    def grads(**patch):
        for k, v in patch.items():
            monkeypatch.setattr(L, k, v)
        model = convert.train_model_from_numpy(tcfg, params, "cpu")
        loss, _ = T.loss_fn(tcfg, model, tb)
        forward = list(calls)     # the backward pass recomputes again
        loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}, forward

    with_remat, seen = grads(_checkpoint=counting)
    kinds = tcfg.layer_kinds()
    assert seen.count("_layer_call") == len(kinds)
    n_attn = sum(k.startswith("attn") for k in kinds)
    assert seen.count("chunk_fn") == n_attn * (S // min(tcfg.chunk_q, S))
    assert ("run_chunk" in seen) == any(k in ("rwkv", "rec") for k in kinds)
    without, _ = grads(remat=lambda fn, *args: fn(*args))
    for n, g in with_remat.items():
        assert torch.equal(g, without[n]), n
    calls.clear()
    monkeypatch.setattr(L, "_checkpoint", counting)
    model = convert.model_from_numpy(tcfg, params, "cpu")
    T.forward(tcfg, model, tb)
    assert calls == []
