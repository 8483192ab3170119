"""The port's decoder stack against ``repro.models.transformer`` for all
ten architectures at their smoke widths, on the CPU: the dense kinds,
MoE (Mixtral, Kimi-K2), RWKV6 and RG-LRU (RecurrentGemma).

Each test takes the JAX ``init_params(PRNGKey(0))`` tree, turns it into
the port's model with ``convert.model_from_numpy`` and feeds both the
same seeded numpy tokens.  Compute is float32 unless stated; the
tolerance is 1e-4 absolute and relative on logits of magnitude about 1
(two layers of float32 matmuls, softmax and transcendental functions
rounded by two frameworks; the port's decode also scales q by
multiplying where the reference's jnp branch divides; the recurrent
kinds run their float32 recurrences step by step).  One bfloat16
configuration is held at 3e-2 of the largest logit: the port and XLA
round bfloat16 intermediates at different points, one bf16 ulp being
3.9e-3 relative."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import (ARCH_IDS, PORTED, get_config,
                                         smoke_config)
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16


def _configs(arch, compute="float32", no_drops=False):
    """The smoke configs of both packages in ``compute``; ``no_drops``
    raises the MoE capacity so that no token is dropped, for comparing
    decode with forward (``test_archs_smoke.py::test_decode_matches_
    forward``): a forward pass plans over B x T tokens, a decode step
    over B."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    jcfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype=jdt)
    tcfg = dataclasses.replace(smoke_config(arch), compute_dtype=tdt)
    if no_drops and tcfg.moe is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=jcfg.moe._replace(capacity_factor=8.0))
        tcfg = dataclasses.replace(
            tcfg, moe=tcfg.moe._replace(capacity_factor=8.0))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jax_smoke_config(arch)
    return jax.tree.map(np.asarray, JT.init_params(cfg, jax.random.PRNGKey(0)))


def _tokens(cfg, t=S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, t)).astype(np.int32)


def _batches(cfg, tokens):
    jb, tb = {"tokens": jnp.asarray(tokens)}, \
        {"tokens": torch.from_numpy(tokens)}
    if cfg.vlm:   # patch embeddings merged at half the positions
        rng = np.random.default_rng(2)
        emb = (rng.standard_normal(tokens.shape + (cfg.d_model,)) * 0.02) \
            .astype(np.float32)
        mask = rng.random(tokens.shape) < 0.5
        jb.update(vision_embeds=jnp.asarray(emb), vision_mask=jnp.asarray(mask))
        tb.update(vision_embeds=torch.from_numpy(emb),
                  vision_mask=torch.from_numpy(mask))
    return jb, tb


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def test_smoke_configs_are_copies():
    """Every config, full and smoke, is the reference's field for field
    (the MoE, RWKV and RG-LRU sub-configs too), dtypes mapped."""
    assert PORTED == ARCH_IDS
    for arch in PORTED:
        for jget, tget in ((jax_smoke_config, smoke_config),
                           (jax_get_config, get_config)):
            j, t = jget(arch), tget(arch)
            jd = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
            td = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
            dtypes = {jnp.float32: torch.float32,
                      jnp.bfloat16: torch.bfloat16}
            for k in ("param_dtype", "compute_dtype"):
                assert dtypes[jd.pop(k)] == td.pop(k)
            assert jd == td, arch
            for k in ("moe", "rwkv", "rglru"):
                assert (jd[k] is None) == (td[k] is None), (arch, k)
                if td[k] is not None:
                    assert jd[k]._asdict() == td[k]._asdict(), (arch, k)
            assert t.stacks() == j.stacks()


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    model = convert.model_from_numpy(tcfg, _jax_params(arch), "cpu")
    jb, tb = _batches(tcfg, _tokens(tcfg))
    want, want_aux, _ = JT.forward(jcfg, _jax_params(arch), jb)
    got, aux, _ = T.forward(tcfg, model, tb)
    assert got.shape == (B, S, tcfg.vocab)
    assert (float(aux) > 0) == (tcfg.moe is not None)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_steps_match_jax_and_forward(arch):
    """16 decode steps: logits and caches (recurrent states too) equal
    JAX's; the port's decode equals its own forward (rel < 2e-4, as
    ``test_archs_smoke.py``)."""
    jcfg, tcfg = _configs(arch, no_drops=True)
    params = _jax_params(arch)
    model = convert.model_from_numpy(tcfg, params, "cpu")
    tokens = _tokens(tcfg)
    jstep = jax.jit(functools.partial(JT.decode_step, jcfg))
    jc = JT.init_caches(jcfg, B, S)
    tc = T.init_caches(tcfg, B, S, "cpu")
    jl = jnp.zeros((B,), jnp.int32)
    tl = torch.zeros((B,), dtype=torch.int32)
    full, _, _ = T.forward(tcfg, model, {"tokens": torch.from_numpy(tokens)})
    errs = []
    for t in range(S):
        want, jc, jl = jstep(params, jnp.asarray(tokens[:, t:t + 1]), jc, jl)
        got, tc, tl = T.decode_step(tcfg, model,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    tc, tl)
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"step {t} logits")
        errs.append(float((got - full[:, t]).abs().max()))
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(
                        convert.caches_to_numpy(tcfg, tc))):
        np.testing.assert_allclose(b, _np(a), **TOL)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert max(errs) / float(full.abs().max()) < 2e-4


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("arch", ["yi_6b", "qwen2_vl_7b", "musicgen_large",
                                  "recurrentgemma_2b", "rwkv6_7b",
                                  "mixtral_8x7b"])
def test_prefill_then_decode(arch):
    """Prefill equals forward's last row and JAX's prefill, its caches
    continue decoding (``test_archs_smoke.py::test_prefill_then_decode``),
    recurrent states pass through unpadded, and caches round-trip
    through the reference's layout."""
    jcfg, tcfg = _configs(arch, no_drops=True)
    params = _jax_params(arch)
    model = convert.model_from_numpy(tcfg, params, "cpu")
    tokens = _tokens(tcfg, S + 1)
    head = {"tokens": torch.from_numpy(tokens[:, :S])}
    full, _, _ = T.forward(tcfg, model, head)
    last, caches = T.prefill(tcfg, model, head, pad_cache_to=S + 4)
    np.testing.assert_allclose(_np(last), _np(full[:, -1]), rtol=1e-5,
                               atol=1e-5)
    jlast, jcaches = JT.prefill(jcfg, params,
                                {"tokens": jnp.asarray(tokens[:, :S])},
                                pad_cache_to=S + 4)
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jcaches),
                    jax.tree_util.tree_leaves(
                        convert.caches_to_numpy(tcfg, caches))):
        np.testing.assert_allclose(b, _np(a), **TOL)
    for kind, c in zip(tcfg.layer_kinds(), caches):
        if kind == "rec":
            assert c["rec"]["h"].shape == (B, tcfg.rglru.d_rnn)
        elif kind == "rwkv":
            assert c["cmix"].shape == (B, tcfg.d_model)
        else:
            assert c["k"].shape[1] == min(S + 4, tcfg.window or S + 4)
    back = convert.caches_from_numpy(tcfg, convert.caches_to_numpy(
        tcfg, caches), "cpu")
    assert all(_tree_equal(x, y) for x, y in zip(back, caches))
    lg, caches, lengths = T.decode_step(
        tcfg, model, torch.from_numpy(tokens[:, S:S + 1]), caches,
        torch.full((B,), S, dtype=torch.int32))
    full2, _, _ = T.forward(tcfg, model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(lg), _np(full2[:, -1]), **TOL)


def test_prefill_step_and_tied_embeddings_match_jax():
    """``build_prefill_step`` returns the reference's prefill, and a
    config with tied embeddings unembeds by the embedding's transpose."""
    from repro.launch import steps as jax_steps
    from repro_torch.launch import steps
    jcfg, tcfg = _configs("yi_6b")
    jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
    tcfg = dataclasses.replace(tcfg, tie_embeddings=True)
    params = jax.tree.map(np.asarray,
                          JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert "unembed" not in params
    model = convert.model_from_numpy(tcfg, params, "cpu")
    assert T.param_count(tcfg, model) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))
    tokens = _tokens(tcfg)
    want, wc = jax_steps.build_prefill_step(jcfg)(
        params, {"tokens": jnp.asarray(tokens)})
    got, gc = steps.build_prefill_step(tcfg)(
        model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(wc),
                    jax.tree_util.tree_leaves(convert.caches_to_numpy(tcfg,
                                                                      gc))):
        np.testing.assert_allclose(b, _np(a), **TOL)


def test_prefill_window_ring_order():
    """A window smaller than the prompt keeps the last ``window`` tokens
    in ring order, as the reference's ``prefill``."""
    jcfg, tcfg = _configs("yi_6b")
    jcfg = dataclasses.replace(jcfg, window=6)
    tcfg = dataclasses.replace(tcfg, window=6)
    params = _jax_params("yi_6b")
    model = convert.model_from_numpy(tcfg, params, "cpu")
    tokens = _tokens(tcfg)
    _, jc = JT.prefill(jcfg, params, {"tokens": jnp.asarray(tokens)},
                       pad_cache_to=S + 4)
    _, tc = T.prefill(tcfg, model, {"tokens": torch.from_numpy(tokens)},
                      pad_cache_to=S + 4)
    assert tc[0]["k"].shape[1] == 6
    for a, b in zip(jax.tree_util.tree_leaves(jc),
                    jax.tree_util.tree_leaves(convert.caches_to_numpy(tcfg,
                                                                      tc))):
        np.testing.assert_allclose(b, _np(a), **TOL)


def test_bfloat16_compute_matches_jax():
    """Yi-6B smoke in bfloat16 compute, float32 params: forward and 8
    decode steps within 3e-2 of the largest logit."""
    jcfg, tcfg = _configs("yi_6b", "bfloat16")
    params = _jax_params("yi_6b")
    model = convert.model_from_numpy(tcfg, params, "cpu")
    assert model.layers[0].attn.p["wq"].dtype == torch.bfloat16
    assert model.embed.dtype == torch.float32
    assert model.final_norm["scale"].dtype == torch.float32
    tokens = _tokens(tcfg)
    want, _, _ = JT.forward(jcfg, params, {"tokens": jnp.asarray(tokens)})
    got, _, _ = T.forward(tcfg, model, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=3e-2 * scale)
    jc, tc = JT.init_caches(jcfg, B, 8), T.init_caches(tcfg, B, 8, "cpu")
    jl, tl = jnp.zeros((B,), jnp.int32), torch.zeros((B,), dtype=torch.int32)
    for t in range(8):
        w, jc, jl = JT.decode_step(jcfg, params, jnp.asarray(tokens[:, t:t + 1]),
                                   jc, jl)
        g, tc, tl = T.decode_step(tcfg, model,
                                  torch.from_numpy(tokens[:, t:t + 1]), tc, tl)
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=3e-2 * scale,
                                   err_msg=f"step {t}")
    # the reference's bfloat16 caches, converted, against the port's
    back = convert.caches_from_numpy(tcfg, jax.tree.map(np.asarray, jc), "cpu")
    for x, y in zip(back, tc):
        for k in ("k", "v"):
            assert x[k].dtype == torch.bfloat16
            np.testing.assert_allclose(_np(x[k]), _np(y[k]), rtol=0,
                                       atol=3e-2 * float(y[k].abs().max()))


def test_full_config_param_counts_on_meta():
    """The ten full configs land in the reference's nameplate ranges
    (``test_full_configs_param_counts``), from shapes on the meta device,
    and equal the reference's count exactly."""
    expected = {"yi_6b": (5.5e9, 7.5e9), "yi_34b": (33e9, 36e9),
                "qwen2_72b": (70e9, 75e9), "mixtral_8x7b": (45e9, 48e9),
                "kimi_k2_1t_a32b": (0.95e12, 1.15e12),
                "rwkv6_7b": (6.5e9, 8.5e9), "nemotron_4_15b": (14e9, 17e9),
                "recurrentgemma_2b": (2.3e9, 3.6e9),
                "musicgen_large": (1.4e9, 2.6e9), "qwen2_vl_7b": (7e9, 9e9)}
    assert set(expected) == set(PORTED)
    for arch, (lo, hi) in expected.items():
        cfg = get_config(arch)
        model = T.init_params(cfg, device="meta")
        assert next(model.parameters()).device.type == "meta"
        n = T.param_count(cfg, model)
        assert lo <= n <= hi, (arch, f"{n:.3e}")
        jcfg = jax_get_config(arch)
        shapes = jax.eval_shape(
            lambda c=jcfg: JT.init_params(c, jax.random.PRNGKey(0)))
        assert n == sum(int(np.prod(a.shape))
                        for a in jax.tree_util.tree_leaves(shapes)), arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_param_count_matches_jax(arch):
    """Active parameters a token at full size, on the meta device, equal
    the reference's ``active_param_count`` of ``jax.eval_shape``'s tree:
    the MoE configs count top_k of their routed experts, the others all
    of their parameters."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model = T.init_params(cfg, device="meta")
    shapes = jax.eval_shape(
        lambda c=jcfg: JT.init_params(c, jax.random.PRNGKey(0)))
    got = T.active_param_count(cfg, model)
    assert got == JT.active_param_count(jcfg, shapes)
    assert (got < T.param_count(cfg, model)) == (cfg.ffn == "moe")
    if arch == "kimi_k2_1t_a32b":      # the "A32B" of its name
        assert 25e9 < got < 40e9, f"{got:.3e}"


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "recurrentgemma_2b"])
def test_sliding_window_ring_cache(arch):
    """Decode through a ring cache of 8 rows, smaller than the 16-token
    sequence, equals the windowed forward and the reference's decode
    (``test_archs_smoke.py::test_sliding_window_ring_cache``; Mixtral
    SWA, RecurrentGemma local attention)."""
    jcfg, tcfg = _configs(arch, no_drops=True)
    jcfg = dataclasses.replace(jcfg, window=8)
    tcfg = dataclasses.replace(tcfg, window=8)
    params = _jax_params(arch)
    model = convert.model_from_numpy(tcfg, params, "cpu")
    tokens = _tokens(tcfg)
    full, _, _ = T.forward(tcfg, model, {"tokens": torch.from_numpy(tokens)})
    jc, tc = JT.init_caches(jcfg, B, S), T.init_caches(tcfg, B, S, "cpu")
    attn = [c for kind, c in zip(tcfg.layer_kinds(), tc)
            if kind.startswith("attn")]
    assert attn and all(c["k"].shape[1] == 8 for c in attn)
    jl, tl = jnp.zeros((B,), jnp.int32), torch.zeros((B,), dtype=torch.int32)
    for t in range(S):
        want, jc, jl = JT.decode_step(jcfg, params,
                                      jnp.asarray(tokens[:, t:t + 1]), jc, jl)
        got, tc, tl = T.decode_step(tcfg, model,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    tc, tl)
        assert float((got - full[:, t]).abs().max()) < 1e-4, t
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_7b", "recurrentgemma_2b",
                                  "kimi_k2_1t_a32b"])
def test_caches_round_trip_through_the_reference_layout(arch):
    """The reference's decode caches after 5 steps (every kind's state
    nonzero) -> the port's -> the reference's layout: the same tree,
    bitwise."""
    jcfg, tcfg = _configs(arch)
    params = _jax_params(arch)
    tokens = _tokens(tcfg)
    jc, jl = JT.init_caches(jcfg, B, 8), jnp.zeros((B,), jnp.int32)
    for t in range(5):
        _, jc, jl = JT.decode_step(jcfg, params,
                                   jnp.asarray(tokens[:, t:t + 1]), jc, jl)
    ref = jax.tree.map(np.asarray, jc)
    back = convert.caches_to_numpy(tcfg, convert.caches_from_numpy(
        tcfg, ref, "cpu"))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and float(np.abs(a).max()) > 0
        np.testing.assert_array_equal(a, b)
