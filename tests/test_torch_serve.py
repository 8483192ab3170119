"""``repro_torch.launch.serve.run`` at smoke size on the CPU: the decode
step resolves through the AR function registry, and the tokens it
generates -- prompts decoded teacher-forced, then greedy argmax -- are
the JAX serving loop's (``repro.launch.serve``, as
``tests/test_system.py::test_generation_via_ar_registry`` drives it) on
the same converted weights and prompts, for the dense, MoE, RWKV6 and
RG-LRU families.  Compute is float32, so that no bfloat16 rounding can
flip an argmax."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import profiles as JP
from repro.core import serverless as jax_serverless
from repro.launch import steps as jax_steps
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]


def _jax_generate(cfg, params, prompts: np.ndarray, tokens: int):
    reg = jax_serverless.FunctionRegistry()
    reg.store_function("decode", JP.profile("serve", cfg.name),
                       jax_steps.build_serve_step(cfg))
    [(_, fn)] = reg.start_function(JP.ProfileBuilder().add_single("serve")
                                   .build())
    fn = jax.jit(fn)
    b, plen = prompts.shape
    caches = JT.init_caches(cfg, b, plen + tokens)
    lengths = jnp.zeros((b,), jnp.int32)
    for t in range(plen):
        logits, caches, lengths = fn(params, jnp.asarray(prompts[:, t:t + 1]),
                                     caches, lengths)
    gen = []
    for _ in range(tokens):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        gen.append(np.asarray(nxt))
        logits, caches, lengths = fn(params, nxt, caches, lengths)
    return np.concatenate(gen, 1), np.asarray(logits)


@pytest.mark.parametrize("arch", ["yi_6b", "musicgen_large", "qwen2_vl_7b",
                                  "recurrentgemma_2b", "rwkv6_7b",
                                  "mixtral_8x7b", "kimi_k2_1t_a32b"])
def test_serve_generates_the_jax_tokens(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config(arch),
                               compute_dtype=torch.float32)
    params = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    model = convert.model_from_numpy(tcfg, params, "cpu")
    b, plen, ntok = 3, 6, 10
    res = serve.run(tcfg, b, plen, ntok, device="cpu", model=model)
    assert res.resolved == f"decode:{tcfg.name}"
    assert res.tokens.shape == (b, ntok) and res.finite
    # the plain version attends on the CPU: no kernel launch, whatever
    # the model's attention layers
    assert len(res.secs) == plen + ntok and res.launches == 0
    assert torch.equal(res.lengths, torch.full((b,), plen + ntok,
                                               dtype=torch.int32))
    want, logits = _jax_generate(jcfg, params,
                                 serve.prompts_for(tcfg, b, plen), ntok)
    np.testing.assert_array_equal(res.tokens, want)
    np.testing.assert_allclose(res.logits.numpy(), logits, rtol=1e-4,
                               atol=1e-4)


def test_serve_default_init_is_seeded():
    cfg = dataclasses.replace(smoke_config("yi_6b"),
                              compute_dtype=torch.float32)
    a = serve.run(cfg, 2, 4, 4, device="cpu", seed=3)
    b = serve.run(cfg, 2, 4, 4, device="cpu", seed=3)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert ((a.tokens >= 0) & (a.tokens < cfg.vocab)).all()


def test_serve_entry_point_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi_6b",
         "--smoke", "--requests", "2", "--prompt-len", "3", "--tokens", "4",
         "--device", "cpu"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "resolved decode:yi-6b-smoke via AR profile" in r.stdout
    assert "generated (2, 4) tokens" in r.stdout


def test_serve_entry_point_runs_recurrentgemma_on_the_cpu():
    """The README's command: RecurrentGemma-2B's smoke config, 20 steps
    through a ring cache of 16 rows (its smoke window)."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "recurrentgemma_2b", "--smoke", "--requests", "2", "--prompt-len",
         "12", "--tokens", "8", "--device", "cpu"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "resolved decode:recurrentgemma-2b-smoke via AR profile" \
        in r.stdout
    assert "generated (2, 8) tokens" in r.stdout
