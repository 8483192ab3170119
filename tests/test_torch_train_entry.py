"""The port's train entry point (``launch.train.run``) against the
reference's training loop (``repro/launch/train.py``: its cosine schedule
and ``SyntheticTokens`` stream, without the mesh), on the CPU.

Tolerance: in float32 compute, each of 60 steps' losses within 1e-4
relative of the reference's: the per-step rounding of two float32
frameworks, compounded by 60 AdamW steps.  A resumed run is held to an
uninterrupted one within 1e-6 (the same framework; the checkpoint is
bitwise)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jopt
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data import SyntheticTokens as JaxTokens
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.optim.schedule import cosine_with_warmup as jax_cosine
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.launch import train


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


def _jax_train_loop_losses(jcfg, params, steps, batch, seq, lr):
    """The reference's training loop (``repro/launch/train.py``): its
    schedule and token stream, without the mesh."""
    ocfg = jopt.AdamWConfig(lr=lr)
    step = jax.jit(jsteps.build_train_step(
        jcfg, ocfg, schedule=lambda s: jax_cosine(
            s, warmup=10, total=steps * 10)))
    p = jax.tree.map(jnp.asarray, params)
    o = jopt.init(p, ocfg)
    src = JaxTokens(jcfg.vocab, seq, batch)
    out = []
    for i in range(steps):
        b = src.batch_at(i)
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(float(m["loss"]))
    return out


def test_train_entry_point_learns():
    """``train.run`` on Yi-6B's smoke config (bfloat16 compute, the
    port's seeded init), seq 32, batch 8, 60 steps at lr 2e-3: the mean
    of the last 10 losses at least 0.3 under the first 10's (as
    ``tests/test_system.py::test_training_loss_decreases_e2e``)."""
    res = train.run(smoke_config("yi_6b"), 60, 8, 32, lr=2e-3,
                    device="cpu")
    assert len(res.losses) == len(res.secs) == len(res.grad_norms) == 60
    assert np.mean(res.losses[-10:]) < np.mean(res.losses[:10]) - 0.3, \
        res.losses[::10]
    assert int(res.opt_state.step) == 60


def test_train_entry_point_matches_the_reference_loop():
    """In float32 compute from the reference's weights, ``train.run``'s
    60 losses follow the reference's training loop step for step."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"),
                               compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config("yi_6b"),
                               compute_dtype=torch.float32)
    params = _params(jcfg)
    want = _jax_train_loop_losses(jcfg, params, 60, 8, 32, 2e-3)
    res = train.run(tcfg, 60, 8, 32, lr=2e-3, device="cpu",
                    model=convert.train_model_from_numpy(tcfg, params, "cpu"))
    np.testing.assert_allclose(res.losses, want, rtol=1e-4)


def test_train_entry_point_resumes_from_its_checkpoint(tmp_path):
    """10 steps with a checkpoint every 5, then a run to 15 resumed from
    step 10 (continuing the token stream there) equals 15 uninterrupted
    steps; the checkpoints kept are the reference's ``keep`` of 3."""
    cfg = dataclasses.replace(smoke_config("yi_6b"),
                              compute_dtype=torch.float32)
    full = train.run(cfg, 15, 4, 16, device="cpu")
    first = train.run(cfg, 10, 4, 16, device="cpu", ckpt_dir=str(tmp_path),
                      ckpt_every=5)
    assert first.checkpoints == [5, 10]
    rest = train.run(cfg, 15, 4, 16, device="cpu", ckpt_dir=str(tmp_path),
                     ckpt_every=5, resume=True)
    assert rest.start_step == 10 and rest.checkpoints == [5, 10, 15]
    np.testing.assert_allclose(first.losses + rest.losses, full.losses,
                               rtol=1e-6)
    for (n, a), b in zip(rest.model.named_parameters(),
                         full.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
