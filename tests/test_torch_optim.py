"""The port's optimizer (``repro_torch.optim``: AdamW and the cosine
schedule) against ``repro.optim``, on the CPU, from the same seeded
numpy parameters and gradients.

Tolerances: the schedule within 1e-6 (float32 on both sides); each
AdamW leaf (parameter, first and second moment) within 1e-6 of its
largest magnitude after every step (the bias corrections' ``b ** step``
and the square roots are rounded by two math libraries, and the clip
scale follows the norm's rounding; a moment's elements near 0 carry
those last bits as large relative differences);
the global norm within 1e-6 relative (the port sums the leaves in the
parameters' order, the reference in ``jax.tree_util``'s sorted-key
order)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim

SHAPES = {"w": (4, 3), "b": (3,), "emb": (8, 4)}


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("step", [0, 5, 10, 50, 100])
def test_schedule_matches_jax(step):
    want = jopt.cosine_with_warmup(jnp.asarray(step), warmup=10, total=100)
    got = optim.cosine_with_warmup(torch.tensor(step), warmup=10, total=100)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def _run(jcfg, tcfg, grad_scale=1.0, steps=4, dtype=np.float32,
         lr_scale=None):
    """``steps`` updates on both sides with the same gradients; checks
    every leaf, moment and norm after each step."""
    p0 = _leaves(0)
    jp = {k: jnp.asarray(v).astype(dtype) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, np.dtype(dtype).name
                                            if dtype != "bfloat16"
                                            else "bfloat16"))
          for k, v in p0.items()}
    js, ts = jopt.init(jp, jcfg), optim.init(tp, tcfg)
    for i in range(steps):
        g = _leaves(100 + i, grad_scale)
        jscale = 1.0 if lr_scale is None else lr_scale(js.step)
        tscale = 1.0 if lr_scale is None else \
            torch.tensor(float(lr_scale(js.step)), dtype=torch.float32)
        jp, js, jm = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp, jcfg, jscale)
        tp, ts, tm = optim.update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, tp, tcfg,
                                  tscale)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for k in SHAPES:
            for a, b in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                         (ts.v[k], js.v[k])):
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
                a, b = a.float().numpy(), np.asarray(b, np.float32)
                err = float(np.abs(a - b).max() / np.abs(b).max())
                assert err <= 1e-6, (i, k, err)
        assert int(ts.step) == int(js.step) == i + 1
    return tp, tm


def test_adamw_update_matches_jax():
    _run(jopt.AdamWConfig(), optim.AdamWConfig())


def test_adamw_with_schedule_matches_jax():
    def sched(s):
        return jopt.cosine_with_warmup(s, warmup=2, total=8)
    _run(jopt.AdamWConfig(lr=1e-2), optim.AdamWConfig(lr=1e-2),
         lr_scale=sched, steps=6)


def test_adamw_clip_matches_jax():
    """Gradients far above ``clip_norm``: the clip scale binds."""
    _, m = _run(jopt.AdamWConfig(lr=1.0, clip_norm=1e-3),
                optim.AdamWConfig(lr=1.0, clip_norm=1e-3), grad_scale=1e6)
    assert float(m["grad_norm"]) > 1e5


def test_adamw_bf16_moments_match_jax():
    """bfloat16 parameters and moments (Kimi-K2's): the moments are
    kept in bfloat16, the update computed in float32 from the unrounded
    moments, the parameters cast back."""
    _run(jopt.AdamWConfig(moment_dtype=jnp.bfloat16),
         optim.AdamWConfig(moment_dtype=torch.bfloat16), dtype="bfloat16")


def test_adamw_descends_quadratic():
    """The reference's quadratic descent, in place on a module."""
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0)
    model = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[5.0, -3.0]]))
    state = optim.init(model, cfg)
    assert set(state.m) == {"weight"}
    for _ in range(200):
        grads = {"weight": 2 * model.weight.detach()}
        model, state, _ = optim.update(grads, state, model, cfg)
    assert float(model.weight.detach().abs().max()) < 0.2
    assert int(state.step) == 200


def test_global_norm_is_the_leaves_norm():
    leaves = {k: torch.from_numpy(v) for k, v in _leaves(3).items()}
    flat = torch.cat([t.reshape(-1) for t in leaves.values()])
    want = jopt.global_norm({k: jnp.asarray(v.numpy())
                             for k, v in leaves.items()})
    got = optim.global_norm(leaves)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(torch.linalg.norm(flat)),
                               rtol=1e-6)
