"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the same seeded numpy inputs, on the CPU.

* The dispatch plan -- each (token, k) choice's rank within its expert,
  whether it is kept, each expert's kept load and overflow -- is
  bitwise: the port's ``dispatch_plan`` against a count of earlier
  choices with the same expert (what the reference's stable-sort plan
  computes), and ``overflow_frac`` and ``load_max`` (ratios of those
  integers) against the reference's stats.
* The outputs and the load-balance loss within 1e-5 absolute and
  relative in float32 (matmuls and softmax rounded by two frameworks);
  bfloat16 compute within 1.6e-2 of the largest output, four bf16 ulps.
* Tied router probabilities (zero router weights) must pick the
  experts in the reference's order, lowest index first.
* ``capacity_factor=0.5`` forces overflow, as
  ``tests/test_archs_smoke.py::test_moe_overflow_stats`` does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as M
from repro_torch.testing import assert_bitwise

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 1.6e-2
D = 32
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _plan_oracle(dest: np.ndarray, e: int, cap: int):
    """Rank of each choice among the earlier choices of its group with
    the same expert, by a loop."""
    pos = np.zeros(dest.shape, np.int32)
    raw = np.zeros((dest.shape[0], e), np.int32)
    for gi, row in enumerate(dest):
        for i, x in enumerate(row):
            pos[gi, i] = raw[gi, x]
            raw[gi, x] += 1
    counts = np.minimum(raw, cap)
    return pos, pos < cap, counts, raw - counts


@pytest.mark.parametrize("g,nk,e,cap", [(1, 64, 4, 8), (3, 40, 8, 8),
                                        (2, 16, 4, 16), (1, 1, 2, 8)])
def test_dispatch_plan_is_bitwise_the_rank_within_expert(g, nk, e, cap):
    rng = np.random.default_rng(nk)
    dest = rng.integers(0, e, (g, nk))
    dest[0, : nk // 2] = 1                # one crowded expert: overflow
    plan = M.dispatch_plan(torch.from_numpy(dest), e, cap)
    for got, want, name in zip(plan, _plan_oracle(dest, e, cap),
                               M.Plan._fields):
        assert_bitwise(got, want, name)
    assert plan.pos.dtype == plan.counts.dtype == torch.int32


CASES = {
    "mixtral": dict(num_experts=4, top_k=2, d_ff=48),
    "kimi_shared": dict(num_experts=8, top_k=2, d_ff=16,
                        num_shared_experts=1),
    "top8": dict(num_experts=8, top_k=8, d_ff=16),
    "ungated": dict(num_experts=4, top_k=1, d_ff=48, gated=False),
    "overflow": dict(num_experts=4, top_k=2, d_ff=48, capacity_factor=0.5),
}


def _params(rng, jcfg, scale=0.3, zero_router=False):
    shapes = JM.init_moe(jax.random.PRNGKey(0), D, jcfg, jnp.float32)
    p = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                     .astype(np.float32), shapes)
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    mine = M.init_moe(torch.Generator().manual_seed(0), D,
                      M.MoEConfig(**jcfg._asdict()), torch.float32, "cpu")
    assert jax.tree.map(np.shape, dict(mine)) == jax.tree.map(np.shape, p)
    return p


def _run(p, x, kw, compute, num_groups=None):
    jdt, tdt = DTYPES[compute]
    jcfg, tcfg = JM.MoEConfig(**kw), M.MoEConfig(**kw)
    # the router stays float32 in init; the model casts it to the
    # compute dtype with the rest, as the reference's _cast_params does
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), p)
    want, ws = JM.moe_apply(jp, jnp.asarray(x).astype(jdt), jcfg, num_groups)
    module = M.MoE(tcfg, tp)
    got, gs = (module(torch.from_numpy(x).to(tdt)) if num_groups is None
               else M.moe_apply(tp, torch.from_numpy(x).to(tdt), tcfg,
                                num_groups))
    return want, ws, got, gs


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_apply_matches(case, compute):
    rng = np.random.default_rng(3)
    kw = CASES[case]
    p = _params(rng, JM.MoEConfig(**kw))
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    want, ws, got, gs = _run(p, x, kw, compute)
    assert got.dtype == DTYPES[compute][1] and got.shape == x.shape
    for k in ("overflow_frac", "load_max"):
        assert_bitwise(gs[k], np.asarray(ws[k]), k)
    if compute == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(float(gs["aux_loss"]),
                                   float(ws["aux_loss"]), **TOL)
    else:
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=BF16_REL * scale)
    if case == "overflow":
        assert float(gs["overflow_frac"]) > 0 and float(gs["aux_loss"]) > 0


def test_moe_groups_match():
    """Four groups, each with its own plan and capacity."""
    rng = np.random.default_rng(4)
    kw = CASES["overflow"]
    p = _params(rng, JM.MoEConfig(**kw))
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    want, ws, got, gs = _run(p, x, kw, "float32", num_groups=4)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for k in ("overflow_frac", "load_max"):
        assert_bitwise(gs[k], np.asarray(ws[k]), k)


def test_tied_router_picks_the_reference_experts():
    """Zero router weights: every expert equally likely, so the top 2
    are experts 0 and 1 for every token, in that order; each of them
    takes the first 40 of the 64 tokens (its capacity) and overflows
    with the other 24."""
    rng = np.random.default_rng(5)
    kw = CASES["mixtral"]
    p = _params(rng, JM.MoEConfig(**kw), zero_router=True)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    want, ws, got, gs = _run(p, x, kw, "float32")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for k in ("overflow_frac", "load_max"):
        assert_bitwise(gs[k], np.asarray(ws[k]), k)
    assert float(gs["overflow_frac"]) == 48 / 128
    out = _np(got).reshape(64, D)
    assert float(np.abs(out[40:]).max()) == 0.0
    assert float(np.abs(out[:40]).min()) > 0.0
