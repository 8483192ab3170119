"""The port's ``window_reduce`` and ``fused_tick`` against the JAX
package's kernels and numpy oracles, bit for bit (NaN matches NaN).

On the CPU the port's wrappers run their plain versions; the JAX side
runs its Pallas kernels in interpret mode (few cases: interpret mode is
slow) and its jnp paths.  ``tests/test_torch_card.py`` holds the CUDA
kernels against their plain versions on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import rules as jrules
from repro.kernels.fused_tick import fused_tick as j_fused_tick
from repro.kernels.fused_tick import fused_tick_ref as np_fused_tick_ref
from repro.kernels.window_reduce import window_reduce as j_window_reduce
from repro.kernels.window_reduce import window_reduce_ref as np_window_ref
from repro.stream.windows import sliding_window as j_sliding_window
from repro_torch.core import rules as trules
from repro_torch.kernels.fused_tick import fused_tick
from repro_torch.kernels.window_reduce import window_reduce
from repro_torch.testing import assert_bitwise

REDUCERS = ("sum", "mean", "max", "min", "count")


def _table(mod):
    """Every comparison op, a threshold not exact in float32 (0.7) and
    all five feature columns, in one conflict set."""
    return mod.RuleEngine([
        mod.threshold_rule("hot", 0, ">=", 0.7, mod.C_SEND_CORE, priority=2),
        mod.threshold_rule("sparse", 4, "<", 6.0, mod.C_STORE_EDGE,
                           priority=1),
        mod.threshold_rule("spike", 1, ">", 2.5, mod.C_TRIGGER_TOPOLOGY,
                           priority=3),
        mod.threshold_rule("dip", 2, "<=", -0.7, mod.C_DROP, priority=4),
        mod.threshold_rule("burst", 3, "==", 0.0, mod.C_NOTIFY, priority=0),
    ]).table()


def _block(rng, t, d, p_valid=0.75, nan_rows=2):
    x = rng.standard_normal((t, d)).astype(np.float32)
    x[rng.integers(0, t, nan_rows), rng.integers(0, d)] = np.nan
    return x, rng.random(t) < p_valid


@pytest.mark.parametrize("t,d,w,s,partial", [
    (37, 3, 8, 3, True),       # sliding, partial tails
    (40, 5, 16, 8, False),     # the executor's complete-only framing
    (10, 1, 4, 1, True),       # dense stride 1
    (5, 2, 16, 4, True),       # window longer than the block
])
@pytest.mark.parametrize("reducer", REDUCERS)
def test_window_reduce_matches_jax_and_numpy(t, d, w, s, partial, reducer):
    rng = np.random.default_rng(t * 100 + d * 10 + s)
    x, v = _block(rng, t, d)
    v[: min(t, 2 * w)] = False            # all-invalid windows too
    out, count = window_reduce(torch.from_numpy(x), torch.from_numpy(v), w, s,
                               reducer=reducer, partial=partial)
    jo, jc = j_sliding_window(jnp.asarray(x), jnp.asarray(v), w, s,
                              reducer=reducer, partial=partial)
    assert_bitwise(out, jo, f"{reducer} vs jnp")
    assert_bitwise(count, jc, "count vs jnp")
    if partial and not np.isnan(x).any(axis=1)[v].any():
        ro, rc = np_window_ref(x, v, w, s, reducer)
        np.testing.assert_allclose(out.numpy(), ro, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(count.numpy(), rc)


@pytest.mark.parametrize("reducer", ["sum", "mean", "max", "min"])
def test_window_reduce_matches_pallas_interpret(reducer):
    rng = np.random.default_rng(5)
    x, v = _block(rng, 37, 3)
    out, count = window_reduce(torch.from_numpy(x), torch.from_numpy(v), 8, 3,
                               reducer=reducer)
    jo, jc = j_window_reduce(jnp.asarray(x), jnp.asarray(v), 8, 3,
                             reducer=reducer, interpret=True)
    assert_bitwise(out, jo, reducer)
    assert_bitwise(count, jc, "count")


def _seq(rng, t, d, p_valid=0.75):
    """Executor-convention ring rows [event_ts | ingest_wall | features]."""
    seq = np.concatenate([
        np.arange(t, dtype=np.float32)[:, None],
        (rng.random(t).astype(np.float32) * 10.0)[:, None],
        rng.standard_normal((t, d)).astype(np.float32)], axis=1)
    seq[rng.integers(0, t, 2), 2 + rng.integers(0, d)] = np.nan
    return seq, rng.random(t) < p_valid


@pytest.mark.parametrize("t,d,w,s", [
    (32, 3, 8, 8),       # tumbling
    (40, 3, 16, 8),      # sliding (the executor's carry framing)
    (24, 1, 8, 4),       # single feature column
    (40, 5, 4, 1),       # dense stride 1
    (9, 2, 8, 8),        # single window, ragged tail rows
])
@pytest.mark.parametrize("min_count", [1, 3])
def test_fused_tick_matches_jax_and_numpy(t, d, w, s, min_count):
    rng = np.random.default_rng(t * 100 + d * 10 + s + min_count)
    seq, v = _seq(rng, t, d)
    table = _table(trules)
    assert table == _table(jrules)
    got = fused_tick(torch.from_numpy(seq), torch.from_numpy(v), w, s,
                     table=table, min_count=min_count)
    ref = j_fused_tick(jnp.asarray(seq), jnp.asarray(v), w, s, table=table,
                       min_count=min_count, backend="jnp")
    oracle = np_fused_tick_ref(seq, v, w, s, table, min_count=min_count)
    for name, a, b, c in zip(("agg", "wcount", "feats", "w_birth", "cons"),
                             got, ref, oracle):
        assert_bitwise(a, b, f"{name} vs jnp")
        assert_bitwise(a, c, f"{name} vs numpy")


def test_fused_tick_matches_pallas_interpret():
    rng = np.random.default_rng(17)
    seq, v = _seq(rng, 40, 3)
    table = _table(trules)
    got = fused_tick(torch.from_numpy(seq), torch.from_numpy(v), 16, 8,
                     table=table, min_count=2)
    ref = j_fused_tick(jnp.asarray(seq), jnp.asarray(v), 16, 8, table=table,
                       min_count=2, backend="pallas", interpret=True)
    for name, a, b in zip(("agg", "wcount", "feats", "w_birth", "cons"),
                          got, ref):
        assert_bitwise(a, b, name)


def test_fused_tick_gates_and_empty_windows():
    """Windows under min_count never fire; all-invalid windows give 0
    (no +-max leaking from the masked max/min)."""
    seq = torch.full((16, 4), 7.0)
    always = trules.RuleEngine([trules.threshold_rule(
        "always", 4, ">=", 0.0, trules.C_SEND_CORE)]).table()
    agg, wcount, feats, w_birth, cons = fused_tick(
        seq, torch.zeros(16, dtype=torch.bool), 8, 8, table=always)
    for a in (agg, wcount, feats, w_birth, cons):
        assert not a.any()
    valid = torch.arange(32) % 4 == 0                # 2 valid rows a window
    seq = torch.ones((32, 5))
    for min_count, code in ((1, trules.C_SEND_CORE), (3, trules.C_NONE)):
        *_, cons = fused_tick(seq, valid, 8, 8, table=always,
                              min_count=min_count)
        assert (cons == code).all()


def test_fused_tick_rejects_non_tabular_table():
    with pytest.raises(ValueError, match="tabular"):
        fused_tick(torch.zeros((16, 4)), torch.ones(16, dtype=torch.bool),
                   8, 8, table=None)


@pytest.mark.parametrize("check", ["check_window_reduce", "check_fused_tick"])
def test_shared_kernel_checks_run_on_cpu(check):
    """The card checks of ``repro_torch.kernels.checks`` run end to end
    on the CPU (plain versions on both sides, no launch counted)."""
    from repro_torch.kernels import checks
    assert getattr(checks, check)("cpu", 96, 3, 16, 8) == 0.0
