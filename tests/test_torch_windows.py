"""Window operators of the port (``repro_torch.stream.windows``) against
``repro.stream.windows``, bit for bit (NaN matches NaN), on the CPU."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.stream import windows as JW
from repro_torch.stream import windows as TW
from repro_torch.testing import assert_bitwise

REDUCERS = ("sum", "mean", "max", "min", "count")


def _block(rng, t, d, p_valid=0.8):
    x = rng.standard_normal((t, d)).astype(np.float32)
    return x, rng.random(t) < p_valid


def _both(fn_j, fn_t, arrays, *static, **kw):
    """Call the reference and the port on the same numpy arrays."""
    j = fn_j(*(jnp.asarray(a) for a in arrays), *static, **kw)
    t = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays), *static, **kw)
    return j, t


@pytest.mark.parametrize("t,d,w,s", [
    (32, 4, 8, 8),      # tumbling, aligned
    (37, 3, 8, 3),      # sliding, partial tails
    (10, 1, 4, 1),      # dense sliding
    (5, 2, 16, 4),      # window larger than the block
    (64, 5, 1, 1),      # width-1 windows
])
@pytest.mark.parametrize("partial", [True, False])
def test_sliding_window_every_reducer(t, d, w, s, partial):
    rng = np.random.default_rng(t * 10 + d + s)
    x, v = _block(rng, t, d)
    x[rng.integers(0, t), 0] = np.nan
    if not partial and t < w:               # no complete window: both refuse
        with pytest.raises(ValueError, match="partial=False"):
            JW.sliding_window(jnp.asarray(x), jnp.asarray(v), w, s,
                              partial=False)
        with pytest.raises(ValueError, match="partial=False"):
            TW.sliding_window(torch.from_numpy(x), torch.from_numpy(v), w, s,
                              partial=False)
        return
    for reducer in REDUCERS:
        (jo, jc), (to, tc) = _both(JW.sliding_window, TW.sliding_window,
                                   (x, v), w, s, reducer=reducer,
                                   partial=partial)
        assert_bitwise(to, jo, reducer)
        assert_bitwise(tc, jc, f"{reducer} count")


def test_all_invalid_block_and_tumbling():
    x = np.full((8, 3), 5.0, np.float32)
    for v in (np.zeros(8, bool), np.asarray([True] * 4 + [False] * 4)):
        for reducer in REDUCERS:
            (jo, jc), (to, tc) = _both(JW.tumbling_window, TW.tumbling_window,
                                       (x, v), 4, reducer=reducer)
            assert_bitwise(to, jo, reducer)
            assert_bitwise(tc, jc, "count")
            assert not to[1].any()


def test_callable_reducer():
    rng = np.random.default_rng(3)
    x, v = _block(rng, 16, 2)

    def masked_range(vals, mask):
        m = mask[:, :, None]
        mx = torch.where(m, vals, -3e38).amax(1)
        mn = torch.where(m, vals, 3e38).amin(1)
        return torch.where(mask.any(1)[:, None], mx - mn, 0.0)

    out, count = TW.sliding_window(torch.from_numpy(x), torch.from_numpy(v),
                                   8, 4, reducer=masked_range)
    mx, _ = TW.sliding_window(torch.from_numpy(x), torch.from_numpy(v), 8, 4,
                              reducer="max")
    mn, c2 = TW.sliding_window(torch.from_numpy(x), torch.from_numpy(v), 8, 4,
                               reducer="min")
    assert_bitwise(out, mx - mn, "range")
    assert_bitwise(count, c2, "count")


@pytest.mark.parametrize("partial", [True, False])
def test_window_features(partial):
    rng = np.random.default_rng(7)
    x, v = _block(rng, 40, 3)
    x[5, 0] = np.nan
    v[:20] = False                           # empty windows too
    (jf, jc), (tf, tc) = _both(JW.window_features, TW.window_features,
                               (x, v), 8, 4, partial=partial)
    assert_bitwise(tf, jf, "features")
    assert_bitwise(tc, jc, "count")


@pytest.mark.parametrize("reducer", REDUCERS)
def test_session_window(reducer):
    rng = np.random.default_rng(11)
    t, d, gap = 40, 3, 5.0
    x, v = _block(rng, t, d)
    ts = np.cumsum(rng.choice([0.5, 1.0, 12.0], t, p=[0.45, 0.45, 0.1])) \
        .astype(np.float32)
    rng.shuffle(ts[:10])                     # out-of-order delivery
    j = JW.session_window(jnp.asarray(x), jnp.asarray(v), jnp.asarray(ts),
                          gap, reducer=reducer)
    o = TW.session_window(torch.from_numpy(x), torch.from_numpy(v),
                          torch.from_numpy(ts), gap, reducer=reducer)
    for name, a, b in zip(("out", "count", "closed"), o, j):
        assert_bitwise(a, b, name)


def test_session_window_all_invalid():
    o = TW.session_window(torch.ones((4, 2)), torch.zeros(4, dtype=torch.bool),
                          torch.arange(4.0), 1.0)
    j = JW.session_window(jnp.ones((4, 2)), jnp.zeros(4, bool),
                          jnp.arange(4.0), 1.0)
    for a, b in zip(o, j):
        assert_bitwise(a, b)


@pytest.mark.parametrize("exempt", [False, True])
def test_apply_watermark_float(exempt):
    rng = np.random.default_rng(13)
    mx = np.float32(np.finfo(np.float32).min)
    for blk in range(4):
        ts = (blk * 8 + np.arange(8)).astype(np.float32)
        ts[:2] -= 20.0 * (blk % 2)           # reordered beyond the slack
        v = rng.random(8) < 0.9
        ex = rng.random(8) < 0.5 if exempt else None
        args = (ts, v, np.asarray(mx, np.float32), 5.0)
        jv, jn, jm = JW.apply_watermark(
            *(jnp.asarray(a) for a in args[:3]), 5.0,
            exempt=None if ex is None else jnp.asarray(ex))
        tv, tn, tm = TW.apply_watermark(
            *(torch.from_numpy(np.array(a)) for a in args[:3]), 5.0,
            exempt=None if ex is None else torch.from_numpy(ex))
        for name, a, b in (("valid", tv, jv), ("n_late", tn, jn),
                           ("max", tm, jm)):
            assert_bitwise(a, b, f"block {blk} {name}")
        mx = np.asarray(jm)


def test_apply_watermark_integer_timestamps():
    ts = np.asarray([0, 5, 1, 3], np.int32)
    v = np.ones(4, bool)
    jv, jn, jm = JW.apply_watermark(jnp.asarray(ts), jnp.asarray(v),
                                    jnp.asarray(4, jnp.int32), 1)
    tv, tn, tm = TW.apply_watermark(torch.from_numpy(ts), torch.from_numpy(v),
                                    torch.tensor(4, dtype=torch.int32), 1)
    for a, b in ((tv, jv), (tn, jn), (tm, jm)):
        assert_bitwise(a, b)
    assert int(tn) == 2 and int(tm) == 5
