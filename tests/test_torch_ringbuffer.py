"""The port's ring buffer against ``repro.data.ringbuffer``: the same
enqueue/dequeue sequences on both, buffer, head, tail, accept counts
and dequeued rows bitwise after every operation."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.data import ringbuffer as J
from repro_torch.data import ringbuffer as T
from repro_torch.testing import assert_bitwise


def _run(cap, width, ops):
    """Apply ``ops`` (("enq", rows[, mask]) | ("deq", n)) to both rings."""
    jr = J.create(cap, (width,))
    tr = T.create(cap, (width,), device="cpu")
    for k, op in enumerate(ops):
        if op[0] == "enq":
            rows = np.asarray(op[1], np.float32).reshape(-1, width)
            mask = op[2] if len(op) > 2 else None
            jr, jn = J.enqueue(jr, jnp.asarray(rows),
                               None if mask is None else jnp.asarray(mask))
            tr, tn = T.enqueue(tr, torch.from_numpy(rows),
                               None if mask is None else torch.from_numpy(mask))
            assert_bitwise(tn, jn, f"op {k} n_accepted")
        else:
            jr, jo, jv = J.dequeue(jr, op[1])
            tr, to, tv = T.dequeue(tr, op[1])
            assert_bitwise(to, jo, f"op {k} rows")
            assert_bitwise(tv, jv, f"op {k} valid")
        assert_bitwise(tr.buf, jr.buf, f"op {k} buf")
        assert_bitwise(tr.head, jr.head, f"op {k} head")
        assert_bitwise(tr.tail, jr.tail, f"op {k} tail")
        assert_bitwise(T.size(tr), J.size(jr), f"op {k} size")
        assert_bitwise(T.free_space(tr), J.free_space(jr), f"op {k} free")
    return tr


def test_enqueue_past_capacity_rejects():
    tr = _run(4, 1, [("enq", [1, 2, 3]), ("enq", [4, 5, 6]), ("enq", [7, 8]),
                     ("deq", 4)])
    assert int(tr.head) == 4 and int(tr.tail) == 4


def test_fifo_order_across_wraparound():
    ops, nxt = [], 0.0
    for _ in range(7):
        ops += [("enq", [nxt, nxt + 1, nxt + 2]), ("deq", 2)]
        nxt += 3
    _run(4, 1, ops)


def test_empty_dequeue_and_batches_larger_than_capacity():
    _run(4, 2, [("deq", 3), ("enq", np.ones((2, 2))), ("deq", 3),
                ("enq", np.arange(12.0)), ("deq", 4), ("deq", 5)])


def test_masked_offers_keep_fifo_and_discard_slot():
    rng = np.random.default_rng(4)
    ops = []
    for _ in range(6):
        rows = rng.standard_normal((5, 3))
        ops += [("enq", rows, rng.random(5) < 0.6), ("deq", 2)]
    ops += [("enq", np.ones((9, 3)), np.ones(9, bool)),      # n > cap
            ("enq", np.ones((3, 3)), np.zeros(3, bool))]     # nothing offered
    _run(6, 3, ops)


@pytest.mark.parametrize("seed", range(4))
def test_random_sequences_with_backpressure(seed):
    rng = np.random.default_rng(seed)
    cap, width = int(rng.integers(3, 12)), int(rng.integers(1, 4))
    ops = []
    for _ in range(25):
        if rng.random() < 0.6:
            n = int(rng.integers(0, 2 * cap))
            rows = rng.standard_normal((n, width))
            rows[rng.random(n) < 0.1] = -0.0
            mask = rng.random(n) < 0.7 if rng.random() < 0.5 else None
            ops.append(("enq", rows) if mask is None else ("enq", rows, mask))
        else:
            ops.append(("deq", int(rng.integers(1, cap + 2))))
    _run(cap, width, ops)
