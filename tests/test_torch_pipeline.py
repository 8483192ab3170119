"""The port's training data pipeline (``repro_torch.data.pipeline``)
against ``repro.data.pipeline``, on the CPU: ``SyntheticTokens`` bitwise
(a host numpy copy), and ``Prefetcher`` delivering in order, on the
device asked for, and stopping its thread on ``close``."""
import itertools

import numpy as np
import pytest
import torch

from repro.data import SyntheticTokens as JaxTokens
from repro_torch.data import Prefetcher, SyntheticTokens


@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 8, 2, 3),
                                                  (64000, 64, 4, 0)])
def test_synthetic_tokens_match_the_reference(vocab, seq, batch, seed):
    ours, ref = SyntheticTokens(vocab, seq, batch, seed), \
        JaxTokens(vocab, seq, batch, seed)
    for step in (0, 1, 5, 99):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        assert a["tokens"].max() < vocab
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    for a, b in zip(itertools.islice(ours, 3), itertools.islice(ref, 3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_prefetcher_delivers_in_order():
    src = (dict(i=np.asarray([i])) for i in range(5))
    pf = Prefetcher(iter(src), depth=2, device="cpu")
    got = [item["i"] for item in pf]
    assert all(isinstance(t, torch.Tensor) for t in got)
    assert [int(t[0]) for t in got] == [0, 1, 2, 3, 4]


def test_prefetcher_moves_token_batches_and_closes():
    """Batches of ``SyntheticTokens`` arrive as tensors equal to the
    host arrays, in order; ``close`` ends the thread of an endless
    source."""
    src = SyntheticTokens(256, 16, 2)
    pf = Prefetcher(iter(src), depth=2, device="cpu")
    for step in range(4):
        b = next(pf)
        want = src.batch_at(step)
        assert b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["tokens"].numpy(), want["tokens"])
    pf.close()
    assert not pf._thread.is_alive()
