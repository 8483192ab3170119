"""The CUDA kernels against their plain versions on the card, bitwise
(NaN matches NaN), through the shared checks of
``repro_torch.kernels.checks``: the full-width stream tick's block plus
ragged shapes, NaN rows and empty windows; the AR data plane's routing
batch (hilbert) and its two match shapes (armatch) plus ragged ones;
the Yi-6B and RecurrentGemma-2B serve steps' decode attention
(decode_attn, to a stated tolerance, float32 and bfloat16) plus the
reference's test shapes.  Needs a CUDA card and
``nvcc``; skips without a card.  Imports no JAX, so it runs on the
machine with the card: ``PYTHONPATH=src python -m pytest -q
--noconftest tests/test_torch_card.py`` (``tests/conftest.py`` imports
JAX).
"""
import pytest
import torch

from repro_torch.kernels import checks

#: (t, d, window, stride) of one full-width tick: a 65,536-row
#: micro-batch behind a 32-row carry, 16 features, W = 64, S = 32
FULL_BLOCK = (65568, 16, 64, 32)
#: messages posted a step on the AR data plane
AR_POSTS = 65536
#: (m, n) of its two matches: the posts against 1,024 standing
#: interests, and one query against a 2^20-row DHT shard
AR_MATCHES = ((65536, 1024), (1 << 20, 1))
#: (b, h, hkv, d, s) of the Yi-6B serve step's decode attention: 16
#: requests, 32 query heads on 4 KV heads of 128, a 1,088-row cache
SERVE_ATTN = (16, 32, 4, 128, 1088)
#: the RecurrentGemma-2B serve step's: 10 query heads on 1 KV head of
#: 256 (the bf16_d256 instance), the same 1,088-row cache
RG_SERVE_ATTN = (16, 10, 1, 256, 1088)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


class TestOnCard:
    """Each CUDA kernel against its plain version on the same card
    tensors, and against the CPU, bitwise."""

    def test_window_reduce_kernel(self, card):
        assert checks.check_window_reduce(card, *FULL_BLOCK) == 0.0

    def test_fused_tick_kernel(self, card):
        assert checks.check_fused_tick(card, *FULL_BLOCK) == 0.0

    def test_hilbert_kernel(self, card):
        assert checks.check_hilbert(card, AR_POSTS) == 0.0

    def test_armatch_kernel(self, card):
        assert checks.check_armatch(card, AR_MATCHES) == 0.0

    def test_decode_attn_kernel(self, card):
        assert checks.check_decode_attn(card, SERVE_ATTN,
                                        RG_SERVE_ATTN) <= max(
            checks.DECODE_ATTN_TOL.values())
