"""``chip_smoke.py``'s AR data-plane phase, rehearsed on the CPU at a
tiny size: the same functions the card runs, with the kernels' plain
versions.  The card-only pieces (``torch.cuda.synchronize``, the
kernels' launch counts, which stay 0 on the CPU) are stubbed."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.testing import assert_bitwise

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ar_phase_runs_and_checks_itself(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = smoke.read_launches
    monkeypatch.setattr(smoke, "read_launches",
                        lambda: {k: max(v, 1) for k, v in real().items()})
    sz = smoke.ARSizes(n=256, shard=4096, interests=32, queries=4, steps=3,
                       warmup=1)
    ar = smoke.run_ar(sz, "cpu")
    assert len(ar["secs"]) == 3 and ar["found"] == 10
    # the RP takes at most `capacity` messages a step from this source
    assert 0 < ar["kept"] <= 3 * sz.n // 64
    assert 0 < ar["notify_share"] < 1 and ar["min_hits"] > 0
    # the pre-fill, the warm-up step, then the measured steps' kept rows
    assert int(ar["shard"].cursor) >= sz.shard + ar["kept"]


def test_ar_card_vs_cpu_compares_every_output(smoke):
    sz = smoke.ARSizes(n=128, shard=2048, interests=16, queries=2, steps=2,
                       warmup=0)
    seen = []

    def bitwise(a, b, what):
        assert_bitwise(a, b, what)
        seen.append(what)
    assert smoke.run_ar_card_vs_cpu(sz, "cpu", bitwise) == 2
    assert {"AR step 1 notify", "AR step 1 plan keep", "AR shard stamps",
            "AR step 0 query 1 n_hits"} <= set(seen)


def test_ar_fails_without_kernel_launches(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sz = smoke.ARSizes(n=128, shard=1024, interests=8, queries=1, steps=1,
                       warmup=0)
    with pytest.raises(RuntimeError, match="launched no hilbert kernel"):
        smoke.run_ar(sz, "cpu")


def test_armatch_ops_counts_each_used_slot_pair(smoke):
    """The bound's operation count against a count pair by pair."""
    import numpy as np
    from repro_torch.core import profiles as P
    from repro_torch.kernels.checks import random_profiles
    rng = np.random.default_rng(3)
    kw = dict(wildcard=0.1, bad_vkind=0.1, zero_rows=0.1)
    data = random_profiles(rng, 23, **kw)
    ints = random_profiles(rng, 9, max_slots=4, **kw)
    cost = {P.VK_NONE: 7, P.VK_EXACT: 12, P.VK_PREFIX: 15, P.VK_ANY: 8,
            P.VK_RANGE: 12}
    want = 0
    d = data.reshape(-1, P.MAX_SLOTS, P.SLOT_WIDTH)
    p = ints.reshape(-1, P.MAX_SLOTS, P.SLOT_WIDTH)
    want += 3 * int((d[..., P.L_USED] > 0).sum())
    want += 2 * int((p[..., P.L_USED] > 0).sum())
    for row in d:
        for prof in p:
            want += 1
            for ps in prof[prof[:, P.L_USED] > 0]:
                want += 1
                for ds in row[row[:, P.L_USED] > 0]:
                    want += cost.get(int(ps[P.L_VKIND]), 0)
    assert smoke.armatch_ops(torch.from_numpy(data),
                             torch.from_numpy(ints)) == want


def _serve_sizes(smoke, monkeypatch, **kw):
    """Tiny serve sizes, and Yi-6B's smoke widths in place of its own."""
    from repro_torch import configs
    monkeypatch.setattr(configs, "get_config", configs.smoke_config)
    return smoke.ServeSizes(**{**dict(requests=2, prompt_len=4, tokens=3,
                                      compute="float32"), **kw})


def test_serve_phase_runs_and_checks_itself(smoke, monkeypatch):
    """Yi-6B's smoke widths through ``serve.run``: the launch count the
    card would give, finite logits, ids in the vocabulary, and the late
    step through both attention paths."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sz = _serve_sizes(smoke, monkeypatch)
    cfg = smoke.serve_config(sz)
    steps = sz.prompt_len + sz.tokens
    real = smoke.read_launches

    def as_on_card():
        counts = real()
        counts.update(decode_attn=cfg.n_layers * steps, armatch=1)
        return counts
    monkeypatch.setattr(smoke, "read_launches", as_on_card)
    sv = smoke.run_serve(sz, "cpu")
    assert cfg.d_model == 64 and cfg.compute_dtype == torch.float32
    assert sv["steps"] == steps and len(sv["res"].secs) == steps
    assert sv["res"].tokens.shape == (2, 3)
    assert sv["res"].resolved == "decode:yi-6b-smoke"
    assert 0 <= sv["late"] < 1e-5        # float32: the two paths agree


def test_serve_phase_fails_without_kernel_launches(smoke, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(RuntimeError, match="decode_attn launches"):
        smoke.run_serve(_serve_sizes(smoke, monkeypatch), "cpu")


def test_serve_card_vs_cpu_compares_ids_and_logits(smoke, monkeypatch):
    out = smoke.run_serve_card_vs_cpu(
        _serve_sizes(smoke, monkeypatch, layers=1), "cpu")
    assert out == {"rel": 0.0, "steps": 7}


def test_serve_sizes_are_yi_6b_at_full_width(smoke):
    """The full-width serve run is Yi-6B at its published widths and
    depth, 16 requests, a 1,088-row cache; the reduced run keeps the
    widths."""
    mod = smoke
    full = mod.serve_config(mod.SERVE_FULL)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_head, full.d_ff, full.vocab) == \
        (32, 4096, 32, 4, 128, 11008, 64000)
    assert full.compute_dtype == torch.bfloat16
    assert full.param_dtype == torch.float32
    assert mod.SERVE_FULL.prompt_len + mod.SERVE_FULL.tokens == 1088
    small = mod.serve_config(mod.SERVE_SMALL)
    assert (small.n_layers, small.d_model, small.compute_dtype) == \
        (2, 4096, torch.float32)


@pytest.mark.parametrize("event,want", [
    ("void (anonymous namespace)::decode_attn_bf16_kernel<128, 1>("
     "(anonymous namespace)::Args)", "decode_attn_bf16_kernel"),
    ("void (anonymous namespace)::window_reduce_kernel(float const*, "
     "float*, int)", "window_reduce_kernel"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::ArgMaxOps<float>, unsigned int, long, 4> >("
     "at::native::ReduceOp<float, at::native::ArgMaxOps<float>, unsigned "
     "int, long, 4>)", "reduce_kernel"),
    ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", "nvjet_tst_128x64_64x8_1x2_h_bz_TNT"),
])
def test_timed_matches_kernels_by_function_name(smoke, event, want):
    """``_timed`` picks a call's kernels by the start of their function
    name, read out of the trace's demangled names."""
    assert smoke._base_name(event) == want
    assert smoke._base_name(event).startswith(want[:8])
