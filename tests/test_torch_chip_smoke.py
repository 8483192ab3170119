"""``chip_smoke.py``'s AR data-plane and serve phases, rehearsed on the
CPU at a tiny size: the same functions the card runs, with the kernels'
plain versions; the serve runs of Yi-6B and of the recurrent and MoE
families (RecurrentGemma-2B, RWKV6-7B, Mixtral-8x7B) at their smoke
widths; phase 12's controlled arc and remesh over 2 gloo ranks.  The
card-only pieces (``torch.cuda.synchronize``, the kernels' launch
counts, which stay 0 on the CPU) are stubbed."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.testing import assert_bitwise, assert_close

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
    """The bound's operation count (``kernels.cost.armatch_ops``, which
    ``chip_smoke.py`` bounds armatch with) against a count pair by
    pair."""
    import numpy as np
    from repro_torch.core import profiles as P
    from repro_torch.kernels.checks import random_profiles
    from repro_torch.kernels.cost import armatch_ops
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
    assert armatch_ops(torch.from_numpy(data),
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


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_7b",
                                  "mixtral_8x7b"])
def test_family_serve_phase_runs_and_checks_itself(smoke, monkeypatch, arch):
    """Phase 6's serve run at each family's smoke widths: decode_attn
    launches wanted for the attention layers only (none for RWKV), the
    late step through both attention paths on cloned recurrent states,
    and Mixtral's MoE stats of that step."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sz = _serve_sizes(smoke, monkeypatch, arch=arch, prompt_len=20)
    cfg = smoke.serve_config(sz)
    steps = sz.prompt_len + sz.tokens
    n_attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    assert n_attn == {"recurrentgemma_2b": 1, "rwkv6_7b": 0,
                      "mixtral_8x7b": 2}[arch]
    real = smoke.read_launches

    def as_on_card():
        counts = real()
        counts.update(decode_attn=n_attn * steps, armatch=1)
        return counts
    monkeypatch.setattr(smoke, "read_launches", as_on_card)
    sv = smoke.run_serve(sz, "cpu")
    assert sv["n_attn"] == n_attn and sv["steps"] == steps
    assert sv["instance"] == (None if arch == "rwkv6_7b" else "f32_d16")
    assert sv["res"].resolved == f"decode:{cfg.name}"
    assert 0 <= sv["late"] < 1e-5 and sv["flips"] == []
    assert len(sv["overflow"]) == (2 if arch == "mixtral_8x7b" else 0)
    assert all(0 <= f <= 1 for f in sv["overflow"])
    # the serve run moved every recurrent state off zero, in place
    for kind, c in zip(cfg.layer_kinds(), sv["res"].caches):
        state = {"rec": lambda: c["rec"]["h"],
                 "rwkv": lambda: c["tmix"]["wkv"]}.get(kind)
        if state is not None:
            assert float(state().abs().max()) > 0


@pytest.mark.parametrize("flip", ["one", "all", "fault", "overflow"])
def test_late_step_leaves_out_requests_whose_routing_flipped(
        smoke, monkeypatch, flip):
    """The late step's plain path given other experts for request 0 (or
    for every request): that request is counted as flipped and left out
    of the logit difference, with its MoE input where it flipped and the
    router's margin there.  The phase fails with every request flipped
    (nothing is left to compare), with a flipped request whose MoE input
    differs between the steps (a fault confined to it: here another
    token), and with a flip while a MoE layer drops choices."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    sz = _serve_sizes(smoke, monkeypatch, arch="mixtral_8x7b")
    cfg = smoke.serve_config(sz)
    res = serve.run(cfg, 4, 6, 2, device="cpu")
    real_route, real_step, plain = moe.route, T.decode_step, [False]

    def route(xt, router, k):
        probs, gates, ids = real_route(xt, router, k)
        if plain[0]:          # the next experts, for the chosen requests
            rows = slice(None) if flip == "all" else slice(0, 1)
            ids = ids.clone()
            ids[:, rows] = (ids[:, rows] + 1) % router.shape[1]
        return probs, gates, ids

    def step(cfg, model, tokens, *args, use_kernel=True, **kw):
        plain[0] = not use_kernel
        if plain[0] and flip == "fault":
            tokens = tokens.clone()
            tokens[0] = (tokens[0] + 1) % cfg.vocab
        try:
            return real_step(cfg, model, tokens, *args,
                             use_kernel=use_kernel, **kw)
        finally:
            plain[0] = False
    monkeypatch.setattr(moe, "route", route)
    monkeypatch.setattr(T, "decode_step", step)
    if flip == "overflow":    # a capacity of one choice an expert
        monkeypatch.setattr(moe, "capacity", lambda cfg, n: 1)
    want = {"all": "every request's expert", "fault": "not a near tie",
            "overflow": "dropped choices"}.get(flip)
    if want is not None:
        with pytest.raises(RuntimeError, match=want):
            smoke.late_step(cfg, res)
        return
    late, stats, flips = smoke.late_step(cfg, res)
    assert late < 1e-5 and len(stats) == cfg.n_layers
    assert [(f["request"], f["layer"]) for f in flips] == [(0, 0)]
    assert flips[0]["input"] < 1e-5 and flips[0]["margin"] >= 0
    assert all(float(st["overflow_frac"]) == 0 for st in stats)


def test_family_serve_phase_counts_attention_layers_only(smoke, monkeypatch):
    """RecurrentGemma's launch count is its attention layers x steps, not
    all of its layers."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    sz = _serve_sizes(smoke, monkeypatch, arch="recurrentgemma_2b")
    cfg = smoke.serve_config(sz)
    real = smoke.read_launches
    steps = sz.prompt_len + sz.tokens
    monkeypatch.setattr(smoke, "read_launches", lambda: {
        **real(), "decode_attn": cfg.n_layers * steps, "armatch": 1})
    with pytest.raises(RuntimeError, match="1 attention layers"):
        smoke.run_serve(sz, "cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_7b",
                                  "mixtral_8x7b"])
def test_family_card_vs_cpu_runs_the_smoke_config(smoke, arch):
    """Phase 6's card-against-CPU run, at the sizes it uses: the smoke
    config, 48 steps, RecurrentGemma's 16-row ring cache wrapping."""
    sz = smoke.FAMILY_SMALL[arch]
    cfg = smoke.serve_config(sz)
    assert cfg.name.endswith("-smoke") and cfg.compute_dtype == torch.float32
    steps = sz.prompt_len + sz.tokens
    assert steps >= 48 and (cfg.window is None or steps > cfg.window)
    assert smoke.run_serve_card_vs_cpu(sz, "cpu") == {"rel": 0.0,
                                                      "steps": steps}


def test_family_sizes_are_the_published_widths(smoke):
    """RecurrentGemma-2B and RWKV6-7B at full width and depth, Mixtral at
    full width and 8 layers; the decode_attn shapes phase 2 checks."""
    rg = smoke.serve_config(smoke.RG_FULL)
    assert (rg.n_layers, rg.d_model, rg.n_heads, rg.n_kv_heads, rg.d_head,
            rg.d_ff, rg.vocab, rg.window) == \
        (26, 2560, 10, 1, 256, 7680, 256000, 2048)
    assert rg.layer_kinds().count("attn+dense") == 8
    assert smoke.attn_shape(smoke.RG_FULL) == (16, 10, 1, 256, 1088)
    assert smoke.attn_shape(smoke.MIXTRAL_FULL) == (16, 32, 8, 128, 96)
    rw = smoke.serve_config(smoke.RWKV_FULL)
    assert (rw.n_layers, rw.d_model, rw.rwkv.n_heads, rw.rwkv.d_head,
            rw.d_ff) == (32, 4096, 64, 64, 14336)
    mx = smoke.serve_config(smoke.MIXTRAL_FULL)
    assert (mx.n_layers, mx.d_model, mx.n_heads, mx.n_kv_heads,
            mx.moe.num_experts, mx.moe.top_k, mx.moe.d_ff, mx.window) == \
        (8, 4096, 32, 8, 8, 2, 14336, 4096)
    for sz in (smoke.RG_FULL, smoke.RWKV_FULL, smoke.MIXTRAL_FULL):
        cfg = smoke.serve_config(sz)
        assert cfg.compute_dtype == torch.bfloat16
        assert cfg.param_dtype == torch.float32 and sz.requests == 16


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


def test_timed_counts_only_the_loop_range(smoke, monkeypatch, tmp_path):
    """``_device_events(after=...)`` keeps the device events that start
    in the named range (less half the settle time), not the untimed call
    made before it, and fails on a trace without the range."""
    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    t0, pad = 1.0e6, smoke.SETTLE_S / 2 * 1e6
    trace = [
        {"cat": "kernel", "name": "k_warm", "ts": t0 - 2 * pad, "dur": 5},
        {"cat": "user_annotation", "name": smoke.TIMED_RANGE, "ts": t0,
         "dur": 100},
        {"cat": "kernel", "name": "k_early_clock", "ts": t0 - 1, "dur": 5},
        {"cat": "kernel", "name": "k_loop", "ts": t0 + 10, "dur": 5},
        {"cat": "gpu_memcpy", "name": "copy", "ts": t0 + 20, "dur": 1},
        {"cat": "cpu_op", "name": "aten::add", "ts": t0 + 30, "dur": 1},
    ]

    class Prof:
        def __init__(self, events):
            self.events = events

        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": self.events}))
    names = [e["name"] for e in smoke._device_events(
        Prof(trace), "t", after=smoke.TIMED_RANGE)]
    assert names == ["k_early_clock", "k_loop", "copy"]
    assert len(smoke._device_events(Prof(trace), "t")) == 4
    with pytest.raises(RuntimeError, match="no 'chip_smoke_timed_loop'"):
        smoke._device_events(Prof(trace[:1]), "t", after=smoke.TIMED_RANGE)


def test_timed_takes_a_short_capture_once_more(smoke, monkeypatch, capsys):
    """A capture that traced fewer of the loop's kernels than calls is
    taken once more, and a second short one fails."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = iter([0, (1.0, 2.0)])
    monkeypatch.setattr(smoke, "_timed_once", lambda *a: next(got))
    assert smoke._timed(lambda: None, 5, "t", kernel="k") == (1.0, 2.0)
    assert "0 k* kernels traced" in capsys.readouterr().out
    monkeypatch.setattr(smoke, "_timed_once", lambda *a: 3)
    with pytest.raises(RuntimeError, match="3 k\\* kernels traced"):
        smoke._timed(lambda: None, 5, "t", kernel="k")


# -- phase 7: the fleet -------------------------------------------------------

def _fleet_sizes(smoke):
    sz = smoke.Sizes(batch=512, d=16, window=64, stride=32,
                     capacity=1 << 12, ticks=8, cpu_ticks=2, dedupe=0,
                     warmup=1)
    fz = smoke.FleetSizes(regions=2, edges=4, num_core=2, core_budget=16,
                          fog_budget=12, ticks=8, checks=(0, 4))
    small = sz._replace(batch=256, ticks=6)
    fzs = fz._replace(core_budget=8, fog_budget=6, ticks=6)
    return sz, fz, small, fzs


def _as_on_card(smoke, monkeypatch, fz, per_tick=None, simple=0):
    """Launch counts as the card gives them: ``per_tick`` launches of the
    path's kernel a shard a tick (fused 1, staged 5 by default)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = smoke.make_fleet
    phase = {}

    def make_fleet(*a, fused=True, **k):
        phase["fused"] = fused
        return real(*a, fused=fused, **k)

    def launches():
        fused = phase["fused"]
        n = (1 if fused else 5) if per_tick is None else per_tick
        return {"window_reduce": 0 if fused else n * fz.shards * fz.ticks,
                "fused_tick": n * fz.shards * fz.ticks if fused else 0,
                "hilbert": 0, "armatch": 0, "decode_attn": 0}
    monkeypatch.setattr(smoke, "make_fleet", make_fleet)
    monkeypatch.setattr(smoke, "read_launches", launches)
    monkeypatch.setattr(smoke, "read_simple", lambda: {
        "window_reduce": 0, "fused_tick": simple, "armatch": 0})


def test_fleet_phase_runs_and_checks_itself(smoke, monkeypatch):
    """Phase 7 at a tiny size on the CPU: every check runs and holds,
    both budgets bind on the hot ticks and neither on the cold ones."""
    sz, fz, small, fzs = _fleet_sizes(smoke)
    _as_on_card(smoke, monkeypatch, fz)
    seen = []

    def bitwise(a, b, what):
        assert_bitwise(a, b, what)
        seen.append(what)
    fl = smoke.run_fleet(sz, fz, small, fzs, "cpu", bitwise, assert_close)
    assert fl["single"] == 2 and fl["oracle"] > 0
    assert fl["card_vs_cpu_err"] == 0.0
    fused = fl["results"]["fused"]
    hot = [smoke.fleet_hot(i) for i in range(fz.ticks)]
    assert [bool(d[0] and d[1]) for d in fused["deltas"]] == hot
    for what in ("fleet staged vs fused tick 7 outputs",
                 "fleet staged vs fused ring",
                 "1-shard fleet vs executor tick 4 outputs",
                 "fleet vs lone shard 7 tick 4 escalated",
                 "fleet card vs CPU tick 5 consequence",
                 "fleet card vs CPU watermark"):
        assert what in seen, what
    smoke.print_fleet(sz, fz, fl)


@pytest.mark.parametrize("fault,match", [
    ("launches", "staged path launched window_reduce 0 times"),
    ("simple", "launched a simple instance"),
    ("budgets", "must bind on hot ticks"),
])
def test_fleet_phase_fails_on_a_broken_check(smoke, monkeypatch, fault,
                                             match):
    """The phase fails when a path launched no kernel, launched
    a simple instance, or when the budgets do not bind on hot ticks."""
    sz, fz, small, fzs = _fleet_sizes(smoke)
    _as_on_card(smoke, monkeypatch, fz,
                per_tick=0 if fault == "launches" else None,
                simple=1 if fault == "simple" else 0)
    if fault == "budgets":
        fz = fz._replace(core_budget=10_000, fog_budget=10_000)
    with pytest.raises(RuntimeError, match=match):
        smoke.run_fleet(sz, fz, small, fzs, "cpu", assert_bitwise,
                        assert_close)


def test_fleet_card_vs_cpu_fails_on_a_different_core(smoke, monkeypatch):
    """Check 4 holds the core outputs within its tolerance: a core stage
    off by 1e-5 on one side fails it."""
    sz, fz, small, fzs = _fleet_sizes(smoke)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    real = smoke.make_fleet
    calls = []

    def make_fleet(*a, **k):
        fx, st = real(*a, **k)
        calls.append(fx)
        if len(calls) == 1:       # the "card" side
            fn = fx.pipeline.stages[-1].fn
            fx.pipeline.stages = fx.pipeline.stages[:-1] + (
                fx.pipeline.stages[-1].__class__(
                    "core", lambda p, b: (fn(p, b)[0] + 1e-5,
                                          fn(p, b)[1]), "core",
                    fx.pipeline.stages[-1].params),)
        return fx, st
    monkeypatch.setattr(smoke, "make_fleet", make_fleet)
    from repro_torch.testing import Tolerance
    with pytest.raises(AssertionError, match="fleet card vs CPU tick"):
        smoke.fleet_card_vs_cpu(small, fzs, "cpu", assert_bitwise,
                                assert_close, Tolerance(*smoke.FLEET_CORE))


def test_fleet_sizes_are_the_full_width(smoke):
    """8 shards in 2 regions of 4, each at the single tick's full width,
    two core ranks at the single tick's core capacity, 1e-6 on the core
    outputs."""
    fz, sz = smoke.FLEET, smoke.FULL
    assert (fz.regions, fz.edges, fz.num_core, fz.core_budget,
            fz.fog_budget) == (2, 4, 2, 1024, 768)
    assert (sz.batch, sz.d, sz.window, sz.stride, sz.capacity) == \
        (65536, 16, 64, 32, 1 << 22)
    assert fz.core_budget // fz.num_core == sz.batch // sz.stride // 4
    assert fz.ticks == 16 and smoke.FLEET_CORE[1:] == (1e-6, 1e-6)


# -- phase 8: the controlled fleet --------------------------------------------

def _control_sizes(smoke, monkeypatch):
    """Phase 8 at a tiny size: 512 rows a shard (check 3 at 256), budgets
    scaled with the windows, 16 ticks of the hot/cold feed; each call of
    fused_tick's plain version counted as the card counts a launch."""
    from repro_torch.kernels.fused_tick import ops as FT
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "_card_line", lambda: "CPU rehearsal")
    real = FT.fused_tick_ref

    def counted(*a, **k):
        FT.fused_tick.launches += 1
        return real(*a, **k)
    monkeypatch.setattr(FT, "fused_tick_ref", counted)
    sz = smoke.Sizes(batch=512, d=16, window=64, stride=32,
                     capacity=1 << 12, ticks=16, cpu_ticks=2, dedupe=0,
                     warmup=1)
    fz = smoke.FleetSizes(regions=2, edges=4, num_core=2, core_budget=16,
                          fog_budget=12, ticks=16, checks=(0, 4))
    monkeypatch.setattr(smoke, "SMALL", sz._replace(batch=256))
    monkeypatch.setattr(smoke, "FLEET_SMALL",
                        fz._replace(core_budget=8, fog_budget=6))
    return sz, fz


def test_control_phase_runs_and_checks_itself(smoke, monkeypatch, capsys):
    """Phase 8 on the CPU: every check runs and holds, and the fused_tick
    entry of the kernels line gains the controlled run's launches."""
    sz, fz = _control_sizes(smoke, monkeypatch)
    rows = [{"name": "fused_tick"}, {"name": "window_reduce"}]
    smoke.run_control_phase(sz, fz, "cpu", rows)
    out = capsys.readouterr().out
    for line in ("phase 8 controlled fleet", "phase 8 elastic budgets",
                 "phase 8 card vs CPU", "phase 8 step_cost",
                 "phase 8 roofline", "phase 8 timing"):
        assert line in out and "CPU rehearsal" in out, line
    assert rows[0]["control_launches_a_tick"] == fz.shards
    assert rows[0]["control_launches"] % fz.shards == 0
    assert "control_launches" not in rows[1]


def test_control_vs_oracle_states_the_stall_window(smoke, monkeypatch):
    """Check 1 returns the arc's numbers: the stalled shard and the
    backup counted late-excluded rows, the rows replayed, one fused_tick
    launch a shard a tick."""
    sz, fz = _control_sizes(smoke, monkeypatch)
    arc = smoke.control_vs_oracle(sz, fz, "cpu", assert_bitwise,
                                  assert_close)
    stalled = smoke.CONTROL_FAULT[0]
    assert arc["late_excluded"][stalled] > 0
    assert arc["late_excluded"][arc["backup"]] > 0
    assert arc["backup"] // fz.edges == smoke.CONTROL_CHURN[0] // fz.edges
    assert arc["replayed"] == 6 * sz.batch      # the six departed ticks
    assert arc["launches"]["fused_tick"] == fz.shards * arc["ticks"]


@pytest.mark.parametrize("fault,match", [
    ("launches", "launched fused_tick"),
    ("handoff", "controlled vs oracle stream 5"),
    ("budgets", "elastic budgets"),
])
def test_control_phase_fails_on_a_broken_check(smoke, monkeypatch, fault,
                                               match):
    """Phase 8 fails when the path launched no kernel, when the churn
    skips the carry handoff (the replayed stream's sliding windows
    smear), or when the elastic budgets never move."""
    from repro_torch.stream.fleet import FleetController
    sz, fz = _control_sizes(smoke, monkeypatch)
    if fault == "launches":
        monkeypatch.setattr(smoke, "read_launches", lambda: {
            "fused_tick": 0, "window_reduce": 0})
    if fault == "handoff":
        monkeypatch.setattr(FleetController, "begin_replay_carry",
                            lambda self, st, stream, backup: st)
        monkeypatch.setattr(FleetController, "end_replay_carry",
                            lambda self, st, stream, backup: st)
    if fault == "budgets":
        fz = fz._replace(core_budget=10_000, fog_budget=10_000)
    with pytest.raises((RuntimeError, AssertionError), match=match):
        if fault == "budgets":
            smoke.control_elastic(sz, fz, "cpu")
        else:
            smoke.control_vs_oracle(sz, fz, "cpu", assert_bitwise,
                                    assert_close)


def test_main_fails_without_a_result_when_phase_8_fails(smoke, monkeypatch,
                                                        capsys):
    """A failed phase 8 check makes ``main()`` return 1 and print neither
    the kernels line nor the ``ok`` line."""
    sz, fz = _control_sizes(smoke, monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "run", lambda: smoke.control_elastic(
        sz, fz._replace(core_budget=10_000, fog_budget=10_000), "cpu"))
    assert smoke.main() == 1
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out and '"kernels"' not in captured.out
    assert "elastic budgets" in captured.err


# -- phase 9: training ----------------------------------------------------------

def _train_on_cpu(smoke, monkeypatch):
    """Phase 9's sizes at the smoke config, the card's memory counters
    and ``nvidia-smi`` stubbed."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(smoke, "_card_line", lambda: "CPU rehearsal")
    monkeypatch.setattr(smoke, "_profile",
                        lambda tag, steps, unit, fn, kernel=None: fn(0))
    full = smoke.TrainSizes(steps=3, batch=2, seq=32, microbatches=2,
                            lr=2e-3, smoke=True, witness=(2e-3, 5e-2))
    return full, smoke.TRAIN_SMALL._replace(batch=4, seq=16)


def test_train_phase_runs_and_checks_itself(smoke, monkeypatch, capsys):
    """Phase 9 on the CPU: the training run through ``train.run``, its
    repeated-batch check, and the card-vs-CPU, microbatch and resume
    checks all run and hold; every line names the card."""
    full, small = _train_on_cpu(smoke, monkeypatch)
    smoke.run_train_phase(full, small, "cpu")
    out = capsys.readouterr().out
    for line in ("phase 9 train path", "path train:", "path train FLOPs",
                 "phase 9 train witness", "phase 9 train checks"):
        assert line in out, line
    assert all("CPU rehearsal" in l for l in out.splitlines()
               if l.startswith(("phase 9", "path train")))
    assert "optimizer step 3" in out and "(none)" in out
    assert not (ROOT / "build" / "chip_smoke_train_ckpt").exists()


@pytest.mark.parametrize("fault,match", [
    ("launch", "hand kernels launched"),
    ("repeat", "did not lower"),
    ("witness", "did not fall"),
    ("microbatch", "1 vs 2 microbatches"),
    ("resume", "2 \\+ 2 steps differ from 4"),
])
def test_train_phase_fails_on_a_broken_check(smoke, monkeypatch, fault,
                                             match):
    """Phase 9 fails when a hand kernel launched in the training steps,
    when a repeated batch's loss does not fall, when the witness's
    fresh-batch losses do not fall (a negative lr climbs the loss), when
    2 microbatches take the same slice twice, or when a resumed run
    ignores its checkpoint."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import overlap
    full, small = _train_on_cpu(smoke, monkeypatch)
    if fault == "launch":
        monkeypatch.setattr(smoke, "read_launches", lambda: {
            "decode_attn": 1})
    if fault == "repeat":
        full = full._replace(lr=0.0)
    if fault == "witness":
        full = full._replace(witness=(-5e-2,))
    if fault == "microbatch":
        real = overlap._microbatch
        monkeypatch.setattr(overlap, "_microbatch",
                            lambda b, k, i: real(b, k, 0))
    if fault == "resume":
        monkeypatch.setattr(CheckpointManager, "restore",
                            lambda self, template, step=None: (template, 2))
    with pytest.raises(RuntimeError, match=match):
        if fault in ("launch", "repeat"):
            smoke.run_train(full, "cpu")
        elif fault == "witness":
            smoke.train_witness(full, "cpu")
        elif fault == "microbatch":
            smoke.train_microbatches(small, "cpu")
        else:
            smoke.train_resume(small, "cpu")


def test_train_sizes_are_yi_6b_at_full_width(smoke):
    """Yi-6B's published widths, 16 of its 32 layers: 16 bytes a
    parameter of float32 AdamW state fit 80 GB at 16 layers, not at 32;
    the model FLOPs a step as counted."""
    from repro_torch.models import transformer as T
    tz = smoke.TRAIN_FULL
    assert (tz.steps, tz.batch, tz.seq, tz.microbatches, tz.layers,
            tz.compute, tz.lr) == (8, 2, 4096, 2, 16, "bfloat16", 3e-4)
    assert tz.witness and max(tz.witness) < tz.lr
    cfg = smoke.train_config(tz)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab, cfg.rope_theta) == (4096, 32, 4, 128, 11008, 64000,
                                           5e6)
    model = T.init_params(cfg, device="meta", trainable=True)
    n = sum(p.numel() for name, p in model.named_parameters()
            if name not in ("embed", "unembed"))
    assert n == 16 * 173_023_232 + 4096          # the layers, final_norm
    total = T.param_count(cfg, model)
    assert total == n + 524_288_000
    assert 16 * total < 80e9 < 16 * (total + n)      # 32 layers do not fit
    fl = smoke.train_flops(cfg, n, tz.batch, tz.seq)
    tokens = 2 * 4096
    pairs = 512 * 512 * sum(range(1, 9))            # causal chunks of 512
    assert fl["params"] == 6 * n * tokens
    assert fl["attention"] == 3 * 4 * 4096 * pairs * 2 * 16
    assert fl["unembed"] == 6 * 4096 * 64000 * tokens
    assert fl["model"] == fl["params"] + fl["attention"] + fl["unembed"]


def test_stage_mark_phase_runs_and_checks_itself(smoke, monkeypatch,
                                                 capsys):
    """Phase 2's stage_mark check on the CPU's plain version (no launch
    counted there) and the kernels line's stage_mark entry, its timing
    stubbed; ``run`` makes both."""
    import inspect
    src = inspect.getsource(smoke.run)
    assert "marks = check_marks(device)" in src
    assert "time_stage_mark(device, marks)" in src
    assert smoke.check_marks("cpu") == {"max_abs_err": 0.0, "launches": 0}

    def timed(fn, reps, tag, kernel=None, flush=None):
        assert kernel == "stage_mark_kernel"
        fn()
        return 2e-3, 5e-3
    monkeypatch.setattr(smoke, "_timed", timed)
    row = smoke.time_stage_mark("cpu", {"max_abs_err": 0.0, "launches": 7})
    assert row["name"] == "stage_mark" and row["launches"] == 7
    assert (row["ms"], row["wall_ms"]) == (2e-3, 5e-3)
    assert "kernel stage_mark a call" in capsys.readouterr().out


def test_main_prints_the_kernels_line_then_the_result_line(smoke,
                                                           monkeypatch,
                                                           capsys):
    """The line before the last is the kernels object and the last the
    contract's ``{"ok": true, "device": {...}}``, phase 12 the last phase
    of ``run``, after phases 10 and 11, each phase's memory freed."""
    import inspect
    src = inspect.getsource(smoke.run).rstrip().splitlines()
    assert [x.strip() for x in src[-8:-1]] == [
        "run_train_phase(TRAIN_FULL, TRAIN_SMALL, device)", "_free()",
        "run_graph_phase(sz, serve_sz, FLEET, device)", "_free()",
        "run_launch_phase(MESH_SERVE, device, kernels[\"kernels\"])",
        "_free()", "run_ranks_phase(sz, FLEET, device, kernels[\"kernels\"])"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    row = {k: 0 for k in ("name", "route", "source", "replaces", "launches",
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}
    monkeypatch.setattr(smoke, "run", lambda: {"kernels": [row]})
    assert smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2]) == {"kernels": [row]}
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "card", "count": 1}}


def _graph_rehearsal(smoke, monkeypatch):
    """Phase 10's sizes cut for the CPU, its card-only pieces stubbed:
    the profiler gives fixed numbers, the card line a fixed string."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smoke, "_card_line", lambda: "card, 700.00 W")

    def profile(tag, steps, unit, fn, kernel=None):
        for i in range(steps):
            fn(i)
        return dict(busy_share=0.5, ops=10.0, busy_ms=1.0)
    monkeypatch.setattr(smoke, "_profile", profile)
    monkeypatch.setattr(smoke, "GRAPH_TICKS", 3)
    monkeypatch.setattr(smoke, "GRAPH_SERVE_STEPS", 4)
    sz, fz, _, _ = _fleet_sizes(smoke)
    return sz, fz._replace(ticks=14), _serve_sizes(smoke, monkeypatch,
                                                   prompt_len=12, tokens=2)


def test_graph_phase_runs_and_checks_itself(smoke, monkeypatch, capsys):
    """Phase 10 on the CPU at a tiny size: each stream path, Yi-6B's
    smoke decode step and the fleet built once and run against
    ``capture.disable()``; every comparison runs and holds, the
    signature and graph counts are the card's (one each, two after the
    fleet's remesh), and each path prints its eager and graphed line."""
    sz, fz, serve_sz = _graph_rehearsal(smoke, monkeypatch)
    seen = []

    def bitwise(a, b, what):
        assert_bitwise(a, b, what)
        seen.append(what)
    st = smoke.graph_stream(sz, "cpu", bitwise)
    for name in ("staged", "fused"):
        g = st[name]["graphed"]
        assert (g["trace"], g["compiles"]) == (1, 1)
        assert len(g["secs"]) == smoke.GRAPH_TICKS + 5
    assert "graphed vs eager fused tick 7 leaf 5" in seen
    sv = smoke.graph_serve(serve_sz, "cpu", bitwise)
    assert sv["graphed"]["aot"] == 1 == sv["graphed"]["step"].trace_count
    assert "graphed vs eager decode step 3 logits" in seen
    fl = smoke.graph_fleet(sz, fz, "cpu", bitwise)
    assert fl["graphed"]["remesh"] == (2, 2)
    assert "graphed vs eager fleet tick 13 leaf 0" in seen
    smoke.run_graph_phase(sz, serve_sz, fz, "cpu")
    out = capsys.readouterr().out
    for tag in ("staged tick", "fused tick", "serve decode step",
                "fleet tick"):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"phase 10 {tag}: eager"))
        assert "graphed p50" in line and line.endswith("card, 700.00 W")


def test_graph_phase_fails_when_graphed_and_eager_differ(smoke, monkeypatch):
    """A tick that differs between the graphed and the eager run fails
    phase 10, naming the path and the tick."""
    sz, _, _ = _graph_rehearsal(smoke, monkeypatch)
    from repro_torch.runtime import capture
    real = capture.Step._replay

    def off(self, e):
        out = real(self, e)
        out[0].aggregates.add_(1.0)
        return out
    monkeypatch.setattr(capture.Step, "_replay", off)
    with pytest.raises(AssertionError, match="graphed vs eager staged tick 1"):
        smoke.graph_stream(sz, "cpu", assert_bitwise)


def test_launch_phase_mesh_checks_run_on_the_cpu(smoke, monkeypatch):
    """Phase 11's host-mesh checks on the CPU at Yi-6B's smoke widths:
    the serve runs with and without the gloo host mesh, every replayed
    step's logits bitwise, the card's launch count (the plain version
    counted as a launch), and the train steps with and without the
    mesh bitwise."""
    from repro_torch.kernels import decode_attn as DAP
    from repro_torch.kernels.decode_attn import ops as DA
    from repro_torch.launch import mesh as M
    real = DA._dispatch

    def counted(*a, **kw):
        DAP.decode_attention.launches += 1
        return real(*a, **kw)
    monkeypatch.setattr(DA, "_dispatch", counted)
    sz = smoke.ServeSizes(requests=2, prompt_len=5, tokens=3,
                          compute="float32", smoke=True)
    seen = []

    def bitwise(a, b, what):
        assert_bitwise(a, b, what)
        seen.append(what)
    host = M.make_host_mesh(device="cpu")
    try:
        sv = smoke.mesh_serve(sz, host, "cpu", bitwise)
        assert sv["launches"] == sv["n_attn"] * 8 == 16
        assert "mesh vs meshless step 7 logits" in seen
        line = smoke.mesh_train(host, "cpu", bitwise, steps=2)
        assert "float32, 2 steps" in line
        assert "mesh vs meshless train losses and grad norms" in seen
    finally:
        M.release_host_mesh()


def _dr(escalated, decisions, scores):
    n = len(decisions)
    feats = np.stack([np.asarray(scores, np.float32),
                      np.zeros(n, np.float32)], 1)
    return {"escalated": escalated, "stored": n - escalated, "dropped": 0,
            "features": feats, "decisions": decisions}


def test_launch_phase_holds_a_flip_to_the_threshold(smoke):
    """A disaster-recovery decision may differ card against CPU only
    where its score lies within the tolerance of the threshold."""
    launches = {"armatch": 0, "hilbert": 0}
    cpu = {("disaster_recovery_torch", "bfloat16"): (_dr(
        1, ["escalated", "stored"], [3.2, 3.0]), launches)}
    near = {("disaster_recovery_torch", "bfloat16"): (_dr(
        0, ["stored", "stored"], [3.19, 3.0]), launches)}
    line, = smoke._compare_examples(near, cpu)
    assert "1 decision(s) differ" in line
    far = {("disaster_recovery_torch", "bfloat16"): (_dr(
        1, ["escalated", "escalated"], [3.2, 3.0]), launches)}
    with pytest.raises(RuntimeError, match="away from the threshold"):
        smoke._compare_examples(far, cpu)


@pytest.mark.parametrize("score", [2.5, float("nan")])
def test_launch_phase_fails_on_scores_off_the_cpu(smoke, score):
    """A score off the CPU's fails the comparison, beside a feature that
    is 0 on both sides, and so does a NaN."""
    launches = {"armatch": 0, "hilbert": 0}
    cpu = {("disaster_recovery_torch", "float32"): (_dr(
        0, ["stored", "stored"], [3.0, 2.0]), launches)}
    card = {("disaster_recovery_torch", "float32"): (_dr(
        0, ["stored", "stored"], [3.0, score]), launches)}
    with pytest.raises(RuntimeError, match="features off the CPU"):
        smoke._compare_examples(card, cpu)


# -- phase 12: the control plane and remesh across ranks ---------------------

def test_phase12_control_and_remesh_over_two_gloo_ranks(smoke, monkeypatch,
                                                        capsys):
    """Phase 12's checks (i) and (ii) at 512 rows a shard over 2 gloo
    ranks (``launch.mesh.spawn`` of ``_rank_control_phase``) against one
    card in this process: the controlled arc without ``step_times`` and
    the remeshes 8 -> 6 -> 8, twice (form (a), payload requeued), every
    check the card's run makes but the launch counts; then a rank whose
    decision, payload or output row differs fails the check."""
    from repro_torch.launch import mesh as M
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    monkeypatch.syspath_prepend(str(ROOT))
    sz = smoke.Sizes(batch=512, d=16, window=64, stride=32,
                     capacity=1 << 12, ticks=4, cpu_ticks=2, dedupe=0,
                     warmup=1)
    fz = smoke.FLEET_SMALL._replace(core_budget=16, fog_budget=12)
    refs = smoke.phase12_control_references(sz, fz, "cpu")
    parts = M.spawn(smoke._rank_control_phase, 2, "cpu", sz, fz)
    got = smoke.check_phase12_control(refs, parts, fz, launches=False)
    assert got["ticks"] > smoke.CONTROL_TICKS and got["payload"] > 0
    assert got["idle"] == [] and got["flagged"] > 0
    assert got["backup"] // fz.edges == smoke.CONTROL_CHURN[0] // fz.edges
    assert [len(p["remesh"]["decisions"]) for p in parts] == \
        [(1 + len(smoke.REMESH_WIDTHS)) * smoke.REMESH_TICKS] * 2
    smoke.print_phase12_control(refs, parts, got, "CPU rehearsal")
    out = capsys.readouterr().out
    assert "phase 12 (i) controlled fleet across 2 gloo" in out
    assert "phase 12 (ii) remesh across 2 gloo" in out
    for fault, match in (("decision", "decision at tick 3"),
                         ("payload", "payload"), ("row", "tick 1's outputs")):
        bad = [dict(p, control=dict(p["control"]),
                    remesh=dict(p["remesh"])) for p in parts]
        if fault == "decision":
            bad[1]["control"]["decisions"] = [
                dict(d, budget=d["budget"] + (i == 3))
                for i, d in enumerate(bad[1]["control"]["decisions"])]
        elif fault == "payload":
            bad[1]["remesh"]["payload"] = {}
        else:
            outs = [dict(o) for o in bad[1]["control"]["outs"]]
            outs[1][0] = [d + 1 for d in outs[1][0]]
            bad[1]["control"]["outs"] = outs
        with pytest.raises(RuntimeError, match=match):
            smoke.check_phase12_control(refs, bad, fz, launches=False)


#: (vi)-(viii) rehearsed at Kimi-K2's smoke config (E 8 top-2, a shared
#: expert): at 16 requests a rank, 4 of its 14 MoE calls plan the 32
#: global tokens otherwise than each rank's 16 would (Mixtral's smoke
#: config, E 4, needs 64 a rank for any)
MOE_SIZES = dict(arch="kimi_k2_1t_a32b", smoke=True)


@pytest.fixture(scope="module")
def phase12_models(smoke):
    """Phase 12's (iii)-(viii) over 2 gloo ranks (one spawn of
    ``_rank_models_phase``) and the one-card references in this process:
    (sizes, (iii)'s references, (vi)'s, the ranks' records)."""
    from repro_torch.launch import mesh as M
    sv = smoke.ServeSizes(requests=2, prompt_len=4, tokens=3,
                          compute="float32", smoke=True)
    check = smoke.TrainSizes(steps=2, batch=2, seq=16, microbatches=2,
                             compute="float32", lr=2e-3, smoke=True)
    full = smoke.TrainSizes(steps=3, batch=2, seq=16, microbatches=2,
                            smoke=True)
    moe = (smoke.ServeSizes(requests=16, prompt_len=4, tokens=3,
                            compute="float32", **MOE_SIZES),
           smoke.ServeSizes(requests=16, prompt_len=4, tokens=3,
                            **MOE_SIZES),
           check._replace(**MOE_SIZES), full._replace(**MOE_SIZES))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "chip_smoke", smoke)
        mp.syspath_prepend(str(ROOT))
        refs = smoke.phase12_model_references(sv, "cpu", 2)
        parts = M.spawn(smoke._rank_models_phase, 2, "cpu", sv, check, full,
                        moe)
    moe_ref = smoke.phase12_moe_reference(
        moe[0], "cpu", [p["moe_serve"] for p in parts])
    return (sv, check, full, moe), refs, moe_ref, parts


def test_phase12_models_over_two_gloo_ranks(smoke, phase12_models, capsys):
    """Phase 12's (iii)-(v) at Yi-6B's smoke config over 2 gloo ranks
    (``launch.mesh.spawn`` of ``_rank_models_phase``) against one card in
    this process: each rank's served rows equal to one card serving them,
    the ids gathered on every rank, the train step's losses and
    parameters against one card and every replica equal after every
    step, every check but the launch counts; then a rank whose replica
    digest, served ids or gathered ids differ fails the check."""
    (sv, check, full, _), refs, _, parts = phase12_models
    smoke.check_phase12_models(refs, parts, sv, launches=False)
    assert [p["serve"]["shape"] for p in parts] == [(4, 3)] * 2
    assert parts[0]["train_check"]["loss_err"] <= smoke.TRAIN_CARD_VS_CPU
    assert parts[0]["train_check"]["grad_err"] <= smoke.TRAIN_CARD_VS_CPU
    assert all(p["train_full"]["ranks"] == 2 for p in parts)
    assert len(parts[0]["train_full"]["ar_secs"]) == smoke.RANK_GRAD_REPS
    assert parts[0]["train_full"]["ar_sent"] == \
        parts[0]["train_full"]["grad_bytes"]
    smoke.print_phase12_models(refs, parts, sv, check, full,
                               "CPU rehearsal")
    out = capsys.readouterr().out
    for tag in ("(iii) serve", "(iv) train", "(v) train"):
        assert f"phase 12 {tag} across 2 gloo" in out, tag
    assert all("CPU rehearsal" in l for l in out.splitlines()
               if l.startswith("phase 12"))
    for fault, match in (
            ("replica", "rank 1's replica differs from rank 0's after step 1"),
            ("check", "\\(iv\\): rank 1's replica differs"),
            ("ids", "rank 1's served ids differ"),
            ("gathered", "rank 0's gathered ids")):
        bad = [dict(p, serve=dict(p["serve"]),
                    train_check=dict(p["train_check"]),
                    train_full=dict(p["train_full"])) for p in parts]
        if fault in ("replica", "check"):
            key = "train_full" if fault == "replica" else "train_check"
            digests = [list(d) for d in bad[1][key]["digests"]]
            digests[1][0] += 1
            bad[1][key]["digests"] = digests
        elif fault == "ids":
            bad[1]["serve"]["ids"] += 1
        else:
            bad[0]["serve"]["gathered"] = bad[0]["serve"]["gathered"][::-1]
        with pytest.raises(RuntimeError, match=match):
            smoke.check_phase12_models(refs, bad, sv, launches=False)


def test_phase12_moe_over_two_gloo_ranks(smoke, phase12_models, capsys):
    """Phase 12's (vi)-(viii) at Kimi-K2's smoke config over 2 gloo
    ranks: one card serving all 32 requests in one run on the ranks'
    path picks every id they generated (float32 on the CPU: no near
    tie), some MoE call's global plan differs from the per-rank plans,
    the late step's routing and logits agree, the MoE train check
    against one card and every replica equal after every step, every
    check but the launch counts; the lines name the backend and the card
    line.  An MoE size for (iii)'s per-rank reference raises."""
    (sv, _, _, moe), _, ref, parts = phase12_models
    assert ref["differing"] > 0 and ref["calls"] == 2 * 7
    got = smoke.check_phase12_moe(ref, parts, *moe[:2], launches=False)
    assert got["ties"] == [] and got["flips"] == [] and got["moved"] == []
    assert got["generated"] == 32 * 3
    assert max(got["final"]) <= smoke.SERVE_KERNEL_VS_PLAIN
    assert got["late"] <= smoke.SERVE_KERNEL_VS_PLAIN
    with pytest.raises(ValueError, match="MoE model"):
        smoke.phase12_model_references(moe[0], "cpu", 2)
    c = parts[0]["moe_check"]
    assert c["losses_err"] <= smoke.RANK_MOE_LOSS
    assert parts[0]["moe_serve"]["tokens"].shape == (32, 3)
    smoke.print_phase12_moe(ref, parts, got, *moe, "CPU rehearsal")
    out = capsys.readouterr().out
    for tag in ("(vi) MoE serve", "(vii) MoE train", "(viii) MoE train"):
        assert f"phase 12 {tag} across 2 gloo" in out, tag
    assert all("CPU rehearsal" in l for l in out.splitlines()
               if l.startswith("phase 12"))


@pytest.mark.parametrize("fault,match", [
    ("rank ids", "rank 1's gathered ids"),
    ("ids", "would not pick, by more than a near tie"),
    ("same plans", "tests nothing"),
    ("logits", "the late step's logits differ"),
    ("replica", "\\(viii\\): rank 1's replica differs"),
])
def test_phase12_moe_check_fails_on_a_broken_rank(smoke, phase12_models,
                                                  fault, match):
    """(vi)'s check fails on a rank whose ids differ from rank 0's, on
    ids one card would not pick (every rank's gathered ids changed at
    one step, and the card's reference taken on them), on late logits off by more than the tolerance, and
    when no MoE call's global plan differs from the per-rank plans (the
    check would test nothing); (viii)'s on a replica that differs."""
    (_, _, _, moe), _, ref, parts = phase12_models
    bad = [dict(p, moe_serve=dict(p["moe_serve"]),
                moe_full=dict(p["moe_full"])) for p in parts]
    if fault == "rank ids":
        tokens = bad[1]["moe_serve"]["tokens"].copy()
        tokens[5, 2] = (tokens[5, 2] + 1) % 256
        bad[1]["moe_serve"]["tokens"] = tokens
    elif fault == "ids":            # every rank's step 2, every request,
        tokens = bad[0]["moe_serve"]["tokens"].copy()   # the card on them
        tokens[:, 2] = (tokens[:, 2] + 97) % 256
        for part in bad:
            part["moe_serve"]["tokens"] = tokens
        ref = smoke.phase12_moe_reference(
            moe[0], "cpu", [p["moe_serve"] for p in bad])
    elif fault == "same plans":
        ref = dict(ref, differing=0)
    elif fault == "logits":
        bad[0]["moe_serve"]["late"] = bad[0]["moe_serve"]["late"] * 1.2
    else:
        digests = [list(d) for d in bad[1]["moe_full"]["digests"]]
        digests[2][0] += 1
        bad[1]["moe_full"]["digests"] = digests
    with pytest.raises(RuntimeError, match=match):
        smoke.check_phase12_moe(ref, bad, *moe[:2], launches=False)
