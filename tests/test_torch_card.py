"""The CUDA kernels against their plain versions on the card, bitwise
(NaN matches NaN), through the shared checks of
``repro_torch.kernels.checks``: the full-width stream tick's block plus
ragged shapes, NaN rows and empty windows; the AR data plane's routing
batch (hilbert) and its two match shapes (armatch) plus ragged ones;
the Yi-6B and RecurrentGemma-2B serve steps' decode attention
(decode_attn, to a stated tolerance, float32 and bfloat16) plus the
reference's test shapes.  Then decode_attn's split clusters (1,000 calls
of each fast instance at 2 and 4 splits, with length-0 rows, each
bitwise the first), and the compile-once steps (``runtime.capture``)
graphed against ``capture.disable()``, bitwise: the stream tick staged
and fused, the fleet tick with masks and budgets changed after the
capture, and the decode step the registry captures ahead of time; the
replays count the launches eager makes.  Needs a CUDA card and
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


# -- decode_attn's cluster start (fault A) -------------------------------------

#: (dtype, d, b, h, hkv, s) of each fast instance at 2 and at 4 splits a
#: (b, KV head): one block an SM splits 132 SMs over b x hkv, so 64
#: (b, KV head) pairs give 2 splits and 32 give 4
CLUSTER_CASES = [(dtype, d, b, hkv * g, hkv, 1088)
                 for dtype, dims, g in ((torch.bfloat16, (16, 32, 64, 128, 256),
                                         8),
                                        (torch.float32, (16, 32, 64, 128), 8))
                 for d in dims for b, hkv in ((16, 4), (8, 4))]
CLUSTER_CALLS = 1000


@pytest.mark.parametrize("dtype,d,b,h,hkv,s", CLUSTER_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_decode_attn_clusters_repeat_bitwise(card, dtype, d, b, h, hkv, s):
    """Every block of a split cluster writes into the leader's shared
    memory only after the whole cluster has started: 1,000 calls of each
    fast instance at 2 and 4 splits, with length-0 rows and rows whose
    length ends inside the first split, all give the first call's bits."""
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.decode_attn.ops import (SUB_ROWS, plan_for,
                                                     split_starts, warps)
    gen = torch.Generator(card).manual_seed(21)
    q = torch.randn((b, h, d), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen,
                        device=card).to(dtype) for _ in range(2))
    how = plan_for(q, k, v, hkv)
    want = 2 if b * hkv == 64 else 4
    assert how.instance != "generic" and how.n_split == want, how
    unit = SUB_ROWS * warps(dtype, d)
    first = split_starts(s, how.n_split, unit)[1]
    pattern = [0, 1, 3, unit - 1, first - 1, 0, first // 2, s]
    lengths = torch.tensor([pattern[i % len(pattern)] for i in range(b)],
                           dtype=torch.int32, device=card)
    first_out = decode_attention(q, k, v, lengths, num_kv_heads=hkv)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    ref = first_out.view(bits)
    differ = torch.zeros((), dtype=torch.int64, device=card)
    for _ in range(CLUSTER_CALLS - 1):
        out = decode_attention(q, k, v, lengths, num_kv_heads=hkv)
        differ += (out.view(bits) != ref).any()
    torch.cuda.synchronize()
    assert int(differ) == 0, f"{int(differ)} of {CLUSTER_CALLS - 1} calls"
    assert torch.isfinite(first_out.float()).all()
    zero = [i for i in range(b) if pattern[i % len(pattern)] == 0]
    assert (first_out[zero] == 0).all()


# -- the compile-once step: graphed against capture.disable() -------------------

class _Clock:
    """Stands in for an executor module's ``time``: the same wall
    stamps in two runs."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _same(a, b, what):
    from repro_torch.runtime import capture
    la = [t for t in capture.flatten(a)[0] if isinstance(t, torch.Tensor)]
    lb = [t for t in capture.flatten(b)[0] if isinstance(t, torch.Tensor)]
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y)), \
            f"{what}: leaf {i} differs"


def _stream(card, fused, batch=4096):
    from repro_torch import convert
    from repro_torch.core import pipeline as P
    from repro_torch.core import rules as R
    from repro_torch.stream import StreamConfig, StreamExecutor
    import numpy as np
    cfg = StreamConfig(micro_batch=batch, window=64, stride=32,
                       capacity=1 << 16, lateness=64.0, fused=fused)
    engine = R.RuleEngine([
        R.threshold_rule("hot_mean", 0, ">=", 0.25, R.C_SEND_CORE,
                         priority=1),
        R.threshold_rule("sparse", 4, "<", 8.0, R.C_STORE_EDGE,
                         priority=2)])
    p = convert.params_from_numpy(
        (np.random.default_rng(0).standard_normal((21, 21)) * 0.1)
        .astype(np.float32), card)

    def core(p, b):
        h = b
        for _ in range(8):
            h = torch.tanh(h @ p)
        return h, b[:, :5]
    pipe = P.two_tier_pipeline(lambda p, b: (b, b[:, :5]), core, engine,
                               core_params=p,
                               core_capacity=cfg.windows_per_step // 4)
    ex = StreamExecutor(cfg, engine, pipe, device=card)
    return ex, ex.init_state(16)


def _tick_feed(card, i, batch=4096):
    gen = torch.Generator(card).manual_seed(100 + i)
    items = torch.randn((batch, 16), generator=gen, device=card)
    if i % 3 == 0:
        items[:, 0] += 0.5
    ts = torch.arange(batch, dtype=torch.float32, device=card) + i * batch
    return items, ts


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
def test_graphed_stream_tick_equals_eager(card, fused, monkeypatch):
    """The captured tick against ``capture.disable()``: every
    ``StepOutput`` and the final state bitwise over 12 ticks, with a
    new budget, a backfill tick and live ticks after the capture; one
    signature, one graph; the replays count the launches eager makes."""
    from repro_torch.kernels.fused_tick import fused_tick
    from repro_torch.kernels.window_reduce import window_reduce
    from repro_torch.runtime import capture
    from repro_torch.stream import executor as TX
    from repro_torch.stream import ingest as I
    kernel = fused_tick if fused else window_reduce
    runs = []
    for eager in (False, True):
        monkeypatch.setattr(TX, "time", _Clock())
        ex, st = _stream(card, fused)
        before = kernel.launches
        outs = []
        with capture.disable() if eager else torch.no_grad():
            for i in range(12):
                if i == 5:
                    ex.set_core_budget(3)
                mode = I.MODE_BACKFILL if i == 6 else I.MODE_LIVE
                st, out = ex.step(st, *_tick_feed(card, i), mode=mode)
                outs.append(out)
        torch.cuda.synchronize()
        runs.append((ex, st, outs, kernel.launches - before))
    (gx, gs, go, gl), (ex, es, eo, el) = runs
    for i, (a, b) in enumerate(zip(go, eo)):
        _same(a, b, f"tick {i}")
    _same(gs, es, "final state")
    _same(gx._lineage, ex._lineage, "lineage")
    assert gx.trace_count == 1 == gx._compile_count()
    assert gl == el == 12 * (1 if fused else 5)


def test_graphed_fleet_tick_equals_eager(card, monkeypatch):
    """The fused fleet tick captured: a health flip, a membership flip,
    a core and a region budget change and a replay tick after the
    capture, bitwise against ``capture.disable()``."""
    import numpy as np
    from repro_torch.core import pipeline as P
    from repro_torch.core import rules as R
    from repro_torch.runtime import capture
    from repro_torch.stream import StreamConfig
    from repro_torch.stream.fleet import FleetConfig, FleetExecutor
    from repro_torch.stream.fleet import executor as FX
    scfg = StreamConfig(micro_batch=2048, window=64, stride=32,
                        capacity=1 << 14, lateness=64.0, fused=True)
    engine = R.RuleEngine([R.threshold_rule("hot", 0, ">=", 0.25,
                                            R.C_SEND_CORE)])
    runs = []
    for eager in (False, True):
        monkeypatch.setattr(FX, "time", _Clock())
        fx = FleetExecutor(
            FleetConfig(stream=scfg, num_shards=8, num_regions=2, num_core=2,
                        core_budget=64, fog_budget=48),
            engine, P.two_tier_pipeline(
                lambda p, b: (b, b[:, :5]),
                lambda p, b: (torch.tanh(b * 1.5), b[:, :5]), engine),
            device=card)
        st = fx.init_state(16)
        rng = np.random.default_rng(3)
        outs = []
        with capture.disable() if eager else torch.no_grad():
            for t in range(10):
                if t == 3:
                    fx.set_health([True] * 5 + [False] + [True] * 2)
                    fx.set_core_budget(16)
                if t == 5:
                    fx.set_active([True] * 7 + [False])
                    fx.set_region_budget([8, 40])
                items = torch.from_numpy(rng.standard_normal(
                    (8, 2048, 16)).astype(np.float32)).to(card)
                ts = torch.arange(2048, dtype=torch.float32,
                                  device=card).repeat(8, 1) + t * 2048
                mode = np.where(np.arange(8) == 2, int(t == 6), 0)
                st, out = fx.step(st, items, ts, mode=mode)
                outs.append(out)
        runs.append((fx, st, outs))
    (gx, gs, go), (ex, es, eo) = runs
    for i, (a, b) in enumerate(zip(go, eo)):
        _same(a, b, f"fleet tick {i}")
    _same(gs, es, "final fleet state")
    assert gx.trace_count == 1 == gx._compile_count()


def test_graphed_decode_step_equals_eager(card):
    """The serve step captured ahead of time by the registry (warm-up
    on copies of the caches, first call a replay) against the same step
    under ``capture.disable()``: the logits of 24 teacher-forced steps
    bitwise, the caches at the end bitwise, one decode_attn launch a
    layer a step either way."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.core import profiles as P
    from repro_torch.core.serverless import FunctionRegistry
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.runtime import capture
    cfg = smoke_config("yi_6b")
    model = T.init_params(cfg, seed=0, device=card)
    b, n = 4, 24
    prompts = torch.randint(0, cfg.vocab, (b, n), device=card,
                            generator=torch.Generator(card).manual_seed(5),
                            dtype=torch.int32)
    runs = []
    for eager in (False, True):
        caches = T.init_caches(cfg, b, n, card)
        lengths = torch.zeros((b,), dtype=torch.int32, device=card)
        reg = FunctionRegistry(card)
        reg.store_function("decode", P.profile("serve"),
                           steps_mod.build_serve_step(cfg))
        with capture.disable() if eager else torch.no_grad():
            [(_, step)] = reg.start_function(
                P.ProfileBuilder().add_single("serve").build(), model,
                prompts[:, :1], caches, lengths, donate_argnums=(2, 3))
            before = decode_attention.launches
            logits = []
            for t in range(n):
                out, caches, lengths = step(model, prompts[:, t:t + 1],
                                            caches, lengths)
                logits.append(out)
        torch.cuda.synchronize()
        runs.append((logits, caches, lengths,
                     decode_attention.launches - before, step))
    (gl, gc, glen, gn, gstep), (el, ec, elen, en, _) = runs
    for t, (a, e) in enumerate(zip(gl, el)):
        _same(a, e, f"decode step {t} logits")
    _same(gc, ec, "caches")
    _same(glen, elen, "lengths")
    assert gn == en == n * cfg.n_layers
    assert gstep.trace_count == 1 == gstep.compile_count
