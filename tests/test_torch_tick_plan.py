"""The stream-tick kernels' launch plans and launch accounting, on the
CPU: ``kernels/span.py``'s plan at the tick's shapes and at the ragged
ones of ``kernels/checks.py`` (every kept window in exactly one block, a
block's staged rows covering its windows' reach inside the block, shared
memory that fits, at least 64 blocks at d = 1), the span copy's chunk
walk, the launcher called once a call with the planned instance through a
stand-in for the compiled library, the simple instance counted, and the
constants the wrappers and ``csrc/`` share."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import checks, span
from repro_torch.kernels.fused_tick import fused_tick, fused_tick_ref
from repro_torch.kernels.fused_tick import ops as fops
from repro_torch.kernels.window_reduce import (sliding_reduce,
                                               sliding_reduce_ref,
                                               window_reduce)
from repro_torch.kernels.window_reduce import ops as wops
from repro_torch.testing import assert_bitwise

CSRC = Path(span.__file__).resolve().parent / "csrc"

#: (t, d, window, stride) of one full-width tick: a 65,536-row
#: micro-batch behind a 32-row carry, 16 features, W = 64, S = 32
TICK = (65568, 16, 64, 32)


def _wr_cases():
    """(rows, d, window, stride, nw) of every window_reduce call the card
    checks make: the staged tick's two widths and the ragged shapes."""
    t, d, w, s = TICK
    out = [(t, d, w, s, (t - w) // s + 1), (t, 1, w, s, (t - w) // s + 1)]
    for t, d, w, s, partial in checks.WINDOW_REDUCE_RAGGED:
        nw = -(-t // s) if partial else (t - w) // s + 1
        out.append(((nw - 1) * s + w, d, w, s, nw))
    return out


def _ft_cases():
    """(t, ld, window, stride) of every fused_tick call the card checks
    make: the tick's block (2 + D columns) and the ragged shapes."""
    t, d, w, s = TICK
    return [(t, 2 + d, w, s)] + [(t, 2 + d, w, s) for t, d, w, s in
                                 checks.FUSED_TICK_RAGGED]


def _plans():
    for rows, d, w, s, nw in _wr_cases():
        yield f"window_reduce {rows}x{d}", wops.plan(d, w, s, nw), rows, d, \
            w, s, nw, False
    for t, ld, w, s in _ft_cases():
        yield f"fused_tick {t}x{ld}", fops.plan(t, ld, w, s), t, ld, w, s, \
            (t - w) // s + 1, True


@pytest.mark.parametrize("case", list(_plans()), ids=lambda c: c[0])
def test_plan_covers_every_window_once_inside_the_block(case):
    _, p, rows, ld, w, s, nw, mask = case
    owner = np.zeros(nw, np.int64)
    for b in range(p.blocks):
        k0 = b * p.k
        owner[k0:min(k0 + p.k, nw)] += 1
        # the rows the kernel stages: its windows' reach
        first, end = k0 * s, (min(k0 + p.k, nw) - 1) * s + w
        assert all(first <= i * s and i * s + w <= end
                   for i in range(k0, min(k0 + p.k, nw)))
        assert end <= rows                    # never past the block
        # the tiles staged in turn cover the span, each within the plan's
        # rows and its shared memory
        tiles = range(first, end, p.tile_rows)
        assert tiles[0] == first and tiles[-1] + p.tile_rows >= end
    assert (owner == 1).all()
    assert p.blocks == -(-nw // p.k)
    assert p.threads % span.WARP == 0 and p.threads <= span.MAX_THREADS
    assert p.smem_bytes == span.smem_bytes(p.tile_rows, ld, s, p.pad, mask)
    assert p.smem_bytes <= span.SMEM_DEFAULT
    assert p.pad % 4 == 0


def test_plan_at_the_tick_shapes():
    """Both kernels take 8 windows a block at the tick (256 blocks, two
    on each of the card's 132 SMs), the whole 288-row span staged at
    once; at d = 1 that is still 256 blocks (at least 64), and the bank
    pad makes a step's shared-memory reads conflict-free at both staged
    widths."""
    t, d, w, s = TICK
    nw = (t - w) // s + 1
    ft = fops.plan(t, 2 + d, w, s)
    wr16, wr1 = wops.plan(d, w, s, nw), wops.plan(1, w, s, nw)
    for p in (ft, wr16, wr1):
        assert (p.k, p.blocks, p.tile_rows) == (8, 256, 288)
    assert wr1.blocks >= 64
    assert (ft.threads, wr16.threads, wr1.threads) == (160, 128, 32)
    assert span.bank_cost(8, d, d, s, wr16.pad, wr16.threads) == 4
    assert span.bank_cost(8, 1, 1, s, wr1.pad, wr1.threads) == 1
    assert ft.smem_bytes < 21 * 1024


def test_plan_tiles_a_span_larger_than_its_budget():
    """A window too long for one tile is staged in tiles of whole stride
    groups; a row wider than 48 KB asks for more shared memory (up to the
    SM's 227 KB); a row wider than that raises."""
    p = wops.plan(16, 5000, 2000, 100)
    assert p.k == 1 and p.tile_rows < 5000
    assert p.smem_bytes <= span.TILE_BYTES
    wide = wops.plan(20000, 8, 8, 10)
    assert wide.tile_rows == 1
    assert span.SMEM_DEFAULT < wide.smem_bytes <= span.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        wops.plan(60000, 8, 8, 10)


def _copy_walk(h, n, group, pad, threads):
    """The cp.async walk of ``span::stage`` for a tile ``h`` floats past
    a 16-byte boundary, as the kernel runs it: {destination: source
    float} over every thread's chunks, and the 16-byte copies made."""
    dst, wide = {}, 0
    step = 4 * threads
    for tid in range(threads):
        lo = 4 * tid - h
        q = max(lo, 0) // group
        rem = max(lo, 0) - q * group
        while lo < n:
            if lo >= 0 and lo + 4 <= n and rem + 4 <= group:
                assert (h + lo + pad * q) % 4 == 0    # 16-byte aligned
                for e in range(4):
                    dst.setdefault(h + lo + e + pad * q, []).append(lo + e)
                wide += 1
            else:
                for e in range(4):
                    f = lo + e
                    if 0 <= f < n:
                        dst.setdefault(h + f + pad * (f // group),
                                       []).append(f)
            rem += step + min(lo, 0)
            while rem >= group:
                rem -= group
                q += 1
            lo += step
    return dst, wide


@pytest.mark.parametrize("h,n,group,pad,threads", [
    (0, 288 * 18, 32 * 18, 0, 160),      # the fused tick's tile
    (2, 288 * 18, 32 * 18, 0, 160),      # seq[1:]: 72 bytes in
    (1, 40 * 5, 8 * 5, 4, 32),           # ragged, padded groups
    (3, 14 * 3, 3 * 3, 4, 32),           # groups of 9 floats
    (0, 1056, 32, 4, 32),                # the d = 1 column
    (1, 1056, 32, 4, 32),
])
def test_copy_walk_lands_every_float_once_in_the_layout(h, n, group, pad,
                                                         threads):
    dst, wide = _copy_walk(h, n, group, pad, threads)
    assert sorted(dst) == [h + f + pad * (f // group) for f in range(n)]
    assert all(len(v) == 1 and d == h + v[0] + pad * (v[0] // group)
               for d, v in dst.items())
    # 4-byte copies only at the two ragged edges and at group borders
    chunks = (h + n + 3) // 4
    assert chunks - wide <= n // group + 2
    if h == 0 and group % 4 == 0 and n % 4 == 0:
        assert wide == chunks


class _FakeLib:
    """Stands in for the compiled libraries: records each launch."""

    def __init__(self):
        self.calls = []

    def window_reduce_f32(self, x, out, nw, d, window, stride, op, instance,
                          k, tile_rows, pad, threads, smem, stream):
        self.calls.append((nw, d, op, instance, k, tile_rows, pad, threads,
                           smem))
        return 0

    def fused_tick_f32(self, seq, ld, valid, nw, l, sc, d, window, stride,
                       rules, n_rules, min_count, agg, feats, wcount,
                       w_birth, cons, instance, k, tile_rows, pad, threads,
                       smem, stream):
        self.calls.append((ld, nw, l, instance, k, tile_rows, pad, threads,
                           smem))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    for ops, wrapper in ((wops, window_reduce), (fops, fused_tick)):
        monkeypatch.setattr(ops, "_lib", lambda: lib)
        monkeypatch.setattr(ops, "_stream", lambda device: 0)
        monkeypatch.setattr(wrapper, "launches", 0)
        monkeypatch.setattr(wrapper, "simple_launches", 0)
    return lib


@pytest.mark.parametrize("instance", [None, "simple"])
@pytest.mark.parametrize("d", [16, 1])
def test_window_reduce_launches_once_a_call(fake, d, instance):
    t, _, w, s = TICK
    nw = (t - w) // s + 1
    xp = torch.zeros((t, d))
    for i in range(1, 3):
        out = wops._launch(xp, w, s, nw, "max", instance or "span")
        assert out.shape == (nw, d)
        assert window_reduce.launches == i
        assert window_reduce.simple_launches == (i if instance else 0)
    p = wops.plan(d, w, s, nw)
    want = (nw, d, 1, 0, 0, 0, 0, 0, 0) if instance else \
        (nw, d, 1, 1, p.k, p.tile_rows, p.pad, p.threads, p.smem_bytes)
    assert fake.calls == [want] * 2


@pytest.mark.parametrize("instance", [None, "simple"])
def test_fused_tick_launches_once_a_call(fake, instance):
    t, d, w, s = TICK
    nw = (t - w) // s + 1
    seq = torch.zeros((t, 2 + d))
    valid = torch.ones(t, dtype=torch.bool)
    rows = fops._rule_rows(checks.TICK_TABLE)
    for i in range(1, 3):
        out = fops._launch(seq, valid, w, s, rows, 1, 2, nw, d, instance)
        assert [o.shape for o in out] == [(nw, d), (nw,), (nw, 5), (nw,),
                                          (nw,)]
        assert fused_tick.launches == i
        assert fused_tick.simple_launches == (i if instance else 0)
    p = fops.plan(t, 2 + d, w, s)
    want = (2 + d, nw, 1 + d, 0, 0, 0, 0, 0, 0) if instance else \
        (2 + d, nw, 1 + d, 1, p.k, p.tile_rows, p.pad, p.threads,
         p.smem_bytes)
    assert fake.calls == [want] * 2


def test_window_reduce_skips_an_empty_call(fake):
    out = wops._launch(torch.zeros((8, 0)), 8, 8, 1, "sum", "span")
    assert out.shape == (1, 0) and fake.calls == []
    assert window_reduce.launches == 0


@pytest.mark.parametrize("instance", ["simple", "span", None])
def test_cpu_takes_the_plain_version_whatever_the_instance(instance):
    gen = torch.Generator().manual_seed(4)
    x, valid = checks.block(gen, 96, 3, "cpu")
    seq = torch.cat([torch.arange(96.0)[:, None], x], dim=1)
    before = (window_reduce.launches, window_reduce.simple_launches,
              fused_tick.launches, fused_tick.simple_launches)
    got = sliding_reduce(x, 16, 8, 11, "max", instance=instance)
    assert_bitwise(got, sliding_reduce_ref(x, 16, 8, 11, "max"), "max")
    got = fused_tick(seq, valid, 16, 8, table=checks.TICK_TABLE,
                     instance=instance)
    for a, b in zip(got, fused_tick_ref(seq, valid, 16, 8, checks.TICK_TABLE)):
        assert_bitwise(a, b, "fused")
    assert before == (window_reduce.launches, window_reduce.simple_launches,
                      fused_tick.launches, fused_tick.simple_launches)


def test_wrappers_reject_an_instance_they_do_not_have():
    with pytest.raises(ValueError, match="instance"):
        sliding_reduce(torch.zeros((16, 2)), 8, 8, 2, "sum", instance="fast")
    with pytest.raises(ValueError, match="instance"):
        fused_tick(torch.zeros((16, 4)), torch.ones(16, dtype=torch.bool), 8,
                   8, table=checks.TICK_TABLE, instance="narrow")


def _constexpr(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([0-9* ]+);", src)
    return eval(m.group(1), {})          # noqa: S307 -- a product of ints


def test_kernel_sources_agree_with_the_wrappers():
    """The layout constants of ``span.cuh`` are ``span.py``'s; each
    kernel has its span and simple instance under the names
    ``chip_smoke.py`` counts in a trace; the instance, op and rule-table
    codes are the wrappers'; a block above 48 KB asks for more."""
    hdr = (CSRC / "span.cuh").read_text()
    for name, value in (("kWarp", span.WARP),
                        ("kMaxThreads", span.MAX_THREADS),
                        ("kSmemMax", span.SMEM_MAX),
                        ("kSmemDefault", span.SMEM_DEFAULT),
                        ("kHeadFloats", span.HEAD_FLOATS)):
        assert _constexpr(hdr, name) == value, name
    assert re.search(r"if \(smem <= kSmemDefault\) return 0;\s+return \(int\)"
                     r"cudaFuncSetAttribute\(\s+kernel, "
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize", hdr)
    for name, ops in (("window_reduce", wops), ("fused_tick", fops)):
        src = (CSRC / f"{name}.cu").read_text()
        kernels = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                 r"\([^)]*\)\s+)?(\w+)", src))
        assert kernels == {f"{name}_kernel_span", f"{name}_kernel_simple"}
        codes = re.search(r"enum Instance \{ kSimple = (\d), kSpan = (\d) \};",
                          src)
        assert tuple(map(int, codes.groups())) == (
            ops.INSTANCES["simple"], ops.INSTANCES["span"])
    ops_src = (CSRC / "window_reduce.cu").read_text()
    codes = re.search(r"enum Op \{ kSum = (\d), kMax = (\d), kMin = (\d) \};",
                      ops_src)
    assert tuple(map(int, codes.groups())) == tuple(
        wops._OP_CODE[k] for k in ("sum", "max", "min"))
    ft_src = (CSRC / "fused_tick.cu").read_text()
    assert _constexpr(ft_src, "kMaxRules") == fops.MAX_RULES
