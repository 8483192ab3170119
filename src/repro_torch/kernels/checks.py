"""Each hand-written kernel held against its plain version: bitwise,
but for ``decode_attn``, which is held to a stated tolerance.

One copy of the comparisons that ``chip_smoke.py`` (phase 2) and
``tests/test_torch_card.py`` run on the card.  The stream-tick checks
take the full-width block ``(t, d, window, stride)`` of a tick (and,
for window_reduce, the staged tick's ``[t, 1]`` columns), a view of it
off 16 bytes, and ragged small shapes; every block carries NaN rows and
a run of invalid rows long enough to empty whole windows, and on the
card each call of the planned instance is also held against the simple
one.  The AR checks take the
routing step's batch (hilbert) and the data plane's two match shapes
(armatch) and add ragged ones.  The decode check takes the serve
step's cache shape, with lengths on the split edges, the reference's
test shapes and the configurations' other head shapes.  The stage_mark
check marks rings of the tracer's shape and of its calibration probe's
through more ticks than they hold rows.  On a CUDA device
each kernel call is also held against the same call on the CPU, and
must raise its wrapper's launch count by one.  Every check returns the
largest finite absolute difference it saw between a kernel and what it
is held against (0.0 when bitwise equal).

:func:`random_profiles` makes encoded AR profiles in bulk with numpy,
for these checks, the tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import profiles as P
from repro_torch.kernels.armatch import armatch, armatch_ref
from repro_torch.kernels.armatch.ops import plan as armatch_plan
from repro_torch.kernels.decode_attn import decode_attention, decode_attn_ref
from repro_torch.kernels.decode_attn.ops import (plan_for, split_starts,
                                                 unit_rows)
from repro_torch.kernels.fused_tick import fused_tick, fused_tick_ref
from repro_torch.kernels.hilbert import hilbert_xy2d, hilbert_xy2d_ref
from repro_torch.kernels.stage_mark import stage_mark, stage_mark_ref
from repro_torch.kernels.stage_mark.ops import _lib as stage_mark_lib
from repro_torch.kernels.window_reduce import (sliding_reduce,
                                               sliding_reduce_ref,
                                               window_reduce)
from repro_torch.kernels.window_reduce.ops import _IDENT
from repro_torch.obs.trace import RING_TICKS, RING_WIDTH
from repro_torch.testing import assert_bitwise

#: (t, d, window, stride, partial) besides the full-width block
WINDOW_REDUCE_RAGGED = ((37, 3, 8, 3, True), (1000, 5, 16, 16, True),
                        (9, 1, 8, 8, True), (9, 130, 8, 8, True))
#: (t, d, window, stride) besides the full-width block
FUSED_TICK_RAGGED = ((40, 3, 16, 8), (33, 1, 8, 5), (16, 130, 8, 8))

#: every comparison op, a value that is not exact in float32 (0.7), and
#: all five feature columns, lowest precedence first
TICK_TABLE = ((4, "<", 6.0, 1), (0, ">=", 0.7, 2), (2, "<=", -0.7, 4),
              (3, ">", 2.5, 5), (1, "==", 0.0, 3), (1, ">", 1.3, 3))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    both = torch.isfinite(a) & torch.isfinite(b)
    if not both.any():
        return 0.0
    return float((a - b).abs()[both].max())


def max_int_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference of two integer tensors, taken
    in int64 (float32 would round away a difference of 1 near 2^31)."""
    if a.numel() == 0:
        return 0.0
    return float((a.long() - b.long().to(a.device)).abs().max())


def block(gen, t, d, device, nan_rows=3, dead=(10, 80)):
    """[T, D] normals with NaN rows and a stretch of invalid rows (the
    checks make it long enough to empty whole windows)."""
    x = torch.randn((t, d), generator=gen, device=device)
    x[torch.randint(0, t, (nan_rows,), generator=gen, device=device),
      d // 2] = float("nan")
    valid = torch.rand((t,), generator=gen, device=device) < 0.8
    valid[dead[0]:min(t, dead[1])] = False
    return x, valid


def _counted(fn, counter, x: torch.Tensor, what: str):
    """``fn()``, checking that it launched the kernel once on a CUDA
    tensor (and not at all on a CPU one)."""
    before = counter.launches
    out = fn()
    if counter.launches != before + int(x.is_cuda):
        raise AssertionError(f"{what}: {counter.launches - before} kernel "
                             f"launches, want {int(x.is_cuda)}")
    return out


def _simple_too(fn, counter, x: torch.Tensor, what: str):
    """On a CUDA tensor, ``fn("simple")`` -- the first port's kernel, by
    name -- launched once and counted as the simple instance; ``None``
    on a CPU tensor."""
    if not x.is_cuda:
        return None
    before = counter.simple_launches
    out = _counted(lambda: fn("simple"), counter, x, f"{what} simple")
    if counter.simple_launches != before + 1:
        raise AssertionError(f"{what}: the simple instance launched "
                             f"{counter.simple_launches - before} times, "
                             "want once (by name)")
    return out


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous view that starts 4 bytes past a 16-byte
    boundary (one float into a fresh allocation)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


def check_window_reduce(device, t, d, window, stride) -> float:
    """The ``window_reduce`` kernel against ``sliding_reduce_ref`` for
    sum/max/min, and the wrapper's five reducers against the CPU, at the
    staged tick's two call shapes -- the ``[t, d]`` feature block and a
    ``[t, 1]`` column (the signal's sum/max/min and the wall stamp's
    min) -- at the ragged shapes, and at an unaligned view of the column.
    On the card the planned (span) instance is also held against the
    simple one and against the CPU, and only the call that names the
    simple instance takes it."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(1)
    err = 0.0
    cases = [(t, d, window, stride, False, False),
             (t, 1, window, stride, False, False),
             (t, 1, window, stride, False, True),
             *((*shape, False) for shape in WINDOW_REDUCE_RAGGED)]
    for t, d, w, s, partial, off in cases:
        x, valid = block(gen, t, d, dev, dead=(10, max(80, 10 + 2 * w)))
        what = f"window_reduce {t}x{d}{' unaligned' if off else ''}"
        if dev.type == "cuda" and not off:
            for reducer in ("sum", "mean", "max", "min", "count"):
                got = window_reduce(x, valid, w, s, reducer=reducer,
                                    partial=partial)
                cpu = window_reduce(x.cpu(), valid.cpu(), w, s,
                                    reducer=reducer, partial=partial)
                for a, b, name in zip(got, cpu, ("out", "count")):
                    assert_bitwise(a, b, f"{what} {reducer} {name} card vs "
                                         "CPU")
        nw = -(-t // s) if partial else (t - w) // s + 1
        reach = (nw - 1) * s + w
        for op in ("sum", "max", "min"):
            xf = torch.where(valid[:, None], x, _IDENT[op])
            if reach > t:
                xf = torch.cat([xf, xf.new_full((reach - t, d), _IDENT[op])])
            if off:
                xf = _unaligned(xf)
            k = _counted(lambda: sliding_reduce(xf, w, s, nw, op),
                         window_reduce, xf, f"{what} {op}")
            p = sliding_reduce_ref(xf, w, s, nw, op)
            assert_bitwise(k, p, f"{what} kernel {op}")
            err = max(err, max_abs_err(k, p))
            o = _simple_too(lambda how: sliding_reduce(xf, w, s, nw, op,
                                                       instance=how),
                            window_reduce, xf, f"{what} {op}")
            if o is not None:
                assert_bitwise(k, o, f"{what} {op}: span vs simple instance")
                assert_bitwise(k, sliding_reduce(xf.cpu(), w, s, nw, op),
                               f"{what} {op}: card vs CPU")
    return err


def check_fused_tick(device, t, d, window, stride) -> float:
    """The ``fused_tick`` kernel against ``fused_tick_ref`` (and the
    CPU) with :data:`TICK_TABLE` and ``min_count`` 1 and 5, at the full
    width block, at an unaligned view of it (``seq[1:]`` of a one row
    longer block, 72 bytes into its allocation) and at the ragged shapes;
    ``d`` is the feature count, the block has ``2 + d`` columns.  On the
    card the planned (span) instance is also held against the simple
    one, and only the call that names the simple instance takes it."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(2)
    err, fired = 0.0, set()
    cases = [(t, d, window, stride, 0), (t, d, window, stride, 1),
             *((*shape, 0) for shape in FUSED_TICK_RAGGED)]
    for t, d, w, s, off in cases:
        x, valid = block(gen, t + off, d + 1, dev,
                         dead=(10, max(80, 10 + 2 * w)))
        seq = torch.cat([torch.arange(t + off, device=dev, dtype=torch.float32)
                         [:, None], x], dim=1)[off:]
        valid = valid[off:]
        what = f"fused_tick {t}x{d}{' unaligned' if off else ''}"
        for min_count in (1, 5):
            def call(how=None):
                return fused_tick(seq, valid, w, s, table=TICK_TABLE,
                                  min_count=min_count, instance=how)
            k = _counted(call, fused_tick, seq, what)
            p = fused_tick_ref(seq, valid, w, s, TICK_TABLE,
                               min_count=min_count)
            c = fused_tick(seq.cpu(), valid.cpu(), w, s, table=TICK_TABLE,
                           min_count=min_count)
            o = _simple_too(call, fused_tick, seq, what)
            for i, name in enumerate(("agg", "wcount", "feats", "w_birth",
                                      "cons")):
                assert_bitwise(k[i], p[i], f"{what} kernel {name}")
                assert_bitwise(k[i], c[i], f"{what} {name} card vs CPU")
                if o is not None:
                    assert_bitwise(k[i], o[i],
                                   f"{what} {name}: span vs simple instance")
                err = max(err, max_abs_err(k[i], p[i]))
            fired.update(torch.unique(k[4]).tolist())
    if len(fired) < 4:
        raise AssertionError(f"fused_tick: consequences {sorted(fired)}, "
                             "table untested")
    return err


# ---- the AR kernels -------------------------------------------------------

#: the keyword vocabulary of ``tests/test_kernels.py``'s profiles
_ATTRS = [P.pack_keyword(f"attr{i}") for i in range(8)]
_VALUES = [P.pack_keyword(f"value{i}") for i in range(8)]


def random_profiles(rng: np.random.Generator, n: int, *,
                    kinds=range(6), max_slots: int = P.MAX_SLOTS,
                    min_slots: int = 1, wildcard: float = 0.0,
                    bad_vkind: float = 0.0,
                    zero_rows: float = 0.0) -> np.ndarray:
    """[n, 128] int32 encoded profiles, built slot-wise with numpy in
    the shapes ``ProfileBuilder`` gives (``tests/test_kernels.py:35-53``)
    over an 8-word attribute vocabulary: ``min_slots`` to ``max_slots``
    slots, each
    of a kind drawn from ``kinds`` -- 0 single attribute (a third of
    them prefixes ``a*`` .. ``attrK*``), 1 EXACT pair, 2 PREFIX pair, 3
    NUM in [-100, 100), 4 RANGE from [-50, 50) spanning up to 100, 5
    ANY.  Optionally a share of wildcard ``*`` attributes, of slots with
    a vkind outside the codes (-1, 6, 7, 100), and of all-zero rows."""
    kinds = np.asarray(list(kinds))
    shape = (n, P.MAX_SLOTS)
    out = np.zeros(shape + (P.SLOT_WIDTH,), np.int32)
    used = np.arange(P.MAX_SLOTS)[None, :] < rng.integers(
        min_slots, max_slots + 1, n)[:, None]
    kind = kinds[rng.integers(0, len(kinds), shape)]
    attr = np.asarray(_ATTRS, np.int32)[rng.integers(0, 8, shape)]
    out[..., P.L_ATTR_A], out[..., P.L_ATTR_B] = attr[..., 0], attr[..., 1]
    out[..., P.L_AMASK_A], out[..., P.L_AMASK_B] = P.FULL_MASK
    # prefix attributes: the first 1..5 bytes of the keyword
    pfx = (kind == 0) & (rng.random(shape) < 1 / 3)
    plen = rng.integers(1, 6, shape)
    masks = np.asarray([P.prefix_masks(k) for k in range(9)], np.int32)
    for lane, j in ((P.L_ATTR_A, 0), (P.L_ATTR_B, 1)):
        m = masks[plen, j]
        out[..., lane] = np.where(pfx, out[..., lane] & m, out[..., lane])
        out[..., lane + 2] = np.where(pfx, m, out[..., lane + 2])
    wild = rng.random(shape) < wildcard
    for lane in (P.L_ATTR_A, P.L_ATTR_B, P.L_AMASK_A, P.L_AMASK_B):
        out[..., lane] = np.where(wild, 0, out[..., lane])
    vk = np.asarray([P.VK_NONE, P.VK_EXACT, P.VK_PREFIX, P.VK_NUM,
                     P.VK_RANGE, P.VK_ANY], np.int32)[kind]
    value = np.asarray(_VALUES, np.int32)[rng.integers(0, 8, shape)]
    vplen = rng.integers(1, 7, shape)
    num = rng.integers(-100, 100, shape)
    lo = rng.integers(-50, 50, shape)
    hi = lo + rng.integers(0, 100, shape)
    for lane, j in ((P.L_V_A, 0), (P.L_V_B, 1)):
        m = masks[vplen, j]
        out[..., lane] = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [value[..., j], value[..., j] & m, num if j == 0 else 0,
             lo if j == 0 else hi], 0)
        out[..., lane + 2] = np.where(kind == 2, m, 0)
    bad = rng.random(shape) < bad_vkind
    vk = np.where(bad, np.asarray([-1, 6, 7, 100], np.int32)[
        rng.integers(0, 4, shape)], vk)
    out[..., P.L_VKIND] = vk
    out[..., P.L_USED] = 1
    out[~used] = 0
    out[rng.random(n) < zero_rows] = 0
    return out.reshape(n, P.PROFILE_WIDTH)


#: (n, order) besides the routing step's batch: every order the data
#: plane uses, single points and ragged tails
HILBERT_RAGGED = ((1, 1), (2, 2), (255, 8), (257, 12), (1000, 16),
                  (65535, 16))
#: (m, n) besides the data plane's two shapes: ragged tiles, both sides
#: of the narrow instance's limit (N 32 and 33, and M 257 and 64, whose
#: row tiles end early), and ragged interest blocks of the wide one
ARMATCH_RAGGED = ((1, 1), (7, 13), (130, 129), (300, 50), (1000, 32),
                  (1000, 33), (257, 1), (64, 1), (129, 130))
#: (m, n) where both sides use all 8 slots, and half the interests are
#: copies of data rows (whose slot kinds match themselves), so that an
#: interest's compacted slot loop runs to its end: the narrow and the
#: wide instance
ARMATCH_EIGHT = ((300, 8), (200, 40))


def check_hilbert(device, n: int) -> float:
    """The ``hilbert`` kernel against ``hilbert_xy2d_ref`` at ``n``
    points (order 16, the routing step's call), at ragged batches and
    every order of :data:`HILBERT_RAGGED`, and at an n-d shape."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(4)
    err = 0.0
    cases = [((n,), 16), *(((k,), o) for k, o in HILBERT_RAGGED),
             ((4, 33), 8), ((3, 5, 7), 12)]
    for shape, order in cases:
        hi = 1 << order
        x = torch.randint(0, hi, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        y = torch.randint(0, hi, shape, generator=gen, device=dev,
                          dtype=torch.int32)
        k = _counted(lambda: hilbert_xy2d(x, y, order), hilbert_xy2d, x,
                     f"hilbert {shape} order {order}")
        p = hilbert_xy2d_ref(x, y, order)
        assert_bitwise(k, p, f"hilbert kernel {shape} order {order}")
        err = max(err, max_int_err(k, p))
        if dev.type == "cuda":
            c = hilbert_xy2d(x.cpu(), y.cpu(), order)
            assert_bitwise(k, c, f"hilbert {shape} order {order} card vs CPU")
            err = max(err, max_int_err(k, c))
    return err


def _armatch_inputs(rng, m: int, n: int, kind: str):
    """[m, 128] data and [n, 128] interests for :func:`check_armatch`."""
    mixed = dict(wildcard=0.05, bad_vkind=0.02, zero_rows=0.05)
    if kind == "eight":
        data = random_profiles(rng, m, kinds=(0, 1, 5), min_slots=8,
                               **mixed)
        copies = data[rng.permutation(m)[:n // 2]]
        return data, np.concatenate([copies, random_profiles(
            rng, n - len(copies), min_slots=8, **mixed)])
    data = random_profiles(rng, m, **mixed)
    # short interests, so that a good share of pairs match; a lone
    # interest (a query) has one slot of a kind that can match
    short = dict(max_slots=1, kinds=(0, 1, 2, 4, 5)) if n == 1 \
        else dict(max_slots=3)
    return data, random_profiles(rng, n, **short, **mixed)


def check_armatch(device, shapes=()) -> float:
    """The ``armatch`` kernel against ``armatch_ref`` at each ``(m, n)``
    of ``shapes`` (the data plane's), :data:`ARMATCH_RAGGED` and
    :data:`ARMATCH_EIGHT`, on profiles with every vkind on both sides
    (and vkinds outside the codes), prefix and wildcard attributes,
    negative RANGE bounds and all-zero rows.  On the card the instance
    :func:`plan` names is also held against the simple instance, against
    the wide one where it planned the narrow one, and against the CPU
    (past 2^24 pairs, on as many leading rows); each call launches once,
    and only the call that names it the simple instance."""
    dev = torch.device(device)
    rng = np.random.default_rng(5)
    err = 0.0
    cases = [*((m, n, "mixed") for m, n in (*shapes, *ARMATCH_RAGGED)),
             *((m, n, "eight") for m, n in ARMATCH_EIGHT)]
    for m, n, kind in cases:
        data, ints = (torch.from_numpy(a).to(dev)
                      for a in _armatch_inputs(rng, m, n, kind))
        what = f"armatch {m}x{n} {kind}"
        simple = getattr(armatch, "simple_launches", 0)
        k = _counted(lambda: armatch(data, ints), armatch, data, what)
        p = armatch_ref(data, ints)
        assert_bitwise(k, p, f"{what}: kernel")
        err = max(err, max_int_err(k, p))
        if dev.type == "cuda":
            how = armatch_plan(m, n)
            others = ("simple", "wide") if how == "narrow" else ("simple",)
            for other in others:
                o = _counted(lambda: armatch(data, ints, instance=other),
                             armatch, data, f"{what} {other}")
                assert_bitwise(o, k, f"{what}: {other} vs {how} instance")
            if armatch.simple_launches != simple + 1:
                raise AssertionError(f"{what}: the simple instance launched "
                                     f"{armatch.simple_launches - simple} "
                                     "times, want once (by name)")
            # the CPU takes about a minute for the notify match's 2^26
            # pairs, so there it holds the first rows only
            rows = m if m * n <= 1 << 24 else (1 << 24) // n
            c = armatch(data[:rows].cpu(), ints.cpu())
            assert_bitwise(k[:rows], c, f"{what}: card vs CPU, {rows} rows")
            err = max(err, max_int_err(k[:rows], c))
        if m * n >= 4096 and not 0 < int(k.sum()) < m * n:
            raise AssertionError(f"{what}: {int(k.sum())} matches, the "
                                 "inputs test nothing")
    return err


# ---- the tracer's mark ----------------------------------------------------

#: (ticks, width, the row count it starts from) of the rings the
#: stage_mark check marks: the tracer's ring, its calibration probe's,
#: and a ragged one whose count starts past 2^32
STAGE_MARK_RINGS = ((RING_TICKS, RING_WIDTH, 0), (1, 2, 0),
                    (3, 7, (1 << 33) + 1))
#: whole ticks marked past a ring's rows, so that its count wraps
STAGE_MARK_WRAP = 3


def _tick_slots(i: int, width: int) -> list[int]:
    """Tick ``i``'s slots in launch order: a few from 1 up, then its
    last (tagged) mark at the row's last or last but one column."""
    n = i % min(4, width - 1)
    last = width - 1 - i % 2
    return [*range(1, n + 1), last if last > n else n + 1]


def _mark_plan(ticks: int, width: int) -> list[tuple[int, int]]:
    """(slot, tag) of every mark, in launch order: ``ticks`` +
    :data:`STAGE_MARK_WRAP` whole ticks, each tagged 1 to 5 at its last
    mark, then two untagged marks of a tick left open."""
    plan = []
    for i in range(ticks + STAGE_MARK_WRAP):
        slots = _tick_slots(i, width)
        plan += [(s, 0) for s in slots[:-1]] + [(slots[-1], 1 + i % 5)]
    return plan + [(s, 0) for s in range(1, min(3, width))]


def _marks_expected(ticks: int, width: int, start: int, plan):
    """What ``plan`` leaves in a ring, by the kernel's rule and apart
    from the times: the tags column, the count, and for each cell the
    index in ``plan`` of its last write (-1 where none)."""
    tags = np.zeros(ticks, np.int64)
    last = np.full((ticks, width), -1)
    count = start
    for k, (slot, tag) in enumerate(plan):
        row = count % ticks
        last[row, slot] = k
        if tag:
            tags[row] = tag
            count += 1
    return tags, count, last


def _marked_ring(ring: torch.Tensor, plan, mark, counter=None, what=""):
    for slot, tag in plan:
        if counter is None:
            mark(ring, slot, tag)
        else:
            _counted(lambda: mark(ring, slot, tag), counter, ring, what)
    return ring.cpu().numpy()


def _stage_mark_rejects(ring: torch.Tensor, what: str) -> None:
    """A slot outside 1..width-1 and a ring of another type or shape are
    refused by the wrapper, and on the card by the kernel's entry point,
    with nothing launched and the ring unchanged."""
    before, launched = ring.clone(), stage_mark.launches
    ticks, width = ring.shape[0] - 1, ring.shape[1]
    bad = [(ring, 0), (ring, width), (ring.to(torch.int32), 1),
           (ring.reshape(-1), 1), (ring[:1], 1), (ring.t(), 1)]
    for r, slot in bad:
        try:
            stage_mark(r, slot, 1)
        except ValueError:
            continue
        raise AssertionError(f"{what}: a mark at slot {slot} of a "
                             f"{r.dtype} {tuple(r.shape)} ring was taken")
    if ring.is_cuda:
        lib = stage_mark_lib()
        stream = torch.cuda.current_stream(ring.device).cuda_stream
        for t, slot in ((ticks, 0), (ticks, width), (0, 1)):
            err = lib.stage_mark_i64(ring.data_ptr(), t, width, slot, 1,
                                     stream)
            if err == 0:
                raise AssertionError(f"{what}: the kernel's entry took "
                                     f"slot {slot} of {t} x {width}")
        torch.cuda.synchronize(ring.device)
    if stage_mark.launches != launched:
        raise AssertionError(f"{what}: a refused mark was counted")
    assert_bitwise(ring, before, f"{what}: a refused mark wrote the ring")


def check_stage_mark(device, rings=STAGE_MARK_RINGS) -> float:
    """The ``stage_mark`` kernel against ``stage_mark_ref`` on a CPU
    copy and against the kernel's rule (:func:`_marks_expected`), for
    each ``(ticks, width, start)`` of ``rings``: the same marks, past
    the ring's rows, then bitwise the same tags column, row count and
    cells written.  The times differ (``%globaltimer`` against the
    host's clock) and are held to their order instead: by the index of
    each cell's last write they never fall.  Each mark launches once on
    the card; bad slots and rings are refused (:func:`_stage_mark_rejects`).
    Returns 0.0: nothing else of the two rings is compared."""
    dev = torch.device(device)
    for ticks, width, start in rings:
        what = f"stage_mark [{ticks + 1} x {width}] from {start}"
        plan = _mark_plan(ticks, width)
        fresh = []
        for d in (dev, torch.device("cpu")):
            ring = torch.zeros((ticks + 1, width), dtype=torch.int64,
                               device=d)
            ring[ticks, 0] = start
            fresh.append(ring)
        _stage_mark_rejects(fresh[0], what)
        k = _marked_ring(fresh[0], plan, stage_mark, stage_mark, what)
        p = _marked_ring(fresh[1], plan, stage_mark_ref)
        tags, count, last = _marks_expected(ticks, width, start, plan)
        want_count = np.zeros(width, np.int64)
        want_count[0] = count
        for side, ring in (("kernel", k), ("plain version", p)):
            if not np.array_equal(ring[ticks], want_count):
                raise AssertionError(f"{what}: the {side}'s count row "
                                     f"{ring[ticks, :4]}, want {count}")
            if not np.array_equal(ring[:ticks, 0], tags):
                raise AssertionError(f"{what}: the {side}'s tags differ "
                                     "from the rule's")
            written = ring[:ticks, 1:] != 0
            if not np.array_equal(written, last[:, 1:] >= 0):
                raise AssertionError(f"{what}: the {side} wrote other "
                                     "cells than the rule's")
            cells = last[:, 1:][written]
            times = ring[:ticks, 1:][written][np.argsort(cells)]
            if (np.diff(times) < 0).any():
                raise AssertionError(f"{what}: the {side}'s times fall "
                                     "between marks made in order")
        if dev.type == "cuda":
            _stage_mark_rejects(fresh[0], f"{what} after the marks")
    return 0.0


# ---- the serving kernel ---------------------------------------------------

#: (b, h, hkv, d, s) of ``tests/test_kernels.py``'s decode cases: GQA,
#: MHA with odd heads, MQA, a long cache, a ragged S
DECODE_ATTN_SHAPES = ((2, 8, 4, 64, 1024), (1, 7, 7, 128, 512),
                      (3, 10, 1, 64, 768), (2, 32, 8, 128, 2048),
                      (1, 4, 2, 32, 100))
#: (b, h, hkv, d, s) of the configurations' other head shapes, G 1, 6
#: and 7 at D 128 and 64, the smoke configs' D 16, and D 256 (the bf16
#: D 256 instance, the second case with splits longer than its ring;
#: float32 takes the generic one); S ragged around the split size
DECODE_ATTN_HEADS = ((2, 4, 4, 128, 600), (2, 12, 2, 128, 530),
                     (2, 14, 2, 128, 300), (2, 8, 8, 64, 700),
                     (3, 12, 2, 64, 513), (2, 7, 1, 64, 257),
                     (3, 16, 2, 16, 700), (1, 8, 2, 256, 300),
                     (4, 8, 8, 256, 1000))
#: float32: the kernel and the plain version sum in other orders;
#: bfloat16: the reference's own tolerance (outputs rounded to bf16,
#: whose ulp near 1 is 7.8e-3)
DECODE_ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.5e-2}


def split_edge_lengths(b: int, s: int, n_split: int, unit: int,
                       part: int = 0) -> torch.Tensor:
    """[b] int32 lengths on the kernel's split edges: 0, 1, the whole
    cache and one row less, then each split's first row less one, itself
    and one more (:func:`split_starts`), then a unit's edges; in turn,
    clamped to [0, s].  ``part`` p starts at the cycle's edge p x b, so
    that parts 0 .. :func:`edge_parts` - 1 between them put a length at
    every edge."""
    edges = _split_edges(s, n_split, unit)
    return torch.tensor([min(max(edges[(i + part * b) % len(edges)], 0), s)
                         for i in range(b)], dtype=torch.int32)


def _split_edges(s: int, n_split: int, unit: int) -> list[int]:
    starts = split_starts(s, n_split, unit)[1:-1]
    return [0, 1, s, s - 1, *(x for st in starts
                              for x in (st - 1, st, st + 1)),
            unit - 1, unit, unit + 1]


def edge_parts(b: int, s: int, n_split: int, unit: int) -> int:
    """Calls of ``b`` rows that :func:`split_edge_lengths` needs to put a
    length at every edge."""
    return -(-len(_split_edges(s, n_split, unit)) // b)


def max_err_within(a, b, tol: float, what: str) -> float:
    """The largest absolute difference of ``a`` and ``b``; raises if a
    value of ``a`` is not finite or differs by more than ``tol`` absolute
    plus ``tol`` relative."""
    a, b = a.float().cpu(), b.float().cpu()
    if not torch.isfinite(a).all():
        raise AssertionError(f"{what}: non-finite output")
    bad = (a - b).abs() > tol + tol * b.abs()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} of {a.numel()} "
                             f"values differ by more than {tol} (max "
                             f"{float((a - b).abs().max())})")
    return float((a - b).abs().max())


def check_decode_attn(device, *serve) -> float:
    """The ``decode_attn`` kernel against ``decode_attn_ref`` on the same
    tensors, and against the CPU, in float32 and bfloat16, within
    :data:`DECODE_ATTN_TOL`: at each ``serve`` shape ``(b, h, hkv, d,
    s)`` (a serve step's full cache) with every row full but a length-0
    one, and with :func:`split_edge_lengths` (:func:`edge_parts` calls,
    which between them put a length at every split edge); at
    :data:`DECODE_ATTN_SHAPES` and :data:`DECODE_ATTN_HEADS` with random
    lengths; on a strided cache view that keeps 16-byte rows, and on
    one that does not.  Each call must launch the instance that
    :func:`plan_for` names: the generic one for the unaligned view and
    float32 at D 256, a fast one elsewhere, and at a serve shape the
    fast instance of its dtype and D (``bf16_d256`` at RecurrentGemma's
    D 256).  A second call on the same inputs must give the same bits.
    A comparison that fails names the largest difference of the kernel
    and of each plain version from :func:`decode_attn_f64`, so that the
    message says which side is off."""
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(6)
    err = 0.0
    cases = [*((full, kind) for full in serve for kind in ("full", "edges")),
             *((s, "ragged") for s in DECODE_ATTN_SHAPES + DECODE_ATTN_HEADS),
             ((3, 8, 2, 32, 70), "strided"), ((3, 8, 2, 32, 70), "unaligned")]
    for dtype, tol in DECODE_ATTN_TOL.items():
        for (b, h, hkv, d, s), kind in cases:
            q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
            width = {"strided": d + 16, "unaligned": d + 1}.get(kind, d)
            k, v = (torch.randn((b, s, hkv, width), generator=gen,
                                device=dev).to(dtype)[..., :d]
                    for _ in range(2))
            lengths = torch.randint(1, s + 1, (b,), generator=gen,
                                    device=dev, dtype=torch.int32)
            how = plan_for(q, k, v, hkv)
            rounds = [lengths]
            if kind == "full":
                lengths.fill_(s)
            elif kind == "edges":       # as many calls as every edge needs
                unit = unit_rows(dtype, d)
                rounds = [split_edge_lengths(b, s, how.n_split, unit,
                                             part).to(dev)
                          for part in range(edge_parts(b, s, how.n_split,
                                                       unit))]
            for part, lengths in enumerate(rounds):
                err = max(err, _check_decode_case(
                    q, k, v, lengths, hkv, how, kind, part, tol))
    return err


def _check_decode_case(q, k, v, lengths, hkv: int, how, kind: str,
                       part: int, tol: float) -> float:
    """One call of :func:`check_decode_attn`: row 0 has length 0 but in
    the ragged cases and the later parts of the split edges, where it
    keeps its edge."""
    (b, h, d), s, dtype, dev = q.shape, k.shape[1], q.dtype, q.device
    zero_row = kind != "ragged" and part == 0
    if zero_row:
        lengths[0] = 0
    what = f"decode_attn {dtype} {(b, h, hkv, d, s)} {kind}" \
        + (f" (part {part})" if part else "")
    wide_f32 = dtype == torch.float32 and d > 128
    if (how.instance == "generic") != (kind == "unaligned" or wide_f32):
        raise AssertionError(f"{what}: planned {how}")
    fast = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}_d{d}"
    if kind in ("full", "edges") and not wide_f32 and how.instance != fast:
        raise AssertionError(f"{what}: planned {how}, want {fast}")
    generic = decode_attention.generic_launches
    out = _counted(lambda: decode_attention(q, k, v, lengths,
                                            num_kv_heads=hkv),
                   decode_attention, q, what)
    want = int(q.is_cuda and how.instance == "generic")
    rose = decode_attention.generic_launches - generic
    if rose != want:
        raise AssertionError(f"{what}: planned {how.instance}, "
                             f"generic launches rose by {rose}")
    g = h // hkv
    plain = decode_attn_ref(q.reshape(b, hkv, g, d), k.transpose(1, 2),
                            v.transpose(1, 2), lengths,
                            scale=1.0 / d ** 0.5).reshape(b, h, d)
    if out.dtype != dtype or out.shape != (b, h, d):
        raise AssertionError(f"{what}: {out.dtype} {out.shape}")
    if zero_row and bool((out[0] != 0).any()):
        raise AssertionError(f"{what}: a length-0 row is not zero")
    again = _counted(lambda: decode_attention(q, k, v, lengths,
                                              num_kv_heads=hkv),
                     decode_attention, q, f"{what} again")
    if not torch.equal(again, out):
        raise AssertionError(f"{what}: a second call on the same "
                             "inputs gives other bits")
    held = [("kernel", "plain", plain)]
    if dev.type == "cuda":
        held.append(("card vs CPU", "cpu", decode_attention(
            q.cpu(), k.cpu(), v.cpu(), lengths.cpu(), num_kv_heads=hkv)))
    err = 0.0
    for name, _, want in held:
        try:
            err = max(err, max_err_within(out, want, tol, f"{what} {name}"))
        except AssertionError as e:
            off = f64_errors(q, k, v, lengths, hkv, kernel=out,
                             **{side: w for _, side, w in held})
            raise AssertionError(f"{e}; largest difference of each "
                                 f"from float64: {off}") from None
    return err


def decode_attn_f64(q, k, v, lengths, hkv: int) -> torch.Tensor:
    """The decode attention of :func:`decode_attn_ref` in float64 on the
    CPU, [B, H, D]: the exact answer that the kernel and both plain
    versions round."""
    b, h, d = q.shape
    qd = q.cpu().double().reshape(b, hkv, h // hkv, d) / d ** 0.5
    kd, vd = (x.cpu().double().transpose(1, 2) for x in (k, v))
    scores = torch.einsum("bhgd,bhsd->bhgs", qd, kd)
    mask = (torch.arange(k.shape[1])[None, None, None, :]
            < lengths.cpu()[:, None, None, None])
    scores = torch.where(mask, scores, -torch.inf)
    p = torch.where(mask, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    denom = p.sum(-1, keepdim=True)
    p = p / torch.where(denom == 0, 1.0, denom)
    return torch.einsum("bhgs,bhsd->bhgd", p, vd).reshape(b, h, d)


def f64_errors(q, k, v, lengths, hkv: int, **outs) -> dict:
    """Each of ``outs``' largest absolute difference from
    :func:`decode_attn_f64`: which side of a failed comparison is off."""
    exact = decode_attn_f64(q, k, v, lengths, hkv)
    return {name: float((o.cpu().double() - exact).abs().max())
            for name, o in outs.items()}
