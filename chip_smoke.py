#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. build the hand-written kernels from ``src/repro_torch/kernels/csrc/``
   (one ``nvcc`` per source, all at once) and print the card's name and
   power limit;
2. hold each kernel against its plain PyTorch version on the card,
   bitwise (NaN matches NaN), at the stream tick's full-width shapes and
   at ragged small ones, with NaN rows and all-invalid windows;
3. drive the single-device stream tick at full width -- D = 16 features,
   W = 64, S = 32, 65,536 rows a tick, a 2^22-row ring, the two rules
   and the tanh(h @ p) x8 core stand-in of ``benchmarks/streaming.py``
   -- for 64 ticks on the staged path and 64 on the fused path; staged
   and fused must agree bitwise, the first ticks must match the same
   executor on the CPU, and each path must have launched its kernel;
   then an admission run (dedupe window of 131,072, a finite contract,
   one redelivered tick) must conserve every offered row and dedupe the
   redelivery whole;
4. time each path (items/s as all rows over all ticks' wall time,
   p50/p99 tick ms, with a synchronize per tick) and each kernel at the
   path's shapes -- the kernel's own device time from a
   ``torch.profiler`` trace, and wall time a call from CUDA events --
   beside its plain version, a one-call PyTorch yardstick where there
   is one, and the least time the card could take;
5. profile a few ticks of each path with ``torch.profiler``: the
   device's busy share of the tick and the top device ops.

The line before the last is a JSON object of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits 1 before printing either.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks: HBM bandwidth, and float32 outside the
#: tensor cores (the kernels' adds and compares run there).
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


class Sizes(NamedTuple):
    batch: int          # rows a tick (micro_batch = producer batch)
    d: int              # feature columns
    window: int
    stride: int
    capacity: int       # ring rows
    ticks: int          # measured ticks per path
    cpu_ticks: int      # ticks compared against the CPU executor
    dedupe: int         # admission dedupe window K
    warmup: int = 3


FULL = Sizes(batch=65536, d=16, window=64, stride=32, capacity=1 << 22,
             ticks=64, cpu_ticks=4, dedupe=131072)


def _fail(msg: str):
    raise RuntimeError(msg)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _device_events(prof, tag: str) -> list[dict]:
    """The kernel, memcpy and memset events of a finished
    ``torch.profiler`` capture, read from its Chrome trace (written to
    ``build/``, git-ignored)."""
    path = ROOT / "build" / f"profile_{tag}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if "dur" in e and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset")]


def _timed(fn, reps: int, tag: str,
           kernel: str | None = None) -> tuple[float, float]:
    """(device ms, wall ms) a call of ``fn()`` over ``reps`` calls back
    to back.  Device time sums the device ops the profiler saw, or,
    given ``kernel``, only that kernel's own launches (one a call; the
    wrapper's other ops are left out).  Wall time is CUDA events around
    the loop, which the host's launch rate bounds whenever a call's
    device work is shorter than its launch."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
    events = _device_events(prof, tag)
    if kernel is not None:
        events = [e for e in events if kernel in e["name"]]
        if len(events) != reps:
            _fail(f"{tag}: {len(events)} {kernel} launches traced, want "
                  f"{reps}")
    busy_us = sum(e["dur"] for e in events)
    return busy_us * 1e-3 / reps, start.elapsed_time(stop) / reps


# ---- phase 3: the stream tick at full width ------------------------------

def _engine(R):
    return R.RuleEngine([
        R.threshold_rule("hot_mean", 0, ">=", 0.25, R.C_SEND_CORE,
                         priority=1),
        R.threshold_rule("sparse", 4, "<", 8.0, R.C_STORE_EDGE, priority=2),
    ])


def _edge_fn(p, batch):
    return batch, batch[:, :5]


def _core_fn(p, batch):
    h = batch
    for _ in range(8):
        h = torch.tanh(h @ p)
    return h, batch[:, :5]


def make_executor(sz: Sizes, device, fused=False, admission=None,
                  overlap=False, int8=False):
    from repro_torch import convert
    from repro_torch.core import pipeline as P
    from repro_torch.core import rules as R
    from repro_torch.stream import AdmissionPlan, StreamConfig, StreamExecutor
    cfg = StreamConfig(micro_batch=sz.batch, window=sz.window,
                       stride=sz.stride, capacity=sz.capacity,
                       lateness=64.0, fused=fused, overlap_ingest=overlap,
                       ingest_int8=int8, admission=admission or AdmissionPlan())
    engine = _engine(R)
    p = convert.params_from_numpy(
        (np.random.default_rng(0).standard_normal((5 + sz.d, 5 + sz.d))
         * 0.1).astype(np.float32), device)
    pipe = P.two_tier_pipeline(_edge_fn, _core_fn, engine, core_params=p,
                               core_capacity=cfg.windows_per_step // 4)
    ex = StreamExecutor(cfg, engine, pipe, device=device)
    return ex, ex.init_state(sz.d)


def tick_batch(sz: Sizes, i: int, device):
    """Tick ``i`` of the feed, made on the device from seed 100 + i: the
    alternating hot/cold regime of ``benchmarks/streaming.py``."""
    gen = torch.Generator(device).manual_seed(100 + i)
    items = torch.randn((sz.batch, sz.d), generator=gen, device=device)
    if (i // 20) % 2:
        items[:, 0] += 0.5
    ts = torch.arange(sz.batch, dtype=torch.float32, device=device) \
        + float(i * sz.batch)
    return items, ts


def drive(ex, state, sz: Sizes, device, ticks, keep=False, snap_at=None):
    """Run ``ticks`` ticks; per-tick wall seconds (synchronized)."""
    secs, outs, snap = [], [], None
    for i in range(ticks):
        items, ts = tick_batch(sz, i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = ex.step(state, items, ts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if keep:
            outs.append(out)
        if snap_at is not None and i + 1 == snap_at:
            snap = state.metrics.as_dict()
    return state, secs, outs, snap


def run_paths(sz: Sizes, device, bitwise, close):
    from repro_torch.kernels.fused_tick import fused_tick
    from repro_torch.kernels.window_reduce import window_reduce
    from repro_torch.stream.executor import StepOutput
    from repro_torch.testing import DEVICE_MATH
    results = {}
    for name, fused in (("staged", False), ("fused", True)):
        ex, state = make_executor(sz, device, fused=fused)
        state, _, _, _ = drive(ex, state, sz, device, sz.warmup)
        del ex, state
        ex, state = make_executor(sz, device, fused=fused)
        window_reduce.launches = fused_tick.launches = 0
        state, secs, outs, snap = drive(ex, state, sz, device, sz.ticks,
                                        keep=True, snap_at=sz.cpu_ticks)
        launches = {"window_reduce": window_reduce.launches,
                    "fused_tick": fused_tick.launches}
        results[name] = dict(state=state, secs=secs, outs=outs, snap=snap,
                             launches=launches,
                             metrics=state.metrics.as_dict())
        del ex
    st, fu = results["staged"], results["fused"]
    if st["launches"]["window_reduce"] == 0:
        _fail("staged path launched no window_reduce kernel")
    if fu["launches"]["fused_tick"] == 0:
        _fail("fused path launched no fused_tick kernel")
    for i, (a, b) in enumerate(zip(st["outs"], fu["outs"])):
        for field in StepOutput._fields:
            bitwise(getattr(a, field), getattr(b, field),
                    f"staged vs fused tick {i} {field}")
    if st["metrics"] != fu["metrics"]:
        _fail(f"staged vs fused metrics: {st['metrics']} != {fu['metrics']}")
    bitwise(st["state"].rb.store[:, [0] + list(range(2, 2 + sz.d))],
            fu["state"].rb.store[:, [0] + list(range(2, 2 + sz.d))],
            "staged vs fused ring (event ts and features)")
    m = st["metrics"]
    if m["items_offered"] != m["items_accepted"] + m["items_rejected"] \
            + m["items_deduped"]:
        _fail(f"conservation broken: {m}")
    if m["windows_escalated"] == 0 or m["core_overflow"] == 0:
        _fail(f"hot regime escalated nothing or never hit capacity: {m}")

    # the card against the same executor on the CPU, first ticks
    ex, state = make_executor(sz, "cpu")
    for i in range(sz.cpu_ticks):
        items, ts = tick_batch(sz, i, device)
        state, out = ex.step(state, items.cpu(), ts.cpu())
        ref = st["outs"][i]
        for field in ("aggregates", "features", "window_count",
                      "consequence", "escalated"):
            bitwise(getattr(ref, field), getattr(out, field),
                    f"card vs CPU tick {i} {field}")
        close(ref.outputs, out.outputs, DEVICE_MATH,
              f"card vs CPU tick {i} outputs")
    if state.metrics.as_dict() != st["snap"]:
        _fail(f"card vs CPU metrics: {st['snap']} != "
              f"{state.metrics.as_dict()}")
    del ex, state
    return results


def run_admission(sz: Sizes, device, ticks=8, redeliver=5, nan_tick=3,
                  nan_rows=100):
    from repro_torch.stream import AdmissionPlan, DataContract
    plan = AdmissionPlan(dedupe_window=sz.dedupe, contract=DataContract(
        lo=(-8.0,) * sz.d, hi=(8.0,) * sz.d, require_finite=True))
    ex, state = make_executor(sz, device, fused=True, admission=plan)
    snaps = [state.metrics.as_dict()]
    for i in range(ticks):
        items, ts = tick_batch(sz, redeliver - 1 if i == redeliver else i,
                               device)
        if i == nan_tick:
            items[:nan_rows, 2] = float("nan")
        state, _ = ex.step(state, items, ts)
        snaps.append(state.metrics.as_dict())
    m = snaps[-1]
    if m["items_offered"] != m["items_accepted"] + m["items_rejected"] \
            + m["items_deduped"]:
        _fail(f"admission conservation broken: {m}")

    def delta(i, key):
        return snaps[i + 1][key] - snaps[i][key]

    # every row the first delivery put in the ring is deduped on the
    # second.  A row the first delivery itself deduped (a 32-bit FNV
    # collision, ~2.5 a tick at this size) may be judged fresh the
    # second time, once the colliding hash has left the window.
    first = delta(redeliver - 1, "items_accepted")
    dd = delta(redeliver, "items_deduped")
    da = delta(redeliver, "items_accepted")
    if dd < first or dd + da != sz.batch:
        _fail(f"redelivered tick: {dd} deduped, {da} accepted of "
              f"{sz.batch}; first delivery accepted {first}")
    if m["items_rejected"] != nan_rows or m["drift_counts"][2] != nan_rows:
        _fail(f"contract: {m['items_rejected']} rejected, drift "
              f"{m['drift_counts']}, want {nan_rows} in field 2")
    return m


def run_overlap(sz: Sizes, device, bitwise, ticks=6):
    """``run()`` with the ingest stager on the card: host batches staged
    through pinned memory on a side stream give bitwise the direct
    run's outputs and metrics; int8 staging delivers every batch."""
    from repro_torch.stream.executor import StepOutput
    feed = [tuple(a.cpu().numpy() for a in tick_batch(sz, i, device))
            for i in range(ticks)]
    runs = {}
    for key in ((False, False), (True, False), (True, True)):
        ex, state = make_executor(sz, device, fused=True, overlap=key[0],
                                  int8=key[1])
        state, outs = ex.run(state, feed)
        runs[key] = (outs, state.metrics.as_dict())
        del ex, state
    (direct, md), (staged, ms), (q8, m8) = runs.values()
    for i, (a, b) in enumerate(zip(direct, staged)):
        for field in StepOutput._fields:
            bitwise(getattr(b, field), getattr(a, field),
                    f"overlap vs direct tick {i} {field}")
    if len(staged) != ticks or ms != md:
        _fail(f"overlap run: {len(staged)} ticks, metrics {ms} vs {md}")
    if len(q8) != ticks or m8["steps"] != ticks \
            or m8["items_dequeued"] != ticks * sz.batch:
        _fail(f"int8 staging lost batches: {m8}")


# ---- phase 4: kernel timing -----------------------------------------------

def time_kernels(sz: Sizes, device, results, errs):
    from repro_torch.core import rules as R
    from repro_torch.kernels.fused_tick import fused_tick, fused_tick_ref
    from repro_torch.kernels.window_reduce import (sliding_reduce,
                                                   sliding_reduce_ref)
    t = sz.batch + sz.window - sz.stride        # carry + one micro-batch
    nw = sz.batch // sz.stride
    gen = torch.Generator(device).manual_seed(3)
    # window_reduce at the staged tick's mean-aggregate call: [T, D]
    xp = torch.randn((t, sz.d), generator=gen, device=device)
    xcl = xp.t().contiguous()[None]             # [1, D, T] for the pools
    wr = dict(
        ms=_timed(lambda: sliding_reduce(xp, sz.window, sz.stride, nw, "sum"),
                  200, "window_reduce", kernel="window_reduce_kernel"),
        plain_ms=_timed(lambda: sliding_reduce_ref(
            xp, sz.window, sz.stride, nw, "sum"), 20, "window_reduce_plain"),
        library_ms=_timed(lambda: torch.nn.functional.avg_pool1d(
            xcl, sz.window, sz.stride), 200, "avg_pool1d"))
    wr_bytes = 4 * (t * sz.d + nw * sz.d)
    wr_ops = nw * sz.d * (sz.window - 1)
    # fused_tick at the fused tick's call: [T, 2 + D] rows + [T] mask
    seq = torch.cat([torch.arange(t, dtype=torch.float32, device=device)
                     [:, None], torch.randn((t, 1 + sz.d), generator=gen,
                                            device=device)], dim=1)
    valid = torch.rand((t,), generator=gen, device=device) < 0.95
    table = _engine(R).table()
    ft = dict(
        ms=_timed(lambda: fused_tick(seq, valid, sz.window, sz.stride,
                                     table=table), 200, "fused_tick",
                  kernel="fused_tick_kernel"),
        plain_ms=_timed(lambda: fused_tick_ref(
            seq, valid, sz.window, sz.stride, table), 5, "fused_tick_plain"),
        library_ms=None)
    l = 1 + sz.d                                # columns the kernel reads
    ft_bytes = 4 * t * l + t + 4 * nw * (sz.d + 5 + 3)
    ft_ops = nw * l * sz.window * 4
    rows = []
    for name, rec, nbytes, ops, path, src, tpu in (
            ("window_reduce", wr, wr_bytes, wr_ops, "staged",
             "src/repro_torch/kernels/csrc/window_reduce.cu",
             "src/repro/kernels/window_reduce/window_reduce.py:49"),
            ("fused_tick", ft, ft_bytes, ft_ops, "fused",
             "src/repro_torch/kernels/csrc/fused_tick.cu",
             "src/repro/kernels/fused_tick/fused_tick.py:108")):
        if rec["ms"][0] <= 0.0 or rec["plain_ms"][0] <= 0.0:
            _fail(f"{name}: the profiler saw no device time")
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        launches = results[path]["launches"][name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": errs[name],
            "ms": rec["ms"][0], "plain_ms": rec["plain_ms"][0],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": rec["library_ms"] and rec["library_ms"][0]})

        def us(pair):
            return "none" if pair is None else \
                f"{pair[0] * 1e3:.2f} us device ({pair[1] * 1e3:.2f} us wall)"
        print(f"kernel {name} a call: {us(rec['ms'])}, plain "
              f"{us(rec['plain_ms'])}, library {us(rec['library_ms'])}, "
              f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({nbytes} bytes), "
              f"launches {launches} ({launches / sz.ticks:g} a tick on the "
              f"{path} path)")
    return rows


def profile_ticks(sz: Sizes, device, ticks=8) -> None:
    """Where a tick's time goes: ``torch.profiler`` over ``ticks`` ticks
    of each path, device time summed from the trace's device ops."""
    from torch.profiler import ProfilerActivity, profile
    for name, fused in (("staged", False), ("fused", True)):
        ex, state = make_executor(sz, device, fused=fused)
        state, *_ = drive(ex, state, sz, device, sz.warmup)
        feed = [tick_batch(sz, i, device) for i in range(ticks)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for items, ts in feed:
                state, _ = ex.step(state, items, ts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = _device_events(prof, f"tick_{name}")
        busy = sum(e["dur"] for e in dev) * 1e-6
        by_name: dict[str, float] = {}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"profile {name}: {ticks} ticks in {wall * 1e3:.3f} ms "
              f"(profiler on), device busy {busy * 1e3:.3f} ms = "
              f"{busy / wall:.4f} of the wall time, {len(dev) / ticks:.1f} "
              f"device ops a tick; top by device time: "
              + "; ".join(f"{n[:60]} {d / ticks:.1f} us/tick"
                          for n, d in top))
        del ex, state


def run(sz: Sizes = FULL, device="cuda") -> dict:
    from repro_torch.kernels import build, checks
    from repro_torch.testing import assert_bitwise, assert_close
    # float32 matmuls in full precision on the card, so the core stage
    # is compared with the CPU at a float32 tolerance, not TF32's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"phase 1 build: {len(build.SOURCES)} kernels ready in "
          f"{time.perf_counter() - t0:.2f} s ({build.builds} compiled)")
    print(f"card: {_card_line()}")

    block = (sz.batch + sz.window - sz.stride, sz.d, sz.window, sz.stride)
    errs = {"window_reduce": checks.check_window_reduce(device, *block),
            "fused_tick": checks.check_fused_tick(device, *block)}
    print(f"phase 2 kernels: bitwise equal to their plain versions "
          f"(max abs err {errs})")

    results = run_paths(sz, device, assert_bitwise, assert_close)
    adm = run_admission(sz, device)
    run_overlap(sz, device, assert_bitwise)
    print(f"phase 3 path: staged == fused bitwise over {sz.ticks} ticks, "
          f"card == CPU over {sz.cpu_ticks}, overlapped ingest == direct; "
          "metrics "
          f"{results['staged']['metrics']}; admission {adm}")

    for name in ("staged", "fused"):
        secs = results[name]["secs"]
        q = np.quantile(np.asarray(secs), [0.5, 0.99])
        print(f"path {name}: {sz.batch * len(secs) / sum(secs):.0f} "
              f"items/s (all rows over all ticks), tick p50 {q[0] * 1e3:.3f} ms, p99 "
              f"{q[1] * 1e3:.3f} ms over {len(secs)} ticks, launches "
              f"{results[name]['launches']}")
    kernels = {"kernels": time_kernels(sz, device, results, errs)}
    profile_ticks(sz, device)
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    kernels = run()
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
