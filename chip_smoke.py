#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0.  The
stream tick, the fleet tick and every served model's decode step run
compile-once (``repro_torch.runtime.capture``): the tick is captured as
a CUDA graph at its first call and replayed after, the decode step is
captured by the function registry at ``start_function`` after one
warm-up step on copies of its caches; so phases 3 to 8 time the graphed
paths (a tick timing leaves out the first tick, which captured), and
launch counts include the replays' and the warm-up's:

1. build the five hand-written kernels from
   ``src/repro_torch/kernels/csrc/`` (one ``nvcc`` per source, all at
   once) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card and
   against the CPU: window_reduce and fused_tick bitwise (NaN matches
   NaN) at the stream tick's full-width shapes (window_reduce's
   ``[T x 16]`` block and ``[T x 1]`` column, fused_tick's ``[T x 18]``
   block), an unaligned view of each (a column, ``seq[1:]``) and ragged
   small ones, with NaN rows and all-invalid windows, the instance the
   plan names (span) against the simple one too; hilbert bitwise at the
   routing step's 65,536 points and ragged batches at orders 1 to 16;
   armatch
   bitwise at the AR data plane's two calls and ragged shapes, with
   every vkind on both sides, the instance its plan names against the
   simple instance (and the wide one against the narrow one);
   decode_attn within 1e-5 (float32) and 2.5e-2 (bfloat16) at the
   Yi-6B serve step's full cache, with lengths on its split edges, the
   reference's five test shapes, the configs' other head shapes (G 1,
   6, 7; D 16, 64, 128), a strided cache, an unaligned one (the
   generic instance) and length-0 rows, each call launching the
   instance its plan names;
3. drive the single-device stream tick at full width -- D = 16 features,
   W = 64, S = 32, 65,536 rows a tick, a 2^22-row ring, the two rules
   and the tanh(h @ p) x8 core stand-in of ``benchmarks/streaming.py``
   -- for 64 ticks on the staged path and 64 on the fused path; staged
   and fused must agree bitwise, the first ticks must match the same
   executor on the CPU, and each path must have launched its kernel
   (never a simple instance);
   then an admission run (dedupe window of 131,072, a finite contract,
   one redelivered tick) must conserve every offered row and dedupe the
   redelivery whole.  Then the AR data plane at full width: the card is
   one RP of a 16 x 16 overlay with a 2^20-row DHT shard; each of 64
   steps posts 65,536 messages (Hilbert index, owner rank, bucketing,
   store of what this RP receives), matches them against 1,024
   standing interests, runs 32 associative queries over the shard and
   one registry lookup; both AR kernels must have launched (armatch
   never its simple instance), and the same composition at a reduced
   size must give bitwise the same outputs on the card and on the
   CPU.  Then serving: Yi-6B at full
   width and depth (32 layers, d_model 4,096, GQA 32/4 heads of 128,
   float32 params, bfloat16 compute, seeded random weights) resolved
   through the AR function registry, 16 requests of 1,024 prompt ids
   decoded teacher-forced and 64 ids generated greedily; every layer of
   every step must have launched decode_attn (none of them its generic
   instance), the logits must be
   finite, and one more step from the final caches through the kernel
   and through the plain path must agree; the same composition at 2
   layers in float32 must give the same ids on the card and the CPU;
4. time each path (items, posts or tokens a second over all steps' wall
   time, p50/p99 step ms, with a synchronize per step) and each kernel
   at the path's shapes -- the device time of the kernels a call
   launches, from a ``torch.profiler`` trace, and wall time a call from
   CUDA events -- beside its plain version, a one-call PyTorch yardstick
   where there is one, and the least time the card could take;
   decode_attn also after a read that empties L2, as a decode step's
   layer finds its cache; window_reduce at each of the staged tick's
   five calls, fused_tick, and armatch beside their simple instances;
5. profile a few ticks of each stream path, a few AR steps and a few
   decode steps with ``torch.profiler``: the device's busy share and
   the top device ops;
6. the recurrent and MoE families, one model at a time, each freed
   before the next is built: RecurrentGemma-2B at full width and depth
   (26 layers, 18 RG-LRU and 8 local attention of 10 query heads on one
   KV head of 256, bfloat16 compute) served as Yi-6B is, 16 requests of
   1,024 prompt ids and 64 generated, every attention layer of every
   step launching decode_attn's ``bf16_d256`` instance, then timed and
   profiled as in phases 4 and 5; RWKV6-7B at full width and depth and
   Mixtral-8x7B at full width cut to 8 of its 32 layers (32 would not
   fit in 80 GB), 16 requests of 64 prompt ids and 32 generated; each
   family's smoke config in float32 on the card and on the CPU with the
   same weights (RecurrentGemma's ring cache of 16 rows wraps); and
   Kimi-K2's full parameter count, on the meta device;
7. the edge fleet's data plane: 8 shards in 2 regions of 4, each at
   phase 3's full width (65,536 rows a tick, a 2^22-row ring), two core
   ranks under a fleet core budget of 1,024 and a fog budget of 768 a
   region, 16 ticks staged and 16 fused (cold and hot by turns of 4).
   Staged and fused must agree bitwise; both budgets must bind on every
   hot tick and neither on a cold one; fused_tick must launch once a
   shard a tick on the fused path and window_reduce five times on the
   staged path, never a simple instance; a 1-shard fleet must equal the
   stream executor bitwise, and with non-binding budgets the fleet must
   equal 8 lone executors; at 4,096 rows a shard, a degraded run (an
   unhealthy shard, an inactive one, a stalled uplink, a replay tick)
   must give bitwise the same on the card and the CPU, the core outputs
   within 1e-6.  Then timed and profiled as the single tick is; its
   launch counts join the fused_tick and window_reduce entries of the
   kernels line (``fleet_launches``);
8. the fleet's control plane, on phase 7's layout at full width, fused,
   each check failing the run: (1) a ``FleetController`` through a
   stall of shard 2 and a churn of shard 5 (its stream replayed on a
   backup in its region, its sliding window carry handed over and
   back), budgets pinned ample, against a healthy fleet without a
   controller on the same feed: every stream's windows equal (one
   stated window of the stalled stream apart), the watermark monotone,
   no late row, the catch-up counted in ``late_excluded``, shard 2
   flagged and re-admitted, the replayed rows those offered with the
   replay flag; (2) the default elastic core and fog policies on the
   hot/cold feed grow and shrink, ``resizes`` as the log counts them;
   (3) the whole controlled arc with a drop SLO that breaches and
   recovers at 4,096 rows a shard on the card and the CPU: each tick's
   ``ControlDecision`` and the event log equal, the outputs and final
   state bitwise, core outputs within 1e-6; (4) ``step_cost`` of one
   fleet tick, the fused_tick bytes its wrappers reported, the stage
   table and the roofline at the card's peaks; (5) the controller's tick
   p50/p99 beside the step's, 8 fused_tick launches a tick, which join
   the fused_tick entry of the kernels line (``control_launches``);
9. training, once phase 8's fleet is freed: Yi-6B at full width cut to
   16 of its 32 layers (float32 AdamW state is 16 bytes a parameter:
   52.7 GB at 16 layers, 97.0 GB at 32), float32 params, bfloat16
   compute, trained through ``launch.train.run`` for 8 steps of
   ``SyntheticTokens`` (batch 2 x seq 4,096 in 2 microbatches, lr 3e-4
   under ``train.py``'s cosine schedule), each check failing the run:
   every loss finite, the optimizer step 8, two more steps on a repeated
   batch lowering its loss, no launch of any hand kernel in those steps
   (the training path computes attention, GEMMs, norms, the loss and
   AdamW in plain PyTorch, as the reference computes them in jnp); then
   the learning witness: the same weights on the same 8 fresh batches
   at peak lrs 1e-4, 3e-5, 1e-5 and 3e-6, one model at a time, every
   loss finite and, at the last lr, the mean of the last 4 losses under
   the first 4's (whether the lr-3e-4 run's fall is printed); then,
   at Yi-6B's smoke config in float32, 3 steps on the card against the
   CPU from the same weights (losses within 1e-5 relative, parameters
   within 1e-5 of each leaf's largest), 1 against 2 microbatches on the
   card (loss within 1e-6, gradients within 1e-5 of each leaf's
   largest), and a checkpoint at step 2 restored plus 2 steps against 4
   uninterrupted steps (parameters within 1e-6).  It prints step
   p50/p99, tokens/s, the peak of ``torch.cuda.max_memory_allocated``
   and the model FLOPs of a step, each beside the card's name and power
   limit;
10. the compile-once paths at full width, graphed against the same
   paths under ``capture.disable()`` (eager), each check failing the
   run: each stream path 64 ticks, then a tick at a new core budget, a
   backfill tick and 3 live ticks, every ``StepOutput``, the final
   state and the lineage bitwise, ``trace_count`` 1 and
   ``_compile_count`` 1, launch counts equal; Yi-6B's decode step as
   the registry captures it, the first 256 of the serve run's 1,088
   steps teacher-forced, the logits bitwise at every step, the caches
   at the end, ``aot_cached`` 1, 32 decode_attn launches a step; the
   fused 8-shard fleet 16 ticks with a health and a membership flip and
   both budgets cut after the capture, bitwise, then a remesh to 6
   shards and ``trace_count`` 2.  It prints each path's p50/p99 and
   device busy share, eager and graphed, its graph's memory pool, and
   the card's name and power limit.

The line before the last is a JSON object of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits 1 before printing either.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

#: H100 SXM data-sheet peaks: HBM bandwidth, and float32 outside the
#: tensor cores (the kernels' adds and compares run there).
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: int32 outside the tensor cores, per NVIDIA's Hopper white paper: 64
#: INT32 lanes an SM a clock x 132 SMs x the 1.98 GHz boost clock (the
#: hilbert and armatch kernels' shifts, xors, ands and compares)
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9
#: bf16 on the tensor cores, dense (decode attention's bf16 products)
PEAK_BF16_OPS_S = 989e12


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


def _device_events(prof, tag: str, after: str | None = None) -> list[dict]:
    """The kernel, memcpy and memset events of a finished
    ``torch.profiler`` capture, read from its Chrome trace (written to
    ``build/``, git-ignored).  With ``after``, only the device events
    that start after the host entered the ``record_function`` range of
    that name, less half of :data:`SETTLE_S` (the device and host clocks
    may disagree; the capture leaves the device idle for ``SETTLE_S``
    before it enters the range)."""
    path = ROOT / "build" / f"profile_{tag}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    t0 = float("-inf")
    if after is not None:
        marks = [e["ts"] for e in events if e.get("name") == after
                 and e.get("cat") == "user_annotation"]
        if not marks:
            _fail(f"{tag}: the trace holds no {after!r} range")
        t0 = min(marks) - SETTLE_S / 2 * 1e6
    return [e for e in events if "dur" in e and e.get("cat") in
            ("kernel", "gpu_memcpy", "gpu_memset") and e["ts"] >= t0]


def _prime_profiler(device) -> None:
    """One throw-away ``torch.profiler`` capture.  The process's first
    capture starts the device tracer and can miss the device ops
    launched while it does; every later capture sees them all."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        for _ in range(16):
            x = x + 1
        torch.cuda.synchronize()


def _base_name(event_name: str) -> str:
    """The unqualified function name of a traced kernel:
    ``decode_attn_bf16_kernel`` of ``void (anonymous
    namespace)::decode_attn_bf16_kernel<128, 1>((anonymous
    namespace)::Args)``."""
    name = event_name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0),
              default=len(name))
    words = name[:cut].split()
    return words[-1].split("::")[-1] if words else ""


#: the cold-cache flush's own kernel (an argmax over a 192 MB buffer,
#: an op no timed function runs), left out of every device sum
FLUSH_OP = "ArgMaxOps"
#: seconds a capture waits after its tracer starts and before it stops:
#: without it, a capture that follows one of thousands of ops has traced
#: 8 of 10 kernels launched at once (H100, armatch's simple instance)
SETTLE_S = 0.05


def _settle() -> None:
    """A synchronized throw-away op (an argmax, left out of the sums
    like the flush), then a pause, so that the device tracer is up."""
    torch.zeros(1, device="cuda").argmax()
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


#: the ``record_function`` range around ``_timed``'s loop
TIMED_RANGE = "chip_smoke_timed_loop"


def _timed(fn, reps: int, tag: str, kernel: str | None = None,
           flush=None) -> tuple[float, float]:
    """(device ms, wall ms) a call of ``fn()`` over ``reps`` calls back
    to back.  Device time sums the device ops the profiler saw in the
    loop's range (:data:`TIMED_RANGE`), or, given ``kernel``, the traced
    kernels whose function name starts with it: the range must hold
    exactly ``reps`` of them, one a call (the wrapper's other ops are
    left out).  Given ``kernel``, one call more runs inside the capture
    before the range, and the device idles :data:`SETTLE_S` after it: a
    capture that follows millions of untraced launches has missed its
    first kernel (H100).  With ``flush``, ``flush()`` runs before each
    call (a read of more bytes than L2 holds, so the call finds its
    inputs in device memory, as a decode step's layer does) and its own
    kernel is left out of the sums; wall time is then not measured (0).
    Otherwise wall time is CUDA events around the loop, which the host's
    launch rate bounds whenever a call's device work is shorter than its
    launch."""
    fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        out = _timed_once(fn, reps, tag, kernel, flush)
        if isinstance(out, tuple):
            return out
        # a capture that traced none or part of the loop's kernels (seen
        # on an H100 after thousands of graph replays): say so and take
        # it once more
        msg = f"{tag}: {out} {kernel}* kernels traced in the timed loop, " \
            f"want {reps}"
        if attempt == 2:
            _fail(msg)
        print(f"profile {msg}; the capture is taken once more")


def _timed_once(fn, reps, tag, kernel, flush):
    """One capture of :func:`_timed`: its (device ms, wall ms), or the
    number of ``kernel``'s launches traced where that is not ``reps``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _settle()
        if kernel is not None:
            if flush is not None:
                flush()
            fn()
            _settle()
        with record_function(TIMED_RANGE):
            start.record()
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            stop.record()
        torch.cuda.synchronize()
        time.sleep(SETTLE_S)
    events = [e for e in _device_events(prof, tag, after=TIMED_RANGE)
              if FLUSH_OP not in e["name"]]
    if kernel is not None:
        events = [e for e in events
                  if _base_name(e["name"]).startswith(kernel)]
        if len(events) != reps:
            return len(events)
    wall_ms = 0.0 if flush is not None else start.elapsed_time(stop) / reps
    return sum(e["dur"] for e in events) * 1e-3 / reps, wall_ms


def _wrappers() -> dict:
    """Each kernel's wrapper; ``<wrapper>.launches`` counts its launches."""
    from repro_torch.kernels.armatch import armatch
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.fused_tick import fused_tick
    from repro_torch.kernels.hilbert import hilbert_xy2d
    from repro_torch.kernels.window_reduce import window_reduce
    return {"window_reduce": window_reduce, "fused_tick": fused_tick,
            "hilbert": hilbert_xy2d, "armatch": armatch,
            "decode_attn": decode_attention}


#: the wrappers whose first-port kernel stays as a ``simple`` instance,
#: reached only by name and counted by ``<wrapper>.simple_launches``
SIMPLE = ("window_reduce", "fused_tick", "armatch")


def zero_launches() -> None:
    for w in _wrappers().values():
        w.launches = 0
    _wrappers()["decode_attn"].generic_launches = 0
    for name in SIMPLE:
        _wrappers()[name].simple_launches = 0


def read_simple() -> dict:
    return {name: _wrappers()[name].simple_launches for name in SIMPLE}


def read_launches() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


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
    from repro_torch.stream.executor import StepOutput
    from repro_torch.testing import DEVICE_MATH
    results = {}
    for name, fused in (("staged", False), ("fused", True)):
        ex, state = make_executor(sz, device, fused=fused)
        state, _, _, _ = drive(ex, state, sz, device, sz.warmup)
        del ex, state
        ex, state = make_executor(sz, device, fused=fused)
        zero_launches()
        state, secs, outs, snap = drive(ex, state, sz, device, sz.ticks,
                                        keep=True, snap_at=sz.cpu_ticks)
        launches, simple = read_launches(), read_simple()
        results[name] = dict(state=state, secs=secs, outs=outs, snap=snap,
                             launches=launches,
                             metrics=state.metrics.as_dict())
        del ex
        if any(simple.values()):
            _fail(f"{name} tick path launched a simple instance: {simple}")
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


# ---- phase 3, AR: the Associative-Rendezvous data plane -------------------

class ARSizes(NamedTuple):
    n: int              # messages posted a step
    shard: int          # rows of the RP's DHT shard (16 batches)
    interests: int      # standing interests of the notify match
    queries: int        # associative queries a step
    steps: int          # measured steps
    warmup: int = 3


#: the repo's AR benches raised to one card: a 16 x 16 RP overlay with
#: a routing table at granularity 8 (``benchmarks/routing.py``), the
#: shard of ``benchmarks/store_query.py`` (value_dim 8) at 2^20 rows.
#: The interest and query counts are this smoke run's choices, sized to
#: load both kernel shapes; no published AR mix stands behind them.
AR_FULL = ARSizes(n=65536, shard=1 << 20, interests=1024, queries=32,
                  steps=64)
#: the same composition, small enough to run on the CPU too
AR_SMALL = ARSizes(n=4096, shard=1 << 16, interests=256, queries=4,
                   steps=2, warmup=0)
AR_GRID, AR_GRANULARITY, AR_VALUE_DIM, AR_RESULTS = 16, 8, 8, 16
AR_FUNCTIONS = 64


class ARPlane(NamedTuple):
    table: torch.Tensor         # [4^8] cell -> rank
    pool: torch.Tensor          # [n, 128] data profiles
    interests: torch.Tensor     # [interests, 128]
    queries: torch.Tensor       # [queries, 128]
    registry: object            # FunctionRegistry of AR_FUNCTIONS profiles
    fn_interest: np.ndarray     # what the registry is asked for
    num_ranks: int
    capacity: int               # messages a rank takes from this source


class ARStep(NamedTuple):
    idx: torch.Tensor
    ranks: torch.Tensor
    send: torch.Tensor
    plan: tuple
    mine: torch.Tensor
    notify: torch.Tensor
    answers: list               # (values, hits, n_hits) per query
    found: list                 # registry hits, by name


def make_ar(sz: ARSizes, device) -> ARPlane:
    """The overlay, the message pool, the interests, the queries and
    the function registry, made once with numpy from seed 7: the pool
    and the interests use all six slot kinds of ``tests/test_kernels.py``
    over an 8-word vocabulary; queries use the five that an interest can
    satisfy (a NUM interest slot never matches)."""
    from repro_torch.core import profiles as P
    from repro_torch.core.overlay import Overlay
    from repro_torch.kernels.checks import random_profiles
    rng = np.random.default_rng(7)
    overlay = Overlay.from_mesh_shape(AR_GRID, AR_GRID, capacity=4,
                                      replication=2)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return ARPlane(
        table=dev(overlay.routing_table(AR_GRANULARITY)),
        pool=dev(random_profiles(rng, sz.n)),
        interests=dev(random_profiles(rng, sz.interests, max_slots=3)),
        queries=dev(random_profiles(rng, sz.queries, kinds=(0, 1, 2, 4, 5),
                                    max_slots=1)),
        registry=_registry(device),
        fn_interest=P.ProfileBuilder().add_single("fn0*").build(),
        num_ranks=AR_GRID * AR_GRID, capacity=sz.n // 64)


def _registry(device):
    """A function registry of AR_FUNCTIONS profiles on ``device``."""
    from repro_torch.core import profiles as P
    from repro_torch.core.serverless import FunctionRegistry
    registry = FunctionRegistry(device)
    for i in range(AR_FUNCTIONS):
        registry.store_function(f"fn{i:02d}", P.profile(
            f"fn{i:02d}", "edge" if i % 2 else "core"), torch.tanh)
    return registry


def ar_feed(sz: ARSizes, step: int, plane: ARPlane):
    """Step ``step``'s posts, drawn on the pool's device from seed
    100 + step: a permutation of the pool and [n, 8] payloads."""
    gen = torch.Generator(plane.pool.device).manual_seed(100 + step)
    perm = torch.randperm(sz.n, generator=gen, device=plane.pool.device)
    payload = torch.randn((sz.n, AR_VALUE_DIM), generator=gen,
                          device=plane.pool.device)
    return plane.pool[perm], payload


def ar_step(plane: ARPlane, shard, keys, payload, me: int):
    """One RP's step of the data plane, in the reference's order: index,
    owner rank, bucketing, store what this RP receives, notify, query,
    find a function."""
    from repro_torch.core import routing, sfc, store
    from repro_torch.kernels.armatch import armatch
    idx = sfc.profile_index(keys)                       # hilbert
    ranks = routing.rank_of_message(keys, plane.table)  # hilbert again
    send, plan = routing.route_local(payload, idx, plane.table,
                                     plane.num_ranks, plane.capacity)
    mine = (plan.dest == me) & plan.keep
    shard = store.store(shard, keys, payload, mask=mine)
    notify = armatch(keys, plane.interests)
    answers = [store.query_match(shard, q, AR_RESULTS)
               for q in plane.queries]
    found = [e.name for e in plane.registry.find(plane.fn_interest)]
    return shard, ARStep(idx, ranks, send, plan, mine, notify, answers, found)


def ar_setup(sz: ARSizes, plane: ARPlane, device, me: int | None = None):
    """The RP's shard, pre-filled to capacity by 16 stores of n rows
    (seeds 1000 + i), and ``me``: by default the rank that owns the most
    of step 0's messages, read once on the host."""
    from repro_torch.core import routing, store
    if me is None:
        keys, _ = ar_feed(sz, 0, plane)
        owners = routing.rank_of_message(keys, plane.table)
        me = int(torch.bincount(owners.long(),
                                minlength=plane.num_ranks).argmax())
    shard = store.init_store(sz.shard, AR_VALUE_DIM, device=device)
    for i in range(sz.shard // sz.n):
        keys, payload = ar_feed(sz, 1000 + i, plane)
        shard = store.store(shard, keys, payload)
    return shard, me


def run_ar(sz: ARSizes, device) -> dict:
    """Phase 3's AR run: warm-up steps, then ``sz.steps`` measured
    steps with the launch counts zeroed just before; fails on a kernel
    not launched, a notify matrix all 0 or all 1, a query without a hit,
    a plan that loses messages, or a cursor that did not advance by the
    kept count."""
    plane = make_ar(sz, device)
    shard, me = ar_setup(sz, plane, device)
    for step in range(sz.warmup):
        shard, _ = ar_step(plane, shard, *ar_feed(sz, step, plane), me)
    feed = [ar_feed(sz, sz.warmup + i, plane) for i in range(sz.steps)]
    cursor0 = shard.cursor.clone()
    secs, tallies = [], []
    zero_launches()
    for keys, payload in feed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shard, out = ar_step(plane, shard, keys, payload, me)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        tallies.append(torch.stack([
            out.notify.sum(dtype=torch.int64),
            (out.plan.counts.sum() + out.plan.overflow.sum()).long(),
            out.mine.sum(dtype=torch.int64),
            torch.stack([a[2] for a in out.answers]).min().long()]))
        found = out.found
    launches = read_launches()
    for name in ("hilbert", "armatch"):
        if launches[name] == 0:
            _fail(f"AR path launched no {name} kernel")
    simple = _wrappers()["armatch"].simple_launches
    if simple:
        _fail(f"AR path launched the simple armatch instance {simple} times")
    t = torch.stack(tallies).cpu()
    notify_sum, posted, kept, min_hits = t.T
    pairs = sz.n * sz.interests
    if (notify_sum == 0).any() or (notify_sum == pairs).any():
        _fail(f"notify matrix all 0 or all 1: {notify_sum.tolist()}")
    if (posted != sz.n).any():
        _fail(f"plan lost messages: {posted.tolist()} != {sz.n}")
    if (min_hits == 0).any():
        _fail(f"a query found no hit: least hits a step {min_hits.tolist()}")
    advanced = int(shard.cursor - cursor0)
    if advanced != int(kept.sum()):
        _fail(f"cursor advanced {advanced}, kept {int(kept.sum())}")
    if not found:
        _fail("the registry found no function")
    return dict(secs=secs, launches=launches, me=me, plane=plane,
                shard=shard, kept=int(kept.sum()),
                notify_share=float(notify_sum.sum()) / (pairs * sz.steps),
                min_hits=int(min_hits.min()), found=len(found))


def run_ar_card_vs_cpu(sz: ARSizes, device, bitwise) -> int:
    """The AR composition on the card and on the CPU from the same
    inputs (the card's plane, shard and feed, copied): every output and
    the shard bitwise equal.  Returns the steps compared."""
    from repro_torch.core.store import ShardStore
    card = make_ar(sz, device)
    cpu = card._replace(table=card.table.cpu(), pool=card.pool.cpu(),
                        interests=card.interests.cpu(),
                        queries=card.queries.cpu(),
                        registry=_registry("cpu"))
    shard, me = ar_setup(sz, card, device)
    shards = {"card": shard, "cpu": ShardStore(*(t.cpu() for t in shard))}
    outs = {"card": [], "cpu": []}
    for step in range(sz.steps):
        keys, payload = ar_feed(sz, step, card)
        for name, plane in (("card", card), ("cpu", cpu)):
            dev = plane.pool.device
            shards[name], out = ar_step(plane, shards[name], keys.to(dev),
                                        payload.to(dev), me)
            outs[name].append(out)
    for i, (a, b) in enumerate(zip(outs["card"], outs["cpu"])):
        for f in ("idx", "ranks", "send", "mine", "notify"):
            bitwise(getattr(a, f), getattr(b, f), f"AR step {i} {f}")
        for f, x, y in zip(a.plan._fields, a.plan, b.plan):
            bitwise(x, y, f"AR step {i} plan {f}")
        for q, (x, y) in enumerate(zip(a.answers, b.answers)):
            for name, u, v in zip(("values", "hits", "n_hits"), x, y):
                bitwise(u, v, f"AR step {i} query {q} {name}")
        if a.found != b.found:
            _fail(f"AR step {i} registry: {a.found} != {b.found}")
    for f, x, y in zip(ShardStore._fields, shards["card"].log()
                       + (shards["card"].cursor,),
                       shards["cpu"].log() + (shards["cpu"].cursor,)):
        bitwise(x, y, f"AR shard {f}")
    return sz.steps


# ---- phase 3, serve: batched decode of Yi-6B behind the AR registry -------

class ServeSizes(NamedTuple):
    requests: int       # sequences decoded together
    prompt_len: int     # prompt ids decoded teacher-forced
    tokens: int         # ids generated greedily after the prompt
    layers: int | None = None   # None: the configuration's depth
    compute: str = "bfloat16"   # compute_dtype (params stay float32)
    arch: str = "yi_6b"         # the registry's architecture id
    smoke: bool = False         # its smoke config, not the full one


#: Yi-6B at full width and depth (``src/repro/configs/yi_6b.py``, the
#: default ``--arch`` of ``launch/serve.py``): 16 requests, 1,024-id
#: prompts, 64 generated ids, so the cache holds 1,088 rows a request
SERVE_FULL = ServeSizes(requests=16, prompt_len=1024, tokens=64)
#: the same composition at Yi-6B's widths, cut to 2 layers and float32
#: compute, small enough for the CPU
SERVE_SMALL = ServeSizes(requests=4, prompt_len=32, tokens=8, layers=2,
                         compute="float32")
#: RecurrentGemma-2B at full width and depth
#: (``src/repro/configs/recurrentgemma_2b.py``), Yi-6B's traffic: its 8
#: local-attention layers take decode_attn's bf16 D 256 instance
RG_FULL = ServeSizes(requests=16, prompt_len=1024, tokens=64,
                     arch="recurrentgemma_2b")
#: RWKV6-7B at full width and depth (``src/repro/configs/rwkv6_7b.py``);
#: no attention layer, so no TPU kernel on its path
RWKV_FULL = ServeSizes(requests=16, prompt_len=64, tokens=32,
                       arch="rwkv6_7b")
#: Mixtral-8x7B at full width (``src/repro/configs/mixtral_8x7b.py``),
#: its depth cut from 32 to 8 layers: all 32 hold more bf16 weights
#: than one 80 GB card
MIXTRAL_FULL = ServeSizes(requests=16, prompt_len=64, tokens=32, layers=8,
                          arch="mixtral_8x7b")
#: each new family's smoke config in float32, card against CPU: 48
#: steps, so that RecurrentGemma's ring cache of 16 rows (its smoke
#: window) wraps twice
FAMILY_SMALL = {arch: ServeSizes(requests=4, prompt_len=40, tokens=8,
                                 compute="float32", arch=arch, smoke=True)
                for arch in ("recurrentgemma_2b", "rwkv6_7b", "mixtral_8x7b")}
#: the kernel path against the plain (``use_kernel=False``) path at one
#: late step of the full-width run, both in bfloat16: the attention
#: outputs may differ by a bf16 ulp (2^-8 relative) in every attention
#: layer (32 in Yi-6B), and the logits carry those differences through
#: the rest of the stack; held as the largest difference over the
#: largest logit, over the requests whose MoE routing the two steps
#: share (``late_step``)
SERVE_KERNEL_VS_PLAIN = 5e-2
#: the reduced composition, card against CPU, float32: the logits'
#: largest difference over the largest logit
SERVE_CARD_VS_CPU = 1e-4


def serve_config(sz: ServeSizes):
    """``sz.arch`` (its full or smoke config) cut to ``sz``'s depth and
    compute dtype."""
    import dataclasses
    from repro_torch import configs
    cfg = (configs.smoke_config if sz.smoke else configs.get_config)(sz.arch)
    return dataclasses.replace(
        cfg, n_layers=sz.layers or cfg.n_layers,
        compute_dtype=getattr(torch, sz.compute))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def attn_shape(sz: ServeSizes) -> tuple:
    """(b, h, hkv, d, s) of the decode_attn call of ``sz``'s serve run
    with a full cache."""
    cfg = serve_config(sz)
    return (sz.requests, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            sz.prompt_len + sz.tokens)


def attn_caches(cfg, caches: list) -> list:
    """The ``{k, v}`` caches of ``cfg``'s attention layers, in order."""
    return [c for kind, c in zip(cfg.layer_kinds(), caches)
            if kind.startswith("attn")]


def run_serve(sz: ServeSizes, device) -> dict:
    """A serve run (phase 3, phase 6): the port's entry point
    (``serve.run``) with the launch counts zeroed just before; fails
    unless every attention layer of every step launched the decode
    kernel (none its generic instance; no launch for a model without
    attention), the registry's lookup launched armatch, every step's
    logits were finite and every id is in the vocabulary.  Then, from
    the final caches, one more step through the kernel and through the
    plain path must agree within :data:`SERVE_KERNEL_VS_PLAIN`."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = serve_config(sz)
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    zero_launches()
    res = serve.run(cfg, sz.requests, sz.prompt_len, sz.tokens,
                    device=device, model=model)
    launches = read_launches()
    generic = _wrappers()["decode_attn"].generic_launches
    steps = sz.prompt_len + sz.tokens
    n_attn = len(attn_caches(cfg, res.caches))
    # on the card the registry captured the step ahead of time, after one
    # eager warm-up step on copies of the caches; every loop step replayed
    warm = int(torch.device(device).type == "cuda")
    if launches["decode_attn"] != n_attn * (steps + warm):
        _fail(f"serve: {launches['decode_attn']} decode_attn launches, want "
              f"{n_attn} attention layers x ({steps} steps + {warm} "
              "warm-up)")
    if res.aot_cached != 1:
        _fail(f"serve: the registry cached {res.aot_cached} steps, want 1")
    if generic:
        _fail(f"serve: {generic} of the decode_attn launches took the "
              "generic instance")
    if launches["armatch"] == 0:
        _fail("serve: the registry's lookup launched no armatch kernel")
    if not res.finite:
        _fail("serve: non-finite logits")
    if res.tokens.shape != (sz.requests, sz.tokens) or \
            not ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all():
        _fail(f"serve: tokens {res.tokens.shape} outside [0, {cfg.vocab})")
    instance = None
    if n_attn:       # every attention layer's cache has the same layout
        from repro_torch.kernels.decode_attn.ops import plan
        last = attn_caches(cfg, res.caches)[-1]
        b, s, hkv, d = last["k"].shape
        instance = plan(b, cfg.n_heads, hkv, d, s, last["k"].stride(),
                        last["v"].stride(), last["k"].dtype).instance
    late, moe, flips = late_step(cfg, res)
    if late > SERVE_KERNEL_VS_PLAIN:
        _fail(f"serve: kernel vs plain path at step {steps + 1}: {late} of "
              f"the largest logit > {SERVE_KERNEL_VS_PLAIN}")
    return dict(cfg=cfg, res=res, launches=launches, late=late,
                init_s=init_s, steps=steps, warm=warm, n_attn=n_attn,
                flips=flips,
                instance=instance,
                overflow=[float(st["overflow_frac"]) for st in moe])


def _clone(state):
    if isinstance(state, list):
        return [_clone(v) for v in state]
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    return state.clone()


def late_step(cfg, res) -> tuple[float, list, list]:
    """One more decode step from ``res``'s caches and states, through the
    kernel and through ``use_kernel=False`` (each on its own copy): the
    largest logit difference over the largest logit, the kernel step's
    MoE stats (one dict a MoE layer), and one record for each request
    whose expert choice differed between the two steps in some MoE layer:
    the request, the first such layer, its MoE input's largest difference
    between the steps over the input's largest value, and the router's
    margin there (the kernel step's k-th less (k+1)-th probability).
    Those requests are left out of the difference: the two attention
    paths differ in the last bits, which can flip a near tie of the
    router's top k, and a flipped choice sends the request through other
    experts.  Fails unless each flip is such a near tie -- the input
    agrees within :data:`SERVE_KERNEL_VS_PLAIN`, so no fault confined to
    the request changed it -- unless no MoE layer of either step dropped
    a choice while a request is left out (without drops every other
    request's output depends only on its own choices), and if every
    request flipped."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    tok = torch.argmax(res.logits, dim=-1).to(torch.int32)[:, None]
    experts = [(i, layer.moe) for i, layer in enumerate(res.model.layers)
               if getattr(layer, "moe", None) is not None]
    out, seen = {}, {}
    with torch.inference_mode():
        for use_kernel in (True, False):
            rec = seen[use_kernel] = []

            def hook(mod, args, result, rec=rec):
                h = args[0].reshape(-1, args[0].shape[-1])
                probs, _, ids = M.route(h[None], mod.p["router"],
                                        mod.cfg.top_k)
                rec.append(dict(h=h.float(), probs=probs[0], ids=ids[0],
                                stats=result[1]))
            hooks = [m.register_forward_hook(hook) for _, m in experts]
            caches = _clone(res.caches)
            try:
                out[use_kernel], _, _ = T.decode_step(
                    cfg, res.model, tok, caches, res.lengths,
                    use_kernel=use_kernel)
            finally:
                for hk in hooks:
                    hk.remove()
            del caches
    kern, plain = seen[True], seen[False]
    flips = []
    for r in range(tok.shape[0]):
        j = next((j for j, (a, b) in enumerate(zip(kern, plain))
                  if not torch.equal(a["ids"][r], b["ids"][r])), None)
        if j is None:
            continue
        a, b = kern[j], plain[j]
        k = a["ids"].shape[-1]
        top = torch.sort(a["probs"][r], descending=True).values
        flips.append(dict(request=r, layer=experts[j][0],
                          input=_rel(a["h"][r], b["h"][r]),
                          margin=float(top[k - 1] - top[k])))
    if len(flips) == tok.shape[0]:
        _fail("serve: every request's expert choice differs between the "
              "kernel and the plain step")
    over = [float(x["stats"]["overflow_frac"]) for x in kern + plain]
    if flips and any(over):
        _fail(f"serve: requests {[f['request'] for f in flips]} flipped "
              f"their expert choice while MoE layers dropped choices "
              f"(overflow_frac, kernel then plain step, {over}): a flip "
              "can drop another request's choice")
    for f in flips:
        if f["input"] > SERVE_KERNEL_VS_PLAIN:
            _fail(f"serve: request {f['request']}'s expert choice flipped "
                  f"at layer {f['layer']}, whose MoE input differs by "
                  f"{f['input']} of its largest between the kernel and "
                  f"the plain step (> {SERVE_KERNEL_VS_PLAIN}): not a near "
                  "tie of the router")
    same = torch.ones(tok.shape[0], dtype=torch.bool, device=tok.device)
    same[[f["request"] for f in flips]] = False
    return (_rel(out[True][same], out[False][same]),
            [x["stats"] for x in kern], flips)


def run_serve_card_vs_cpu(sz: ServeSizes, device) -> dict:
    """The serve composition on the card and on the CPU with the same
    weights (drawn on the card, copied): the same ids, and final logits
    within :data:`SERVE_CARD_VS_CPU` of the largest."""
    import copy
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = serve_config(sz)
    model = T.init_params(cfg, seed=1, device=device)
    runs = {}
    for name, dev, m in (("card", device, model),
                         ("cpu", "cpu", copy.deepcopy(model).cpu())):
        runs[name] = serve.run(cfg, sz.requests, sz.prompt_len, sz.tokens,
                               device=dev, model=m)
    card, cpu = runs["card"], runs["cpu"]
    if not (card.tokens == cpu.tokens).all():
        _fail(f"serve card vs CPU: tokens differ\n{card.tokens}\n"
              f"{cpu.tokens}")
    rel = _rel(card.logits, cpu.logits)
    if rel > SERVE_CARD_VS_CPU:
        _fail(f"serve card vs CPU: logits differ by {rel} of the largest")
    return dict(rel=rel, steps=len(card.secs))


# ---- phase 4: kernel timing -----------------------------------------------

#: each kernel's TPU original (file:line of the function that reaches
#: ``pl.pallas_call``)
TPU_KERNELS = {
    "window_reduce": "src/repro/kernels/window_reduce/window_reduce.py:49",
    "fused_tick": "src/repro/kernels/fused_tick/fused_tick.py:108",
    "hilbert": "src/repro/kernels/hilbert/hilbert.py:48",
    "armatch": "src/repro/kernels/armatch/armatch.py:83",
    "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:68",
}
#: each kernel's bytes and operations, the bounds' inputs, come from
#: ``repro_torch.kernels.cost`` (the counts the cost model uses too)


def _us(pair):
    return "none" if pair is None else \
        f"{pair[0] * 1e3:.4f} us device ({pair[1] * 1e3:.4f} us wall)"


def _bound(nbytes: int, ops: int, peak_ops: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_row(name: str, rec: dict, nbytes: int, ops: int,
                peak_ops: float, launches: int, err: float,
                where: str) -> dict:
    """One entry of the kernels line, printed as it is made."""
    if rec["ms"][0] <= 0.0 or rec["plain_ms"][0] <= 0.0:
        _fail(f"{name}: the profiler saw no device time")
    bound_ms, bound_by = _bound(nbytes, ops, peak_ops)
    print(f"kernel {name} a call: {_us(rec['ms'])}, plain "
          f"{_us(rec['plain_ms'])}, library {_us(rec['library_ms'])}, "
          f"bound {bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} bytes, "
          f"{ops} operations), launches {launches} ({where})")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name], "launches": launches,
            "max_abs_err": err, "ms": rec["ms"][0],
            "plain_ms": rec["plain_ms"][0], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": rec["library_ms"] and rec["library_ms"][0]}


def _tick_shape(kernel: str, tag: str, fn, nbytes: int, a_tick: int,
                reps: int = 200, plain=None, library=None) -> dict:
    """One stream-tick kernel call timed through its planned (span) and
    its simple instance in the same run, printed beside its byte bound;
    given ``plain`` and ``library`` (callables, ``None`` for a library
    call where no single PyTorch call computes the function), also the
    plain version's and the library call's times on the same input."""
    ms = _timed(lambda: fn(None), reps, f"{kernel}_{tag}",
                kernel=f"{kernel}_kernel_span")
    simple = _timed(lambda: fn("simple"), reps, f"{kernel}_{tag}_simple",
                    kernel=f"{kernel}_kernel_simple")
    bound_ms, bound_by = _bound(nbytes, 0, PEAK_F32_OPS_S)
    out = {"call": tag, "instance": "span", "ms": ms[0],
           "wall_ms": ms[1], "simple_ms": simple[0], "bound_ms": bound_ms,
           "bound_by": bound_by, "launches_a_tick": a_tick}
    others = ""
    if plain is not None:
        out["plain_ms"] = _timed(plain, 20, f"{kernel}_{tag}_plain")[0]
        lib = None if library is None else \
            _timed(library, reps, f"{kernel}_{tag}_library")
        out["library_ms"] = lib and lib[0]
        others = (f"; plain {out['plain_ms'] * 1e3:.4f} us device, library "
                  + ("none (no single PyTorch call)" if lib is None
                     else _us(lib)))
    print(f"{kernel} {tag}: span instance {_us(ms)} = "
          f"{nbytes / ms[0] / 1e6:.1f} GB/s, {bound_ms / ms[0]:.4f} of the "
          f"bound {bound_ms * 1e3:.4f} us ({bound_by}: {nbytes} bytes); "
          f"simple instance {_us(simple)} ({simple[0] / ms[0]:.2f}x)"
          f"{others}; {a_tick} a tick")
    return out


def time_kernels(sz: Sizes, device, results, errs):
    """window_reduce at each of the staged tick's five calls and
    fused_tick at the fused tick's call, each through the instance its
    plan names beside the simple instance in the same run, and each
    window_reduce call beside its plain version and its library call
    (``avg_pool1d`` for a sum, ``max_pool1d`` for a max, none for a
    min); the kernels line's times are the ``[T x D]`` call's
    (window_reduce) and the fused call's, beside the plain version and,
    for window_reduce, ``avg_pool1d`` on the same block."""
    from repro_torch.core import rules as R
    from repro_torch.kernels import cost
    from repro_torch.kernels.fused_tick import fused_tick, fused_tick_ref
    from repro_torch.kernels.window_reduce import (sliding_reduce,
                                                   sliding_reduce_ref)
    t = sz.batch + sz.window - sz.stride        # carry + one micro-batch
    nw = sz.batch // sz.stride
    w, s = sz.window, sz.stride
    gen = torch.Generator(device).manual_seed(3)
    # window_reduce at the staged tick's calls: the mean aggregate over
    # the [T, D] features, the signal column's sum, max and min
    # (window_features) and the wall column's min (the lineage birth)
    xp = torch.randn((t, sz.d), generator=gen, device=device)
    sig = torch.randn((t, 1), generator=gen, device=device)
    wall = torch.rand((t, 1), generator=gen, device=device) * 1e3
    calls = ((f"[{t} x {sz.d}] sum (mean)", xp, "sum"),
             (f"[{t} x 1] sum (signal)", sig, "sum"),
             (f"[{t} x 1] max (signal)", sig, "max"),
             (f"[{t} x 1] min (signal)", sig, "min"),
             (f"[{t} x 1] min (wall)", wall, "min"))
    a_tick = results["staged"]["launches"]["window_reduce"] // sz.ticks \
        // len(calls)
    shapes = []
    pools = {"sum": torch.nn.functional.avg_pool1d,
             "max": torch.nn.functional.max_pool1d}
    for tag, x, op in calls:
        xt = x.t().contiguous()[None]           # [1, D, T] for the pools
        shapes.append(_tick_shape(
            "window_reduce", tag,
            lambda how, x=x, op=op: sliding_reduce(x, w, s, nw, op,
                                                   instance=how),
            cost.window_reduce(x.shape[1], w, s, nw)[0], a_tick,
            plain=lambda x=x, op=op: sliding_reduce_ref(x, w, s, nw, op),
            library=None if op not in pools else
            lambda xt=xt, op=op: pools[op](xt, w, s)))
    xcl = xp.t().contiguous()[None]             # [1, D, T] for the pools
    wr = dict(
        ms=(shapes[0]["ms"], shapes[0]["wall_ms"]),
        plain_ms=_timed(lambda: sliding_reduce_ref(xp, w, s, nw, "sum"), 20,
                        "window_reduce_plain"),
        library_ms=_timed(lambda: torch.nn.functional.avg_pool1d(
            xcl, w, s), 200, "avg_pool1d"))
    wr_bytes, wr_ops = cost.window_reduce(sz.d, w, s, nw)
    # fused_tick at the fused tick's call: [T, 2 + D] rows + [T] mask
    seq = torch.cat([torch.arange(t, dtype=torch.float32, device=device)
                     [:, None], torch.randn((t, 1 + sz.d), generator=gen,
                                            device=device)], dim=1)
    valid = torch.rand((t,), generator=gen, device=device) < 0.95
    table = _engine(R).table()
    l = 1 + sz.d                                # columns the kernel reads
    ft_bytes, ft_ops = cost.fused_tick(t, l, sz.d, nw, w)
    ft_shape = _tick_shape(
        "fused_tick", f"[{t} x {2 + sz.d}]",
        lambda how: fused_tick(seq, valid, w, s, table=table, instance=how),
        ft_bytes, results["fused"]["launches"]["fused_tick"] // sz.ticks)
    ft = dict(
        ms=(ft_shape["ms"], ft_shape["wall_ms"]),
        plain_ms=_timed(lambda: fused_tick_ref(seq, valid, w, s, table), 5,
                        "fused_tick_plain"),
        library_ms=None)
    rows = []
    for name, rec, nbytes, ops, path, per_shape in (
            ("window_reduce", wr, wr_bytes, wr_ops, "staged", shapes),
            ("fused_tick", ft, ft_bytes, ft_ops, "fused", [ft_shape])):
        launches = results[path]["launches"][name]
        row = _kernel_row(
            name, rec, nbytes, ops, PEAK_F32_OPS_S, launches, errs[name],
            f"{launches / sz.ticks:g} a tick on the {path} path; the row's "
            f"time is the span instance's at the {per_shape[0]['call']} call")
        row["shapes"] = per_shape
        rows.append(row)
    return rows


def time_ar_kernels(sz: ARSizes, device, ar: dict, errs: dict) -> list:
    """hilbert at the routing step's call (the pool's points, order 16)
    and armatch at its two calls: the notify match and one query
    against the shard's log, each through the instance its plan names,
    beside the simple instance in the same run."""
    from repro_torch.core import sfc
    from repro_torch.kernels import cost
    from repro_torch.kernels.armatch import armatch, armatch_ref
    from repro_torch.kernels.armatch.ops import plan as armatch_plan
    from repro_torch.kernels.hilbert import hilbert_xy2d, hilbert_xy2d_ref
    plane, steps = ar["plane"], sz.steps
    x, y = sfc.profile_point(plane.pool)
    hil = dict(
        ms=_timed(lambda: hilbert_xy2d(x, y, 16), 200, "hilbert",
                  kernel="hilbert_xy2d_kernel"),
        plain_ms=_timed(lambda: hilbert_xy2d_ref(x, y, 16), 20,
                        "hilbert_plain"),
        library_ms=None)
    rows = [_kernel_row(
        "hilbert", hil, *cost.hilbert(x.numel(), 16), PEAK_INT32_OPS_S, ar["launches"]["hilbert"], errs["hilbert"],
        f"{ar['launches']['hilbert'] / steps:g} a step on the AR path")]
    log_keys = ar["shard"].log()[0]
    query = plane.queries[:1]
    shapes = []
    for tag, data, ints, reps, plain_reps, a_step in (
            ("notify", plane.pool, plane.interests, 10, 1, 1),
            ("query", log_keys, query, 50, 3, len(plane.queries))):
        m, n = data.shape[0], ints.shape[0]
        rec = dict(ms=_timed(lambda: armatch(data, ints), reps,
                             f"armatch_{tag}", kernel="armatch_kernel"),
                   library_ms=None)
        simple_ms = _timed(lambda: armatch(data, ints, instance="simple"),
                           reps, f"armatch_{tag}_simple",
                           kernel="armatch_kernel_simple")
        rec["plain_ms"] = _timed(lambda: armatch_ref(data, ints), plain_reps,
                                 f"armatch_{tag}_plain")
        nbytes, ops = cost.armatch(data, ints)
        bound_ms, bound_by = _bound(nbytes, ops, PEAK_INT32_OPS_S)
        ms, how = rec["ms"][0], armatch_plan(m, n)
        rate = (f"{nbytes / ms / 1e6:.1f} GB/s" if bound_by == "bytes"
                else f"{ops / ms / 1e6:.1f} Gop/s")
        print(f"armatch {tag} [{m} x {n}]: instance {how}, {_us(rec['ms'])}"
              f" = {rate}, {bound_ms / ms:.4f} of the bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} bytes, {ops} "
              f"operations, {ops / (m * n):.1f} a pair); simple instance "
              f"{_us(simple_ms)} ({simple_ms[0] / ms:.2f}x); plain "
              f"{_us(rec['plain_ms'])}; {a_step} a step")
        shapes.append({"call": tag, "shape": [m, n], "instance": how,
                       "ms": ms, "simple_ms": simple_ms[0],
                       "plain_ms": rec["plain_ms"][0], "bound_ms": bound_ms,
                       "bound_by": bound_by, "launches_a_step": a_step})
        if tag == "notify":
            notify = (rec, nbytes, ops)
    row = _kernel_row("armatch", *notify, PEAK_INT32_OPS_S,
                      ar["launches"]["armatch"], errs["armatch"],
                      f"{ar['launches']['armatch'] / steps:g} a step on the "
                      "AR path; the row's times are the notify call's")
    row["shapes"] = shapes
    rows.append(row)
    return rows


def time_serve_kernel(sv: dict, errs: dict) -> dict:
    """decode_attn at a serve step's call with its last attention
    layer's full cache (every request at 1,088 rows), beside its plain
    version and, as the one-call yardstick,
    ``F.scaled_dot_product_attention`` with the length mask and
    ``enable_gqa`` on the same cache views (checked to give the same
    answer within the bf16 tolerance)."""
    import torch.nn.functional as F
    from repro_torch.kernels import checks, cost
    from repro_torch.kernels.decode_attn import decode_attention, \
        decode_attn_ref
    from repro_torch.kernels.decode_attn.ops import plan_for
    cfg, res = sv["cfg"], sv["res"]
    last = attn_caches(cfg, res.caches)[-1]
    kc, vc = last["k"], last["v"]
    b, s, hkv, d = kc.shape
    h, g = cfg.n_heads, cfg.n_heads // hkv
    gen = torch.Generator(kc.device).manual_seed(9)
    q = torch.randn((b, h, d), generator=gen, device=kc.device).to(kc.dtype)
    lengths = torch.full((b,), s, dtype=torch.int32, device=kc.device)
    mask = (torch.arange(s, device=kc.device)[None, :]
            < lengths[:, None])[:, None, None, :]       # [B, 1, 1, S]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    def plain():
        return decode_attn_ref(q.reshape(b, hkv, g, d), kc.transpose(1, 2),
                               vc.transpose(1, 2), lengths,
                               scale=1.0 / d ** 0.5).reshape(b, h, d)
    tol = checks.DECODE_ATTN_TOL[kc.dtype]
    checks.max_err_within(library(), plain(), tol, "SDPA yardstick vs plain")
    how = plan_for(q, kc, vc, hkv)
    junk = torch.ones(48 << 20, device=kc.device)     # 192 MB, > L2

    def kernel():
        return decode_attention(q, kc, vc, lengths, num_kv_heads=hkv)
    # every instance's kernel is named decode_attn_*, one launch a call
    one = dict(kernel="decode_attn_")
    with torch.inference_mode():
        rec = dict(
            ms=_timed(kernel, 200, "decode_attn", **one),
            plain_ms=_timed(plain, 20, "decode_attn_plain"),
            library_ms=_timed(library, 50, "decode_attn_sdpa"))
        cold = dict(
            ms=_timed(kernel, 50, "decode_attn_cold", **one,
                      flush=junk.argmax),
            plain_ms=_timed(plain, 10, "decode_attn_plain_cold",
                            flush=junk.argmax),
            library_ms=_timed(library, 50, "decode_attn_sdpa_cold",
                              flush=junk.argmax))
    del junk
    nbytes, ops = cost.decode_attn(b, h, hkv, d, s, kc.element_size())
    steps = sv["steps"] + sv["warm"]
    row = _kernel_row(
        "decode_attn", rec, nbytes, ops, PEAK_BF16_OPS_S,
        sv["launches"]["decode_attn"], errs["decode_attn"],
        f"{sv['launches']['decode_attn'] / steps:g} a step on the "
        f"{cfg.name} serve path, {sv['n_attn']} attention layers, "
        f"{sv['steps']} steps and the capture's warm-up step")
    for name, r in (("back to back (L2 warm)", rec),
                    ("after a 192 MB read (L2 cold)", cold)):
        print(f"decode_attn {name} at {cfg.name} [{b} x {s} x {hkv} x "
              f"{d}], G {g}: instance {how.instance}, n_split "
              f"{how.n_split}, scratch 0 bytes in device memory (the splits "
              f"fold in the cluster's shared memory); kernel "
              f"{r['ms'][0] * 1e3:.3f} us = {nbytes / r['ms'][0] / 1e6:.1f} "
              f"GB/s, {row['bound_ms'] / r['ms'][0]:.4f} of the "
              f"{row['bound_ms'] * 1e3:.3f} us bound; SDPA "
              f"{r['library_ms'][0] * 1e3:.3f} us; plain "
              f"{r['plain_ms'][0] * 1e3:.3f} us")
    row.update(serve=cfg.name, shape=[b, h, hkv, d, s],
               instance=how.instance, n_split=how.n_split,
               cold_ms=cold["ms"][0], cold_plain_ms=cold["plain_ms"][0],
               cold_library_ms=cold["library_ms"][0])
    return row


def _profile(tag: str, steps: int, unit: str, fn,
             kernel: str | None = None) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``fn``: the device's
    busy share of the wall time and the top device ops; given
    ``kernel``, also the device time of the kernels whose function name
    starts with it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_events(prof, tag)
    busy = sum(e["dur"] for e in dev) * 1e-6
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    own = ""
    if kernel is not None:
        mine = sum(d for n, d in by_name.items()
                   if _base_name(n).startswith(kernel))
        own = f"; {kernel}* {mine / steps:.1f} us/{unit} device"
    print(f"profile {tag}: {steps} {unit}s in {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy * 1e3:.3f} ms = "
          f"{busy / wall:.4f} of the wall time, {len(dev) / steps:.1f} "
          f"device ops a {unit}{own}; top by device time: "
          + "; ".join(f"{n[:60]} {d / steps:.1f} us/{unit}"
                      for n, d in top))
    return dict(busy_share=busy / wall, ops=len(dev) / steps,
                busy_ms=busy * 1e3 / steps)


def profile_ticks(sz: Sizes, device, ticks=8) -> None:
    """Where a tick's time goes: ``torch.profiler`` over ``ticks`` ticks
    of each path, device time summed from the trace's device ops."""
    for name, fused in (("staged", False), ("fused", True)):
        ex, state = make_executor(sz, device, fused=fused)
        state, *_ = drive(ex, state, sz, device, sz.warmup)
        feed = [tick_batch(sz, i, device) for i in range(ticks)]
        box = [state]

        def tick(i):
            box[0], _ = ex.step(box[0], *feed[i])
        _profile(f"tick_{name}", ticks, "tick", tick,
                 kernel="fused_tick_kernel" if fused
                 else "window_reduce_kernel")
        del ex, state, box


def profile_ar(sz: ARSizes, ar: dict, steps=8) -> None:
    """Where an AR step's time goes, over ``steps`` more steps, and
    armatch's device time a step."""
    plane = ar["plane"]
    feed = [ar_feed(sz, 2000 + i, plane) for i in range(steps)]
    box = [ar["shard"]]

    def step(i):
        box[0], _ = ar_step(plane, box[0], *feed[i], ar["me"])
    _profile("ar", steps, "step", step, kernel="armatch_kernel")


def profile_serve(sv: dict, steps=8, tag="serve") -> None:
    """Where a decode step's time goes, over ``steps`` more steps from
    the run's final state (the ring cache wraps to its first row),
    through the run's captured step (replays)."""
    res = sv["res"]
    box = [res.logits, res.lengths]

    def one(i):
        tok = torch.argmax(box[0], dim=-1).to(torch.int32)[:, None]
        box[0], _, box[1] = res.step(res.model, tok, res.caches, box[1])
    _profile(tag, steps, "step", one, kernel="decode_attn_")


def run(sz: Sizes = FULL, ar_sz: ARSizes = AR_FULL,
        ar_small: ARSizes = AR_SMALL, serve_sz: ServeSizes = SERVE_FULL,
        serve_small: ServeSizes = SERVE_SMALL, rg_sz: ServeSizes = RG_FULL,
        device="cuda") -> dict:
    from repro_torch.kernels import build, checks
    from repro_torch.testing import assert_bitwise, assert_close
    # float32 matmuls in full precision on the card, so the core stage
    # and the float32 serve run are compared with the CPU at a float32
    # tolerance, not TF32's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"phase 1 build: {len(build.SOURCES)} kernels ready in "
          f"{time.perf_counter() - t0:.2f} s ({build.builds} compiled)")
    print(f"card: {_card_line()}")

    block = (sz.batch + sz.window - sz.stride, sz.d, sz.window, sz.stride)
    errs = {"window_reduce": checks.check_window_reduce(device, *block),
            "fused_tick": checks.check_fused_tick(device, *block),
            "hilbert": checks.check_hilbert(device, ar_sz.n),
            "armatch": checks.check_armatch(device, (
                (ar_sz.n, ar_sz.interests), (ar_sz.shard, 1))),
            "decode_attn": checks.check_decode_attn(
                device, attn_shape(serve_sz), attn_shape(rg_sz),
                attn_shape(MIXTRAL_FULL))}
    print(f"phase 2 kernels: bitwise equal to their plain versions, "
          f"decode_attn within {checks.DECODE_ATTN_TOL} (max abs err "
          f"{errs})")

    results = run_paths(sz, device, assert_bitwise, assert_close)
    adm = run_admission(sz, device)
    run_overlap(sz, device, assert_bitwise)
    print(f"phase 3 path: staged == fused bitwise over {sz.ticks} ticks, "
          f"card == CPU over {sz.cpu_ticks}, overlapped ingest == direct; "
          "metrics "
          f"{results['staged']['metrics']}; admission {adm}")
    ar = run_ar(ar_sz, device)
    compared = run_ar_card_vs_cpu(ar_small, device, assert_bitwise)
    print(f"phase 3 AR path: {ar_sz.steps} steps of {ar_sz.n} posts as RP "
          f"{ar['me']} of {AR_GRID * AR_GRID}, shard {ar_sz.shard} rows, "
          f"{ar['kept']} stored, notify matches {ar['notify_share']:.4f} of "
          f"the pairs, least query hits {ar['min_hits']}, registry hits "
          f"{ar['found']}; card == CPU bitwise over {compared} steps at "
          f"{ar_small.n} posts, shard {ar_small.shard}")
    torch.cuda.reset_peak_memory_stats()
    sv = run_serve(serve_sz, device)
    small = run_serve_card_vs_cpu(serve_small, device)
    res = sv["res"]
    print(f"phase 3 serve path: {sv['cfg'].name} ({sv['cfg'].n_layers} "
          f"layers, d_model {sv['cfg'].d_model}, compute "
          f"{serve_sz.compute}), {serve_sz.requests} requests resolved as "
          f"{res.resolved}, {serve_sz.prompt_len} prompt ids teacher-forced "
          f"+ {serve_sz.tokens} generated; init {sv['init_s']:.2f} s; "
          f"logits finite, ids in the vocabulary; kernel vs plain path at "
          f"the next step {sv['late']:.3e} of the largest logit; card == CPU "
          f"ids over {small['steps']} steps at {serve_small.layers} layers, "
          f"logits within {small['rel']:.3e}; first ids {res.tokens[0, :8]}")

    for name in ("staged", "fused"):
        # the first tick built and captured the step: left out, as the
        # executor's own histogram leaves it out (warmup_excluded)
        first, secs = results[name]["secs"][0], results[name]["secs"][1:]
        q = np.quantile(np.asarray(secs), [0.5, 0.99])
        print(f"path {name}: {sz.batch * len(secs) / sum(secs):.0f} "
              f"items/s (all rows over the graphed ticks), tick p50 "
              f"{q[0] * 1e3:.3f} ms, p99 {q[1] * 1e3:.3f} ms over "
              f"{len(secs)} ticks (the first, which captured, "
              f"{first * 1e3:.3f} ms, left out), launches "
              f"{results[name]['launches']}")
    q = np.quantile(np.asarray(ar["secs"]), [0.5, 0.99])
    print(f"path ar: {ar_sz.n * len(ar['secs']) / sum(ar['secs']):.0f} "
          f"posts/s (all posts over all steps), step p50 {q[0] * 1e3:.3f} ms, "
          f"p99 {q[1] * 1e3:.3f} ms over {len(ar['secs'])} steps, launches "
          f"{ar['launches']}")
    print_serve("serve", serve_sz, sv)
    _prime_profiler(device)
    kernels = {"kernels": time_kernels(sz, device, results, errs)
               + time_ar_kernels(ar_sz, device, ar, errs)
               + [time_serve_kernel(sv, errs)]}
    profile_ticks(sz, device)
    profile_ar(ar_sz, ar)
    profile_serve(sv)
    del sv, res, results, ar
    _free()
    kernels["kernels"].append(run_families(rg_sz, device, errs))
    _free()
    run_fleet_phase(sz, FLEET, device, kernels["kernels"])
    _free()
    run_control_phase(sz, FLEET, device, kernels["kernels"])
    _free()
    run_train_phase(TRAIN_FULL, TRAIN_SMALL, device)
    _free()
    run_graph_phase(sz, serve_sz, FLEET, device)
    return kernels


def run_fleet_phase(sz: Sizes, fz: FleetSizes, device, rows: list) -> None:
    """Phase 7: the fleet run and its checks (``run_fleet``), its timing
    and profile lines; the fleet's launch counts join the fused_tick and
    window_reduce entries of the kernels line (``rows``)."""
    from repro_torch.testing import assert_bitwise, assert_close
    t0 = time.perf_counter()
    fl = run_fleet(sz, fz, SMALL, FLEET_SMALL, device, assert_bitwise,
                   assert_close)
    s = fz.shards
    print(f"phase 7 fleet path: {s} shards in {fz.regions} regions of "
          f"{fz.edges}, {sz.batch} rows a shard a tick, core budget "
          f"{fz.core_budget} over {fz.num_core} core ranks, fog budget "
          f"{fz.fog_budget} a region; staged == fused bitwise over "
          f"{fz.ticks} ticks, both budgets bound on every hot tick and "
          f"neither on a cold one; a 1-shard fleet == the stream executor "
          f"bitwise over {fl['single']} ticks; the fleet == {s} lone "
          f"executors over {len(fz.checks)} ticks ({fl['oracle']} windows "
          f"escalated, no budget binding); card == CPU at {SMALL.batch} "
          f"rows a shard over {SMALL.ticks} degraded ticks, core outputs "
          f"within {fl['card_vs_cpu_err']:.3e}; launches "
          f"{_nonzero(fl['results']['fused']['launches'])} (fused), "
          f"{_nonzero(fl['results']['staged']['launches'])} (staged); "
          f"{time.perf_counter() - t0:.1f} s")
    print_fleet(sz, fz, fl)
    profile_fleet(sz, fz, device)
    for row in rows:
        path = {"fused_tick": "fused", "window_reduce": "staged"}.get(
            row["name"])
        if path is not None and "fleet_launches" not in row:
            n = fl["results"][path]["launches"][row["name"]]
            row["fleet_launches"] = n
            row["fleet_launches_a_tick"] = n / fz.ticks


def print_serve(tag: str, sz: ServeSizes, sv: dict) -> None:
    """A serve run's timing line: tokens a second over all steps' wall
    time, p50/p99 step ms, launches and the peak of device memory since
    the last reset."""
    secs = np.asarray(sv["res"].secs)
    q = np.quantile(secs, [0.5, 0.99])
    print(f"path {tag}: {sz.requests * len(secs) / secs.sum():.1f} "
          f"tokens/s (all tokens, prompt and generated, over all steps), "
          f"decode step p50 {q[0] * 1e3:.3f} ms, p99 {q[1] * 1e3:.3f} ms "
          f"over {len(secs)} steps, launches {sv['launches']}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _free() -> None:
    """Give the card's memory back before the next model is built."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _serve_line(sz: ServeSizes, sv: dict, small: dict) -> str:
    cfg, res = sv["cfg"], sv["res"]
    return (f"{cfg.name} ({cfg.n_layers} layers: {sv['n_attn']} attention, "
            f"decode_attn instance {sv['instance']}, "
            f"d_model {cfg.d_model}, compute {sz.compute}), {sz.requests} "
            f"requests resolved as {res.resolved}, {sz.prompt_len} prompt ids "
            f"teacher-forced + {sz.tokens} generated; init "
            f"{sv['init_s']:.2f} s; logits finite, ids in the vocabulary; "
            f"kernel vs plain path at the next step {sv['late']:.3e} of the "
            f"largest logit; smoke config card == CPU ids over "
            f"{small['steps']} steps, logits within {small['rel']:.3e}; "
            f"first ids {res.tokens[0, :8]}")


def run_families(rg_sz: ServeSizes, device, errs: dict) -> dict:
    """Phase 6: RecurrentGemma-2B served at ``rg_sz``, checked, timed and
    profiled, then RWKV6-7B and Mixtral-8x7B (8 layers), checked and
    profiled, each family's smoke config card against CPU, one model at
    a time; Kimi-K2's parameter count on the meta device.  Returns RecurrentGemma's
    decode_attn row of the kernels line."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    torch.cuda.reset_peak_memory_stats()
    rg = run_serve(rg_sz, device)
    small = run_serve_card_vs_cpu(FAMILY_SMALL[rg_sz.arch], device)
    print(f"phase 6 serve path: {_serve_line(rg_sz, rg, small)}")
    print_serve(f"serve {rg['cfg'].name}", rg_sz, rg)
    row = time_serve_kernel(rg, errs)
    profile_serve(rg, tag="serve_rg")
    del rg
    _free()
    for sz in (RWKV_FULL, MIXTRAL_FULL):
        torch.cuda.reset_peak_memory_stats()
        sv = run_serve(sz, device)
        small = run_serve_card_vs_cpu(FAMILY_SMALL[sz.arch], device)
        full = configs.get_config(sz.arch)
        cut = ""
        if sv["cfg"].n_layers != full.n_layers:
            n = T.param_count(full, T.init_params(full, device="meta"))
            cut = (f"; depth cut from {full.n_layers} to "
                   f"{sv['cfg'].n_layers} layers: all {full.n_layers} hold "
                   f"{n * 2 / 1e9:.1f} GB of bf16 weights")
        moe = "" if not sv["overflow"] else (
            f"; MoE overflow_frac of the next step, by layer "
            f"{sv['overflow']}; requests whose expert choice flipped "
            f"between the kernel and the plain step (left out of their "
            f"difference): {len(sv['flips'])} of {sz.requests}"
            + "".join(f" (request {f['request']} at layer {f['layer']}: "
                      f"MoE input {f['input']:.4e} of its largest apart, "
                      f"router margin {f['margin']:.4e})"
                      for f in sv["flips"]))
        print(f"phase 6 serve path: {_serve_line(sz, sv, small)}{cut}{moe}")
        print_serve(f"serve {sv['cfg'].name}", sz, sv)
        profile_serve(sv, tag=f"serve_{sz.arch}")
        del sv
        _free()
    kimi = configs.get_config("kimi_k2_1t_a32b")
    model = T.init_params(kimi, device="meta")
    print(f"phase 6 {kimi.name}: not served (one MoE layer alone holds "
          f"{sum(p.numel() for p in model.layers[1].moe.parameters()) * 2 / 1e9:.1f} "
          f"GB of bf16 weights); on the meta device "
          f"{T.param_count(kimi, model)} parameters, "
          f"{T.active_param_count(kimi, model)} active a token")
    return row


# ---- phase 7: the edge fleet at full width ---------------------------------

class FleetSizes(NamedTuple):
    regions: int        # R
    edges: int          # edge shards a region
    num_core: int       # core ranks (region 0's first edge columns)
    core_budget: int    # fleet-wide core slots a tick
    fog_budget: int     # escalations a region forwards a tick
    ticks: int          # measured ticks a path
    checks: tuple       # tick indices of the oracle and 1-shard checks

    @property
    def shards(self) -> int:
        return self.regions * self.edges


#: the layout of ``benchmarks/fleet.py``'s region run (8 shards in 2
#: regions of 4) and ``tests/test_fleet_regions.py``, each shard at the
#: single tick's full width (``FULL``); two core ranks, each at the
#: single tick's core capacity (512), under a fleet budget of 1,024.
#: The fog budget is 768 a region: 2 x 768 survivors exceed the core
#: budget on a hot tick (512 would not: 2 x 512 == 1,024), and a cold
#: region escalates about 190 windows a tick, so neither binds then
FLEET = FleetSizes(regions=2, edges=4, num_core=2, core_budget=1024,
                   fog_budget=768, ticks=16, checks=(0, 1, 4, 5))
#: the same layout at a size the CPU runs too (the card against the CPU)
FLEET_SMALL = FleetSizes(regions=2, edges=4, num_core=2, core_budget=64,
                         fog_budget=48, ticks=6, checks=(0, 4))
SMALL = Sizes(batch=4096, d=16, window=64, stride=32, capacity=1 << 16,
              ticks=6, cpu_ticks=6, dedupe=0, warmup=1)
#: core outputs (8 layers of tanh(h @ p)), the card against the CPU
FLEET_CORE = ("tanh/matmul rounding differs between CPU and CUDA "
              "libraries", 1e-6, 1e-6)


def make_fleet(sz: Sizes, fz: FleetSizes, device, fused=True, regions=None,
               edges=None, num_core=None, core_budget=None,
               fog_budget=-1, drop_rule=False):
    """A fleet of ``regions x edges`` shards (``fz``'s by default) at the
    single tick's per-shard config and core stand-in; ``fog_budget=None``
    is non-binding; ``drop_rule`` adds :data:`DROP_RULE` to the rules."""
    from repro_torch import convert
    from repro_torch.core import pipeline as P
    from repro_torch.core import rules as R
    from repro_torch.stream import StreamConfig
    from repro_torch.stream.fleet import FleetConfig, FleetExecutor
    cfg = StreamConfig(micro_batch=sz.batch, window=sz.window,
                       stride=sz.stride, capacity=sz.capacity,
                       lateness=64.0, fused=fused)
    engine = _engine(R)
    if drop_rule:
        name, feature, op, value, priority = DROP_RULE
        engine = R.RuleEngine(list(engine.rules) + [R.threshold_rule(
            name, feature, op, value, R.C_DROP, priority=priority)])
    p = convert.params_from_numpy(
        (np.random.default_rng(0).standard_normal((5 + sz.d, 5 + sz.d))
         * 0.1).astype(np.float32), device)
    pipe = P.two_tier_pipeline(_edge_fn, _core_fn, engine, core_params=p)
    rr = fz.regions if regions is None else regions
    ee = fz.edges if edges is None else edges
    fx = FleetExecutor(FleetConfig(
        stream=cfg, num_shards=rr * ee, num_regions=rr,
        num_core=fz.num_core if num_core is None else num_core,
        core_budget=fz.core_budget if core_budget is None else core_budget,
        fog_budget=fz.fog_budget if fog_budget == -1 else fog_budget),
        engine, pipe, device=device)
    return fx, fx.init_state(sz.d)


def fleet_batch(sz: Sizes, fz: FleetSizes, i: int, device, shards=None):
    """Tick ``i`` of the fleet's feed: shard ``s``'s batch made on the
    device from seed 10,000 + 100 s + i, hot (the signal shifted by 0.5,
    as ``tick_batch``'s hot regime) every other
    :data:`FLEET_HOT_EVERY` ticks."""
    s = fz.shards if shards is None else shards
    items = torch.empty((s, sz.batch, sz.d), device=device)
    for k in range(s):
        gen = torch.Generator(device).manual_seed(10_000 + 100 * k + i)
        items[k] = torch.randn((sz.batch, sz.d), generator=gen,
                               device=device)
    if fleet_hot(i):
        items[:, :, 0] += 0.5
    ts = (torch.arange(sz.batch, dtype=torch.float32, device=device)
          + float(i * sz.batch)).expand(s, sz.batch)
    return items, ts


#: the fleet feed's regime flips every this many ticks
FLEET_HOT_EVERY = 4


def fleet_hot(i: int) -> bool:
    return (i // FLEET_HOT_EVERY) % 2 == 1


def drive_fleet(fx, state, sz: Sizes, fz: FleetSizes, device, ticks):
    """``ticks`` fleet ticks, each timed between two synchronizes; the
    outputs, and each tick's cumulative fog-shed and core-overflow
    counters (read after the loop)."""
    secs, outs, counters = [], [], []
    for i in range(ticks):
        items, ts = fleet_batch(sz, fz, i, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = fx.step(state, items, ts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        counters.append(torch.stack([state.fog_shed.sum(),
                                     state.fleet_core_overflow[0].long()]))
    counts = torch.stack(counters).cpu().numpy()
    return state, secs, outs, np.diff(counts, axis=0, prepend=0)


def _fleet_state_bitwise(bitwise, a, b, what):
    """Two fleet states' leaves, less the ring's and carries' wall-time
    column (two runs stamp different clocks)."""
    cols = [0] + list(range(2, a.shard.rb.store.shape[-1]))
    bitwise(a.shard.rb.store[..., cols], b.shard.rb.store[..., cols],
            f"{what} ring")
    bitwise(a.shard.carry[..., cols], b.shard.carry[..., cols],
            f"{what} carry")
    for f in ("head", "tail"):
        bitwise(getattr(a.shard.rb, f), getattr(b.shard.rb, f),
                f"{what} ring {f}")
    for f in ("carry_valid", "max_ts"):
        bitwise(getattr(a.shard, f), getattr(b.shard, f), f"{what} {f}")
    for f in ("watermark", "region_watermark", "late_excluded"):
        bitwise(getattr(a, f), getattr(b, f), f"{what} {f}")


def run_fleet(sz: Sizes, fz: FleetSizes, small: Sizes, fz_small: FleetSizes,
              device, bitwise, close) -> dict:
    """Phase 7: the fleet at ``sz`` a shard, staged and fused, each for
    ``fz.ticks`` ticks with the launch counts zeroed just before; then
    its checks, each failing the run:

    1. staged == fused, bitwise, every output, counter and ring;
    2. a 1-shard fleet == the stream executor (``make_executor``),
       bitwise, every output and counter;
    3. with non-binding budgets, the fleet's aggregates, features,
       window counts, consequences and escalations == S lone executors;
    4. at ``small`` a shard, the card == the CPU with one unhealthy
       shard, one inactive, one stalled uplink and one replay tick:
       bitwise, the core outputs within ``FLEET_CORE``;
    5. fog shed and core overflow on every hot tick, neither on a cold;
    6. fused_tick launched S times a tick on the fused path,
       window_reduce 5 S on the staged, never a simple instance."""
    from repro_torch.stream.executor import StepOutput
    from repro_torch.testing import Tolerance
    s = fz.shards
    results = {}
    for name, fused in (("staged", False), ("fused", True)):
        fx, state = make_fleet(sz, fz, device, fused=fused)
        state, *_ = drive_fleet(fx, state, sz, fz, device, sz.warmup)
        del fx, state
        fx, state = make_fleet(sz, fz, device, fused=fused)
        zero_launches()
        state, secs, outs, deltas = drive_fleet(fx, state, sz, fz, device,
                                                fz.ticks)
        launches, simple = read_launches(), read_simple()
        results[name] = dict(state=state, secs=secs, outs=outs,
                             deltas=deltas, launches=launches,
                             metrics=state.metrics.as_dict())
        del fx
        if any(simple.values()):
            _fail(f"fleet {name} path launched a simple instance: {simple}")
        kernel, other = ("fused_tick", "window_reduce") if fused \
            else ("window_reduce", "fused_tick")
        want = (1 if fused else 5) * s * fz.ticks
        if launches[kernel] != want or launches[other]:
            _fail(f"fleet {name} path launched {kernel} "
                  f"{launches[kernel]} times and {other} {launches[other]} "
                  f"over {fz.ticks} ticks of {s} shards, want {want} and 0")
    st, fu = results["staged"], results["fused"]
    for i, (a, b) in enumerate(zip(st["outs"], fu["outs"])):
        for field in StepOutput._fields:
            bitwise(getattr(a, field), getattr(b, field),
                    f"fleet staged vs fused tick {i} {field}")
    if st["metrics"] != fu["metrics"]:
        _fail(f"fleet staged vs fused metrics: {st['metrics']} != "
              f"{fu['metrics']}")
    _fleet_state_bitwise(bitwise, st["state"], fu["state"],
                         "fleet staged vs fused")
    for i, (shed, over) in enumerate(fu["deltas"]):
        binds = shed > 0 and over > 0
        if binds != fleet_hot(i) or (not binds and (shed or over)):
            _fail(f"fleet tick {i} ({'hot' if fleet_hot(i) else 'cold'})"
                  f": {shed} shed by the fog budgets, {over} over the core "
                  f"budget; both must bind on hot ticks, neither on cold")
    m = fu["metrics"]["fleet"]
    if m["items_offered"] != m["items_accepted"] + m["items_rejected"] \
            + m["items_deduped"]:
        _fail(f"fleet conservation broken: {m}")

    single = fleet_vs_executor(sz, fz, device, bitwise)
    oracle = fleet_vs_lone(sz, fz, device, bitwise)
    err = fleet_card_vs_cpu(small, fz_small, device, bitwise, close,
                            Tolerance(*FLEET_CORE))
    return dict(results=results, single=single, oracle=oracle,
                card_vs_cpu_err=err)


def fleet_vs_executor(sz: Sizes, fz: FleetSizes, device, bitwise) -> int:
    """Check 2: one shard, one core rank at the stream executor's core
    capacity, on ``fz.checks``'s ticks of shard 0's feed."""
    fx, fs = make_fleet(sz, fz, device, regions=1, edges=1, num_core=1,
                        core_budget=sz.batch // sz.stride // 4,
                        fog_budget=None)
    ex, es = make_executor(sz, device, fused=True)
    for i in fz.checks:
        items, ts = fleet_batch(sz, fz, i, device, shards=1)
        fs, fo = fx.step(fs, items, ts)
        es, eo = ex.step(es, items[0], ts[0])
        for field in eo._fields:
            bitwise(getattr(fo, field)[0], getattr(eo, field),
                    f"1-shard fleet vs executor tick {i} {field}")
    fm, em = fs.metrics.as_dict()["shard"], es.metrics.as_dict()
    fm = {k: v[0] for k, v in fm.items()}
    if fm != em:
        _fail(f"1-shard fleet vs executor metrics: {fm} != {em}")
    if not em["core_overflow"]:
        _fail(f"1-shard check: the core budget never bound: {em}")
    return len(fz.checks)


def fleet_vs_lone(sz: Sizes, fz: FleetSizes, device, bitwise) -> int:
    """Check 3: the fleet with non-binding budgets against one stream
    executor a shard, on ``fz.checks``'s ticks."""
    s = fz.shards
    nw = sz.batch // sz.stride
    fx, fs = make_fleet(sz, fz, device, core_budget=s * nw,
                        fog_budget=None)
    lone = [make_executor(sz, device, fused=True) for _ in range(s)]
    states = [st for _, st in lone]
    for i in fz.checks:
        items, ts = fleet_batch(sz, fz, i, device)
        fs, fo = fx.step(fs, items, ts)
        for k, (ex, _) in enumerate(lone):
            states[k], eo = ex.step(states[k], items[k], ts[k])
            for field in ("aggregates", "features", "window_count",
                          "consequence", "escalated"):
                bitwise(getattr(fo, field)[k], getattr(eo, field),
                        f"fleet vs lone shard {k} tick {i} {field}")
    md = fs.metrics.as_dict()
    escalated = md["fleet"]["windows_escalated"]
    if md["fleet_core_overflow"] or not escalated \
            or sum(md["fog_shed"]) or sum(md["core_processed"]) != escalated:
        _fail(f"fleet oracle: budgets bound or nothing escalated: {md}")
    return escalated


def fleet_card_vs_cpu(sz: Sizes, fz: FleetSizes, device, bitwise, close,
                      tol) -> float:
    """Check 4: the same degraded run on the card and on the CPU (the
    card's inputs, copied): shard 5 unhealthy and behind from tick 1,
    shard 6 inactive from tick 2, shard 3's uplink stalled and half of
    shard 4's at tick 3, shard 2's batch a replay at tick 4.  Returns
    the largest core-output difference."""
    from repro_torch.stream import MODE_REPLAY
    from repro_torch.stream.executor import StepOutput
    s = fz.shards
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        runs[name] = list(make_fleet(sz, fz, dev))
    outs = {"card": [], "cpu": []}
    for i in range(sz.ticks):
        items, ts = fleet_batch(sz, fz, i, device)
        ts = ts.clone()
        ts[5] -= 100.0 if i >= 1 else 0.0
        kw = {}
        if i == 1:
            health = np.ones(s, bool)
            health[5] = False
            for fx, _ in runs.values():
                fx.set_health(health)
        if i == 2:
            active = np.ones(s, bool)
            active[6] = False
            for fx, _ in runs.values():
                fx.set_active(active)
        if i == 3:
            offered = np.ones((s, sz.batch), bool)
            offered[3] = False
            offered[4, ::2] = False
            kw["offered"] = offered
        if i == 4:
            mode = np.zeros(s, np.int32)
            mode[2] = MODE_REPLAY
            kw["mode"] = mode
            ts[2] -= 3.0 * sz.batch
        for name, run in runs.items():
            fx, state = run
            dev = fx.device
            state, out = fx.step(state, items.to(dev), ts.to(dev), **kw)
            run[1] = state
            outs[name].append(out)
    err = 0.0
    for i, (a, b) in enumerate(zip(outs["card"], outs["cpu"])):
        for field in StepOutput._fields:
            if field == "outputs":
                err = max(err, float((a.outputs.cpu() - b.outputs)
                                     .abs().max()))
                close(a.outputs, b.outputs, tol,
                      f"fleet card vs CPU tick {i} outputs")
            else:
                bitwise(getattr(a, field), getattr(b, field),
                        f"fleet card vs CPU tick {i} {field}")
    card, cpu = runs["card"][1], runs["cpu"][1]
    _fleet_state_bitwise(bitwise, card, cpu, "fleet card vs CPU")
    mc, mp = card.metrics.as_dict(), cpu.metrics.as_dict()
    if mc != mp:
        _fail(f"fleet card vs CPU metrics: {mc} != {mp}")
    for key, why in (("late_excluded", "an excluded shard's catch-up"),
                     ("fog_shed", "the fog budget")):
        if not sum(mc[key]):
            _fail(f"fleet card vs CPU: {why} never showed ({key} 0)")
    if not mc["shard"]["items_replayed"][2]:
        _fail(f"fleet card vs CPU: the replay tick replayed nothing: {mc}")
    return err


def profile_fleet(sz: Sizes, fz: FleetSizes, device, ticks=4) -> None:
    """Where a fused fleet tick's time goes, over ``ticks`` ticks."""
    fx, state = make_fleet(sz, fz, device, fused=True)
    state, *_ = drive_fleet(fx, state, sz, fz, device, sz.warmup)
    feed = [fleet_batch(sz, fz, FLEET_HOT_EVERY + i, device)
            for i in range(ticks)]
    box = [state]

    def tick(i):
        box[0], _ = fx.step(box[0], *feed[i])
    _profile("fleet_fused", ticks, "tick", tick, kernel="fused_tick_kernel")
    del fx, state, box


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def print_fleet(sz: Sizes, fz: FleetSizes, fl: dict) -> None:
    """The fleet's timing lines, one a path."""
    s = fz.shards
    for name in ("staged", "fused"):
        r = fl["results"][name]
        per = {k: v / len(r["secs"])
               for k, v in _nonzero(r["launches"]).items()}
        # the first tick built and captured the step: left out
        secs = np.asarray(r["secs"][1:])
        q = np.quantile(secs, [0.5, 0.99])
        print(f"path fleet {name}: {s} shards ({fz.regions} regions of "
              f"{fz.edges}) x {sz.batch} rows, "
              f"{s * sz.batch * len(secs) / secs.sum():.0f} items/s (all "
              f"shards' rows over the graphed ticks), tick p50 "
              f"{q[0] * 1e3:.3f} ms, p99 {q[1] * 1e3:.3f} ms over "
              f"{len(secs)} ticks (the first, which captured, "
              f"{r['secs'][0] * 1e3:.3f} ms, left out), launches a "
              f"tick {per}; fog shed / core overflow a tick "
              f"{r['deltas'][:, 0].tolist()} / {r['deltas'][:, 1].tolist()}")


# ---- phase 8: the controlled fleet ------------------------------------------

#: the traffic of check 1 (and, at ``SMALL``, of check 3): shard 2 stalls
#: for ticks 4..9; shard 5 leaves at tick 6 and a joiner takes its slot
#: at tick 12, its stream replayed on the backup ``leave`` picks in the
#: meantime, with its sliding window carry handed over and back;
#: ``CONTROL_TICKS`` fresh ticks, then drain ticks until the injector
#: holds nothing, then ``CONTROL_QUIET`` more
CONTROL_FAULT = (2, 4, 10)
CONTROL_CHURN = (5, 6, 12)
CONTROL_TICKS = 24
CONTROL_QUIET = 3
#: check 3's drop rule (a window whose signal mean is below -0.25 is
#: dropped: about 2% of a cold tick's windows) and the ticks whose
#: signal is shifted down by 1, where it drops nearly every window: the
#: drop SLO breaches there and recovers after
DROP_RULE = ("calm", 0, "<", -0.25, 3)
CALM_TICKS = range(14, 18)


def _decision(dec) -> dict:
    """A ``ControlDecision`` as plain Python, every field."""
    def plain(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        return v
    return {k: plain(v) for k, v in dec._asdict().items()}


def _events(log) -> list:
    """The event log's records less their ``wall_time`` stamps."""
    return [{k: v for k, v in r.items() if k != "wall_time"}
            for r in log.records]


def control_feed(sz: Sizes, fz: FleetSizes, device, calm=()):
    """Tick ``i`` of the fleet feed (:func:`fleet_batch`, made on the
    device) as host numpy, the injector's input; on ``calm`` ticks the
    signal column is shifted down by 1."""
    def feed(i):
        items, ts = fleet_batch(sz, fz, i, device)
        if i in calm:
            items[:, :, 0] -= 1.0
        return items.cpu().numpy(), ts.cpu().numpy()
    return feed


def run_controlled(fx, state, ctl, inj, feed, churn, on_tick):
    """Drive ``fx`` under ``ctl`` through ``inj``'s schedule:
    :data:`CONTROL_TICKS` fresh ticks of ``feed``, then drain ticks
    (``fresh=False``) until the injector holds nothing, then
    :data:`CONTROL_QUIET` quiet ticks.  ``churn`` (shard, leave, join)
    is acted with the sliding carry handoff.  Each tick calls
    ``on_tick(t, out, decision, origin, offered, replay, health)``,
    ``health`` the mask the tick ran under.  Returns the final state and
    the churned shard's backup."""
    s = fx.cfg.num_shards
    shard, leave, join = churn
    backups, backup, t, quiet, base = {}, None, 0, 0, None
    while True:
        if t >= CONTROL_TICKS and not inj.pending:
            if quiet == CONTROL_QUIET:
                return state, backup
            quiet += 1
        if t == leave:
            backup = ctl.leave(shard)
            if backup is None:
                _fail(f"controlled fleet: no backup for shard {shard}")
            backups = {shard: backup}
            state = ctl.begin_replay_carry(state, shard, backup)
        if t == join:
            state = ctl.end_replay_carry(state, shard, backup)
            ctl.join(shard)
        fresh = t < CONTROL_TICKS
        base = feed(t) if fresh else tuple(np.zeros_like(a) for a in base)
        items, ts, offered, replay = inj.inject(t, *base, fresh=fresh,
                                                backups=backups)
        health = fx.health
        state, out = fx.step(state, items, ts, offered=offered,
                             replay=replay)
        dec = ctl.tick(state, step_times=inj.schedule.stall_time(t, s))
        on_tick(t, out, dec, inj.origin.copy(), offered, replay, health)
        t += 1


def _controlled(sz: Sizes, fz: FleetSizes, device, **fleet_kw):
    """A fleet under a controller with an event log, and an injector of
    the stall and churn traffic logging to it."""
    from repro_torch.obs import EventLog
    from repro_torch.stream.fleet import (Churn, Fault, FaultInjector,
                                          FaultSchedule, FleetController)
    fx, state = make_fleet(sz, fz, device, **fleet_kw.pop("fleet", {}))
    log = EventLog()
    ctl = FleetController(fx, event_log=log, **fleet_kw)
    inj = FaultInjector(FaultSchedule([Fault(*CONTROL_FAULT)],
                                      churn=[Churn(*CONTROL_CHURN)]),
                        event_log=log)
    return fx, state, ctl, inj, log


def _emitted(out) -> tuple:
    """A tick's window counts, aggregates, consequences and core outputs
    on the host."""
    return tuple(getattr(out, f).cpu().numpy() for f in
                 ("window_count", "aggregates", "consequence", "outputs"))


def control_vs_oracle(sz: Sizes, fz: FleetSizes, device, bitwise,
                      close) -> dict:
    """Check 1: the stall and churn traffic at ``sz`` a shard under a
    controller with the budgets pinned ample (the core budget every
    window of the fleet, no fog budget), against a healthy fleet without
    a controller on the same feed.

    Each stream's emitted windows (collected by the injector's origin of
    each slot) equal the oracle's -- aggregates, window counts and
    consequences bitwise, core outputs within ``FLEET_CORE`` -- except one
    window, which it states exactly: the stream of the stalled shard
    resumes after empty ticks, so the first window of its first batch
    after the stall frames ``stride`` rows (its carry is empty) where the
    oracle's frames ``window`` (the reference holds a stall only on
    tumbling windows for this reason).  The churned stream and its
    backup's are bitwise throughout (the carry handoff).  Also: the fleet
    watermark never moves back, no row is late anywhere, the stalled
    shard's catch-up rows count in ``late_excluded``, it is flagged and
    then re-admitted, and the replayed rows are the rows offered with
    the replay flag."""
    from repro_torch.runtime import ElasticBudget
    from repro_torch.obs import EventLog
    from repro_torch.testing import Tolerance
    s, nw = fz.shards, sz.batch // sz.stride
    ample = s * nw
    pinned = dict(core_budget=ample, fog_budget=None)
    feed = control_feed(sz, fz, device)

    def keep(store, e, rows):
        emit = rows[0][e] > 0
        for k, v in enumerate(rows):
            store[e][k].append(v[e][emit])

    oracle = [[[], [], [], []] for _ in range(s)]
    fx, state = make_fleet(sz, fz, device, **pinned)
    for i in range(CONTROL_TICKS):
        items, ts = feed(i)
        state, out = fx.step(state, items, ts)
        rows = _emitted(out)
        for e in range(s):
            keep(oracle, e, rows)
    del fx, state

    fx, state, ctl, inj, log = _controlled(
        sz, fz, device, fleet=pinned,
        budget_policy=ElasticBudget(min_budget=ample, max_budget=ample))
    got = [[[], [], [], []] for _ in range(s)]
    wms, rep_rows, ticks = [], 0, []

    def on_tick(t, out, dec, origin, offered, replay, health):
        nonlocal rep_rows
        rows = _emitted(out)
        for e in range(s):
            if origin[e] >= 0:
                emit = rows[0][e] > 0
                for k, v in enumerate(rows):
                    got[int(origin[e])][k].append(v[e][emit])
        wms.append(dec.watermark)
        rep_rows += int(offered[replay].sum())
        ticks.append(t)
    zero_launches()
    state, backup = run_controlled(fx, state, ctl, inj, feed, CONTROL_CHURN,
                                   on_tick)
    launches = read_launches()
    md = state.metrics.as_dict()
    EventLog.validate(log.records)

    stalled, start, _ = CONTROL_FAULT
    split = start * nw                   # its first window after the stall
    tol = Tolerance(*FLEET_CORE)
    for e in range(s):
        a = [np.concatenate(x) for x in got[e]]
        b = [np.concatenate(x) for x in oracle[e]]
        if a[0].shape != b[0].shape:
            _fail(f"controlled stream {e}: {a[0].shape[0]} windows "
                  f"emitted, the oracle {b[0].shape[0]}")
        same = np.ones(a[0].shape[0], bool)
        if e == stalled:
            same[split] = False
            if (a[0][split], b[0][split]) != (sz.stride, sz.window):
                _fail(f"stalled stream: window {split} frames "
                      f"{a[0][split]} rows, the oracle {b[0][split]}; want "
                      f"{sz.stride} and {sz.window}")
        for k, what in enumerate(("window counts", "aggregates",
                                  "consequences")):
            bitwise(a[k][same], b[k][same],
                    f"controlled vs oracle stream {e} {what}")
        close(a[3][same], b[3][same], tol,
              f"controlled vs oracle stream {e} core outputs")
    if any(b < a for a, b in zip(wms, wms[1:])):
        _fail(f"controlled fleet: the watermark moved back: {wms}")
    if md["shard"]["items_late"] != [0] * s:
        _fail(f"controlled fleet dropped late rows: {md['shard']}")
    if not md["late_excluded"][stalled]:
        _fail(f"stalled shard's catch-up never counted: {md}")
    flagged = [r for r in log.of_kind("health_change")
               if not r["healthy"][stalled]]
    back = [r for r in log.of_kind("health_change")
            if r["healthy"][stalled] and flagged
            and r["seq"] > flagged[0]["seq"]]
    if not flagged or not back or not fx.health[stalled]:
        _fail(f"shard {stalled} was not flagged and re-admitted: "
              f"{log.of_kind('health_change')}")
    replayed = md["shard"]["items_replayed"]
    if not rep_rows or replayed[backup] != rep_rows \
            or sum(replayed) != rep_rows:
        _fail(f"replayed {replayed}, want {rep_rows} on shard {backup}")
    want = s * len(ticks)
    if launches["fused_tick"] != want or launches["window_reduce"]:
        _fail(f"controlled fleet launched fused_tick "
              f"{launches['fused_tick']} times over {len(ticks)} ticks of "
              f"{s} shards (want {want}), window_reduce "
              f"{launches['window_reduce']}")
    return dict(ticks=len(ticks), backup=backup, launches=launches,
                replayed=rep_rows, late_excluded=md["late_excluded"],
                events=len(log), watermark=wms[-1])


def control_elastic(sz: Sizes, fz: FleetSizes, device) -> dict:
    """Check 2, and the timing of check 5: ``fz.ticks`` ticks of the
    hot/cold feed under the default policies (the core budget's and each
    region's fog budget's), each tick's step and control tick timed.
    The core budget must grow and shrink, a fog budget must move, and
    ``resizes`` must count one a tick for the core budget and one a tick
    for the fog budgets (however many regions moved), as the log shows."""
    from repro_torch.obs import EventLog
    from repro_torch.stream.fleet import FleetController
    fx, state = make_fleet(sz, fz, device)
    log = EventLog()
    ctl = FleetController(fx, event_log=log)
    s = fz.shards
    step_s, ctl_s, budgets, built = [], [], [], 0
    zero_launches()
    for i in range(fz.ticks):
        items, ts = fleet_batch(sz, fz, i, device)
        before = fx._compile_count()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = fx.step(state, items, ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = ctl.tick(state, step_times=np.full(s, 0.1))
        if fx._compile_count() == before:   # a tick that captured is
            step_s.append(t1 - t0)          # left out of the timing
        else:
            built += 1
        ctl_s.append(time.perf_counter() - t1)
        budgets.append((dec.budget, dec.region_budgets.tolist()))
    launches = read_launches()
    core = log.of_kind("budget_resize")
    fog = log.of_kind("fog_budget_resize")
    up = [r for r in core if r["budget_to"] > r["budget_from"]]
    down = [r for r in core if r["budget_to"] < r["budget_from"]]
    if not up or not down or not fog:
        _fail(f"elastic budgets: {len(up)} core grows, {len(down)} core "
              f"shrinks, {len(fog)} fog resizes over {budgets}")
    if not 1 <= fx.trace_count <= ctl.max_trace_count \
            or fx.trace_count != built:
        _fail(f"elastic fleet: trace_count {fx.trace_count}, "
              f"{built} ticks captured, max_trace_count "
              f"{ctl.max_trace_count}")
    if ctl.resizes != len(core) + len({r["tick"] for r in fog}):
        _fail(f"resizes {ctl.resizes}, the log holds {len(core)} core and "
              f"{len(fog)} fog resizes on {len({r['tick'] for r in fog})} "
              "ticks")
    want = s * fz.ticks
    if launches["fused_tick"] != want or launches["window_reduce"]:
        _fail(f"elastic fleet launched fused_tick {launches['fused_tick']} "
              f"times over {fz.ticks} ticks of {s} shards, want {want}")
    return dict(step_s=step_s, ctl_s=ctl_s, budgets=budgets,
                resizes=ctl.resizes, retraces=ctl._retraces,
                max_trace_count=ctl.max_trace_count, core=len(core),
                trace_count=fx.trace_count,
                fog=len(fog), launches=launches, state=state, fx=fx)


def control_card_vs_cpu(sz: Sizes, fz: FleetSizes, device, bitwise,
                        close) -> dict:
    """Check 3: the whole controlled arc at ``sz`` a shard on the card
    and on the CPU, from the same host feed: the stall, the churn with
    the carry handoff, the default elastic core and fog policies, and a
    drop SLO over :data:`DROP_RULE` that breaches on the calm ticks and
    recovers.  Each tick's ``ControlDecision`` and the event log (less
    wall times) must be equal, every tick's outputs bitwise (core outputs
    within ``FLEET_CORE``), and the final state bitwise."""
    from repro_torch.obs import SLO
    from repro_torch.testing import Tolerance
    from repro_torch.stream.executor import StepOutput
    feed = control_feed(sz, fz, device, calm=CALM_TICKS)
    slo = SLO("drops", stage="drops", objective=0.9, fast_window=2,
              slow_window=4, burn_threshold=2.0)
    runs = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        fx, state, ctl, inj, log = _controlled(
            sz, fz, dev, fleet=dict(drop_rule=True), slos=(slo,))
        decisions, outs = [], []

        def on_tick(t, out, dec, *_):
            decisions.append(_decision(dec))
            outs.append(StepOutput(*(v.cpu() for v in out)))
        state, _ = run_controlled(fx, state, ctl, inj, feed, CONTROL_CHURN,
                                  on_tick)
        runs[name] = dict(decisions=decisions, outs=outs, state=state,
                          events=_events(log), resizes=ctl.resizes,
                          metrics=state.metrics.as_dict())
    card, cpu = runs["card"], runs["cpu"]
    if len(card["decisions"]) != len(cpu["decisions"]):
        _fail(f"controlled card vs CPU: {len(card['decisions'])} ticks vs "
              f"{len(cpu['decisions'])}")
    for i, (a, b) in enumerate(zip(card["decisions"], cpu["decisions"])):
        if a != b:
            _fail(f"controlled card vs CPU tick {i} decision: {a} != {b}")
    if card["events"] != cpu["events"]:
        diff = next(i for i, (a, b) in enumerate(
            zip(card["events"], cpu["events"])) if a != b) \
            if len(card["events"]) == len(cpu["events"]) else "count"
        _fail(f"controlled card vs CPU event log differs at {diff}")
    err = 0.0
    for i, (a, b) in enumerate(zip(card["outs"], cpu["outs"])):
        for field in StepOutput._fields:
            if field == "outputs":
                err = max(err, float((a.outputs - b.outputs).abs().max()))
                close(a.outputs, b.outputs, Tolerance(*FLEET_CORE),
                      f"controlled card vs CPU tick {i} outputs")
            else:
                bitwise(getattr(a, field), getattr(b, field),
                        f"controlled card vs CPU tick {i} {field}")
    _fleet_state_bitwise(bitwise, card["state"], cpu["state"],
                         "controlled card vs CPU")
    if card["metrics"] != cpu["metrics"]:
        _fail(f"controlled card vs CPU metrics: {card['metrics']} != "
              f"{cpu['metrics']}")
    kinds = {e["kind"] for e in card["events"]}
    for kind in ("slo_breach", "slo_recover", "budget_resize",
                 "fog_budget_resize", "health_change", "replay_delivery",
                 "backlog_drain"):
        if kind not in kinds:
            _fail(f"controlled card vs CPU: no {kind} event in the arc")
    return dict(ticks=len(card["decisions"]), events=len(card["events"]),
                resizes=card["resizes"], err=err)


def control_cost(sz: Sizes, fz: FleetSizes, fx, state, step_p50: float
                 ) -> dict:
    """Check 4: ``step_cost`` of one fused fleet tick at ``sz`` a shard on
    the controlled fleet's own state (nothing is consumed), with the
    roofline at the card's peaks against the measured step p50.  The
    fused_tick calls must have reported their bytes, one call a shard."""
    from repro_torch.obs import roofline, stage_table
    items, ts = fleet_batch(sz, fz, fz.ticks, fx.device)
    c = fx.step_cost(state, items, ts)
    ft = c["kernels"].get("fused_tick", {})
    if ft.get("calls") != fz.shards or not ft.get("bytes"):
        _fail(f"step_cost: fused_tick reported {ft}, want {fz.shards} "
              "calls with their bytes")
    rl = roofline(c["flops"], c["bytes_accessed"], step_p50,
                  peak_flops=PEAK_F32_OPS_S, peak_bw=PEAK_BYTES_S)
    return dict(cost=c, roofline=rl, table=stage_table(c))


def run_control_phase(sz: Sizes, fz: FleetSizes, device, rows: list) -> None:
    """Phase 8: the controlled fleet's checks, each failing the run, its
    cost and timing lines; the controlled run's fused_tick launches join
    the kernels line's fused_tick entry (``control_launches``)."""
    from repro_torch.testing import assert_bitwise, assert_close
    t0 = time.perf_counter()
    card = _card_line()
    arc = control_vs_oracle(sz, fz, device, assert_bitwise, assert_close)
    s = fz.shards
    print(f"phase 8 controlled fleet: {s} shards in {fz.regions} regions of "
          f"{fz.edges}, {sz.batch} rows a shard a tick, fused; shard "
          f"{CONTROL_FAULT[0]} stalled for ticks {CONTROL_FAULT[1]}.."
          f"{CONTROL_FAULT[2] - 1}, shard {CONTROL_CHURN[0]} away for ticks "
          f"{CONTROL_CHURN[1]}..{CONTROL_CHURN[2] - 1} (backup "
          f"{arc['backup']}, carry handed over and back), {arc['ticks']} "
          f"ticks: every stream == the healthy oracle (the stalled stream's "
          f"one resumed window apart), watermark monotone to "
          f"{arc['watermark']}, no late row, late_excluded "
          f"{arc['late_excluded']}, {arc['replayed']} rows replayed, "
          f"{arc['events']} events; fused_tick "
          f"{arc['launches']['fused_tick'] / arc['ticks']:g} a tick; {card}")
    el = control_elastic(sz, fz, device)
    print(f"phase 8 elastic budgets: {fz.ticks} ticks of the hot/cold feed, "
          f"{el['core']} core and {el['fog']} fog budget resizes, resizes "
          f"{el['resizes']}, retraces {el['retraces']}, the executor's "
          f"trace_count {el['trace_count']} <= max_trace_count "
          f"{el['max_trace_count']} (the ticks that captured are left out "
          f"of the step timing); budgets a tick {el['budgets']}; {card}")
    cc = control_card_vs_cpu(SMALL, FLEET_SMALL, device, assert_bitwise,
                             assert_close)
    print(f"phase 8 card vs CPU: the controlled arc at {SMALL.batch} rows a "
          f"shard, {cc['ticks']} ticks: every ControlDecision and the "
          f"{cc['events']} events equal, outputs and the final state "
          f"bitwise, core outputs within {cc['err']:.3e}; {card}")
    step = np.asarray(el["step_s"])
    ctl_ms = np.quantile(np.asarray(el["ctl_s"]), [0.5, 0.99]) * 1e3
    q = np.quantile(step, [0.5, 0.99])
    cost = control_cost(sz, fz, el["fx"], el["state"], float(q[0]))
    c, rl = cost["cost"], cost["roofline"]
    ft = c["kernels"]["fused_tick"]
    print(f"phase 8 step_cost of one fused fleet tick: {c['flops']:.6g} "
          f"FLOPs, {c['bytes_accessed']:.6g} bytes, "
          f"{c['transcendentals']:.6g} transcendentals; fused_tick reported "
          f"{ft['calls']} calls, {ft['bytes']} bytes, {ft['ops']} ops; "
          f"stages (stage, ops, bytes) {cost['table']}")
    print(f"phase 8 roofline at the step p50 {q[0] * 1e3:.3f} ms: "
          f"{rl['gbs']:.3f} GB/s = {rl['bw_util']:.5f} of 3.35 TB/s, "
          f"{rl['gflops']:.3f} GFLOP/s = {rl['flops_util']:.6f} of 67 "
          f"TFLOP/s f32, intensity {rl['ai']:.4f} FLOP/byte; bytes alone "
          f"would take {c['bytes_accessed'] / PEAK_BYTES_S * 1e3:.4f} ms; "
          f"{card}")
    per_tick = el["launches"]["fused_tick"] / fz.ticks
    print(f"phase 8 timing: FleetController.tick p50 {ctl_ms[0]:.3f} ms, p99 "
          f"{ctl_ms[1]:.3f} ms beside the controlled fleet step p50 "
          f"{q[0] * 1e3:.3f} ms, p99 {q[1] * 1e3:.3f} ms, "
          f"{s * sz.batch * len(step) / step.sum():.0f} items/s over "
          f"{len(step)} ticks; fused_tick {per_tick:g} a tick; "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    if per_tick != s:
        _fail(f"controlled fleet: {per_tick} fused_tick launches a tick, "
              f"want {s}")
    del el
    for row in rows:
        if row["name"] == "fused_tick":
            n = arc["launches"]["fused_tick"]
            row["control_launches"] = n
            row["control_launches_a_tick"] = n / arc["ticks"]


# ---- phase 9: training Yi-6B at full width ---------------------------------

class TrainSizes(NamedTuple):
    steps: int          # train steps of ``train.run``
    batch: int          # sequences a step
    seq: int            # tokens a sequence
    microbatches: int = 1
    layers: int | None = None   # None: the configuration's depth
    compute: str = "bfloat16"   # compute_dtype (params stay float32)
    lr: float = 3e-4            # AdamW's, under train.py's cosine schedule
    arch: str = "yi_6b"
    smoke: bool = False         # its smoke config, not the full one
    witness: tuple = ()         # lower peak lrs of the learning witness


#: Yi-6B at full width (``src/repro/configs/yi_6b.py``, the default
#: ``--arch`` of ``launch/train.py``), its depth cut from 32 to 16
#: layers: AdamW in float32 holds 16 bytes a parameter (parameters,
#: gradients, two moments), 97.0 GB at 32 layers, 52.7 GB at 16.  Seq
#: 4,096 is ``train_4k``'s; a batch of 2 in 2 microbatches; 8 steps of
#: ``train.py``'s cosine schedule (warmup 10, total 80) at lr 3e-4.
#: The learning witness then trains the same weights on the same 8
#: fresh batches at lower peak lrs under the same schedule.
TRAIN_FULL = TrainSizes(steps=8, batch=2, seq=4096, microbatches=2,
                        layers=16, witness=(1e-4, 3e-5, 1e-5, 3e-6))
#: Yi-6B's smoke config in float32 for the card-against-CPU,
#: microbatch and resume checks: ``tests/test_system.py``'s batch and
#: sequence
TRAIN_SMALL = TrainSizes(steps=3, batch=8, seq=32, compute="float32",
                         lr=2e-3, smoke=True)
#: card against CPU, float32, 3 steps from the same weights: each loss
#: relative; the parameters within this of each leaf's largest
#: magnitude (the stated tolerance of ``tests/test_torch_checkpoint.py``)
TRAIN_CARD_VS_CPU = 1e-5
#: 1 microbatch against 2 on the card: the loss relative and each
#: gradient leaf of its largest magnitude (the reference's
#: ``test_microbatched_grads_match_full`` tolerances)
MICRO_LOSS, MICRO_GRAD = 1e-6, 1e-5
#: a checkpoint at step 2, a restore and 2 more steps against 4
#: uninterrupted ones: each parameter leaf of its largest magnitude
RESUME_PARAM = 1e-6


def train_config(tz: TrainSizes):
    """``tz.arch`` (its full or smoke config) cut to ``tz``'s depth and
    compute dtype."""
    import dataclasses
    from repro_torch import configs
    cfg = (configs.smoke_config if tz.smoke else configs.get_config)(tz.arch)
    return dataclasses.replace(
        cfg, n_layers=tz.layers or cfg.n_layers,
        compute_dtype=getattr(torch, tz.compute))


def train_flops(cfg, n: int, batch: int, seq: int) -> dict:
    """The model FLOPs of one train step of ``batch`` x ``seq`` tokens,
    ``n`` the model's non-embedding parameters: 6 x ``n`` x tokens,
    attention (its two products over the causal, chunk-truncated keys
    ``causal_attention`` reads, forward and backward: 3x the forward),
    and the unembedding (6 x d_model x vocab x tokens); remat's extra
    forward passes apart: each layer's (2 x its parameters x tokens plus
    its attention) and each query chunk's again inside it."""
    tokens = batch * seq
    hd = cfg.n_heads * cfg.d_head
    cq = min(cfg.chunk_q, seq)
    while seq % cq:
        cq -= 1
    pairs = 0                   # (query, key) pairs the chunks compute
    for i in range(seq // cq):
        hi = (i + 1) * cq
        pairs += cq * (hi - (0 if cfg.window is None
                             else max(0, hi - cfg.window - cq)))
    n_attn = sum(k.startswith("attn") for k in cfg.layer_kinds())
    attn_fwd = 4 * hd * pairs * batch * n_attn
    out = {"params": 6 * n * tokens, "attention": 3 * attn_fwd,
           "unembed": 6 * cfg.d_model * cfg.vocab * tokens,
           "non_embedding_params": n,
           "remat": 2 * n * tokens + 2 * attn_fwd}
    out["model"] = out["params"] + out["attention"] + out["unembed"]
    return out


def _leaf_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference of two tensors over ``b``'s largest
    magnitude."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _params_err(a, b) -> float:
    """The largest :func:`_leaf_err` over two models' parameters."""
    return max(_leaf_err(x, y) for x, y in zip(a.parameters(),
                                               b.parameters()))


def _train_batch(cfg, tz: TrainSizes, step: int, device) -> dict:
    from repro_torch.data import SyntheticTokens
    b = SyntheticTokens(cfg.vocab, tz.seq, tz.batch).batch_at(step)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _falls(losses) -> bool:
    """Whether fresh-batch losses fall: the mean of the last half under
    the mean of the first half."""
    h = len(losses) // 2
    return float(np.mean(losses[-h:])) < float(np.mean(losses[:h]))


def run_train(tz: TrainSizes, device) -> dict:
    """The training run of phase 9 through the port's entry point
    (``train.run``), the launch counts zeroed just before: fails unless
    every loss is finite, the optimizer took ``tz.steps`` steps and no
    hand kernel launched.  Then two more steps on the run's last batch
    must lower its loss (``tests/test_archs_smoke.py``'s check), also
    launching no hand kernel."""
    from repro_torch import optim
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as T
    from repro_torch.optim import cosine_with_warmup
    cfg = train_config(tz)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=0, device=device, trainable=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    zero_launches()
    res = train.run(cfg, tz.steps, tz.batch, tz.seq,
                    microbatches=tz.microbatches, lr=tz.lr, device=device,
                    model=model)
    launches = read_launches()
    if not np.isfinite(res.losses).all():
        _fail(f"train: non-finite losses {res.losses}")
    if int(res.opt_state.step) != tz.steps:
        _fail(f"train: the optimizer step reads {int(res.opt_state.step)}, "
              f"want {tz.steps}")
    step = steps.build_train_step(
        cfg, optim.AdamWConfig(lr=tz.lr), num_microbatches=tz.microbatches,
        schedule=lambda s: cosine_with_warmup(s, warmup=10,
                                              total=tz.steps * 10))
    batch = _train_batch(cfg, tz, tz.steps - 1, device)
    repeat, state = [], res.opt_state
    for _ in range(2):
        model, state, m = step(model, state, batch)
        repeat.append(float(m["loss"]))
    every = read_launches()
    if any(every.values()) or any(read_simple().values()) or \
            _wrappers()["decode_attn"].generic_launches:
        _fail(f"train: hand kernels launched in the training steps: "
              f"{every}, simple {read_simple()}")
    if not repeat[1] < repeat[0]:
        _fail(f"train: a second step on a repeated batch did not lower "
              f"its loss: {repeat}")
    n = sum(p.numel() for name, p in model.named_parameters()
            if name not in ("embed", "unembed"))
    return dict(cfg=cfg, res=res, launches=launches, repeat=repeat,
                init_s=init_s, peak=torch.cuda.max_memory_allocated(),
                flops=train_flops(cfg, n, tz.batch, tz.seq),
                step=int(state.step), fn=step, state=[model, state, batch])


def train_witness(tz: TrainSizes, device) -> list:
    """The learning witness: for each lr of ``tz.witness``, in turn, the
    run's weights (seed 0) trained by ``train.run`` on the run's fresh
    batches under the same schedule, one model at a time.  Fails unless
    every loss is finite and, at the last lr, the losses fall
    (:func:`_falls`).  Returns ``[(lr, losses), ...]``."""
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    cfg, out = train_config(tz), []
    for lr in tz.witness:
        model = T.init_params(cfg, seed=0, device=device, trainable=True)
        res = train.run(cfg, tz.steps, tz.batch, tz.seq,
                        microbatches=tz.microbatches, lr=lr, device=device,
                        model=model)
        out.append((lr, res.losses))
        del model, res
        _free()
        if not np.isfinite(out[-1][1]).all():
            _fail(f"train witness: non-finite losses at lr {lr}: "
                  f"{out[-1][1]}")
    if out and not _falls(out[-1][1]):
        _fail(f"train witness: the fresh-batch losses at lr {out[-1][0]} "
              f"did not fall: {out[-1][1]}")
    return out


def profile_train(tr: dict) -> None:
    """Where a train step's time goes: ``torch.profiler`` over one more
    step of the run's step function on its last batch."""
    model, state, batch = tr["state"]
    box = [state]

    def one(i):
        _, box[0], _ = tr["fn"](model, box[0], batch)
    _profile("train", 1, "step", one)


def train_card_vs_cpu(tz: TrainSizes, device) -> dict:
    """``tz.steps`` train steps on the card and on the CPU from the same
    weights (drawn on the card, copied): losses and parameters within
    :data:`TRAIN_CARD_VS_CPU`."""
    import copy
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    cfg = train_config(tz)
    model = T.init_params(cfg, seed=1, device=device, trainable=True)
    cpu_model = copy.deepcopy(model).cpu()
    kw = dict(microbatches=tz.microbatches, lr=tz.lr)
    card = train.run(cfg, tz.steps, tz.batch, tz.seq, device=device,
                     model=model, **kw)
    cpu = train.run(cfg, tz.steps, tz.batch, tz.seq, device="cpu",
                    model=cpu_model, **kw)
    loss = max(abs(a - b) / abs(b) for a, b in zip(card.losses, cpu.losses))
    params = _params_err(card.model, cpu.model)
    if loss > TRAIN_CARD_VS_CPU or params > TRAIN_CARD_VS_CPU:
        _fail(f"train card vs CPU: losses {card.losses} vs {cpu.losses} "
              f"({loss}), parameters {params} of the largest > "
              f"{TRAIN_CARD_VS_CPU}")
    return dict(loss=loss, params=params, steps=tz.steps)


def train_microbatches(tz: TrainSizes, device) -> dict:
    """One batch's loss and gradients on the card in 1 and in 2
    microbatches: within :data:`MICRO_LOSS` and :data:`MICRO_GRAD`."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import microbatched_grads
    cfg = train_config(tz)
    model = T.init_params(cfg, seed=2, device=device, trainable=True)
    batch = _train_batch(cfg, tz, 0, device)

    def loss_fn(m, b):
        return T.loss_fn(cfg, m, b)

    l1, _, g1 = microbatched_grads(loss_fn, model, batch, 1)
    l2, _, g2 = microbatched_grads(loss_fn, model, batch, 2)
    loss = abs(float(l2) - float(l1)) / abs(float(l1))
    grad = max(_leaf_err(g2[n], g) for n, g in g1.items())
    if loss > MICRO_LOSS or grad > MICRO_GRAD:
        _fail(f"train microbatches: 1 vs 2 microbatches: loss {loss} "
              f"(> {MICRO_LOSS}?), grads {grad} (> {MICRO_GRAD}?)")
    return dict(loss=loss, grad=grad)


def train_resume(tz: TrainSizes, device) -> dict:
    """A ``CheckpointManager`` save at step 2 (``train.run`` with
    ``ckpt_every=2``), a restore and 2 more steps against 4
    uninterrupted steps: parameters within :data:`RESUME_PARAM`.  The
    checkpoints go to ``build/`` (git-ignored) and are removed."""
    import shutil
    from repro_torch.launch import train
    cfg = train_config(tz)
    ckpt = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(lr=tz.lr, device=device, microbatches=tz.microbatches)
    try:
        full = train.run(cfg, 4, tz.batch, tz.seq, **kw)
        first = train.run(cfg, 2, tz.batch, tz.seq, ckpt_dir=str(ckpt),
                          ckpt_every=2, **kw)
        rest = train.run(cfg, 4, tz.batch, tz.seq, ckpt_dir=str(ckpt),
                         ckpt_every=2, resume=True, **kw)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if first.checkpoints != [2] or rest.start_step != 2:
        _fail(f"train resume: checkpoints {first.checkpoints}, resumed at "
              f"{rest.start_step}, want [2] and 2")
    params = _params_err(rest.model, full.model)
    if params > RESUME_PARAM:
        _fail(f"train resume: 2 + 2 steps differ from 4 by {params} of the "
              f"largest parameter > {RESUME_PARAM}")
    return dict(params=params,
                losses=(first.losses + rest.losses, full.losses))


def run_train_phase(tz: TrainSizes, small: TrainSizes, device) -> None:
    """Phase 9: the full-width training run and its checks, each failing
    the run, then the smoke config's card against CPU, microbatch and
    resume checks; its lines carry the card's name and power limit."""
    t0 = time.perf_counter()
    card = _card_line()
    tr = run_train(tz, device)
    cfg, res, fl = tr["cfg"], tr["res"], tr["flops"]
    print(f"phase 9 train path: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV heads "
          f"of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, float32 "
          f"params, compute {tz.compute}), {tz.steps} steps of {tz.batch} x "
          f"{tz.seq} tokens in {tz.microbatches} microbatches, lr {tz.lr} "
          f"under cosine(warmup 10, total {tz.steps * 10}); init "
          f"{tr['init_s']:.2f} s; losses {[round(x, 4) for x in res.losses]}"
          f", all finite; grad norms "
          f"{[round(x, 4) for x in res.grad_norms]}; fresh-batch losses "
          f"fall: {'yes' if _falls(res.losses) else 'no'}; optimizer step "
          f"{int(res.opt_state.step)}; a repeated batch's loss "
          f"{tr['repeat'][0]:.4f} -> {tr['repeat'][1]:.4f} (optimizer step "
          f"{tr['step']}); hand-kernel launches {tr['launches']} (none); "
          f"{card}")
    secs = np.asarray(res.secs)
    q = np.quantile(secs, [0.5, 0.99])
    tokens = tz.batch * tz.seq
    print(f"path train: step p50 {q[0] * 1e3:.3f} ms, p99 {q[1] * 1e3:.3f} "
          f"ms over {len(secs)} steps (first {secs[0] * 1e3:.3f} ms), "
          f"{tokens * len(secs) / secs.sum():.1f} tokens/s (all tokens over "
          f"all steps), peak memory {tr['peak'] / 2**30:.2f} GiB "
          f"(max_memory_allocated); {card}")
    print(f"path train FLOPs a step: model {fl['model']:.6g} = 6 x "
          f"{fl['non_embedding_params']} non-embedding params x {tokens} "
          f"tokens {fl['params']:.6g} + attention {fl['attention']:.6g} + "
          f"unembed {fl['unembed']:.6g}; remat's extra forward "
          f"{fl['remat']:.6g} apart; model FLOPs / step p50 "
          f"{fl['model'] / q[0] / 1e12:.3f} TFLOP/s; {card}")
    profile_train(tr)
    del tr, res
    _free()
    wit = train_witness(tz, device)
    print(f"phase 9 train witness: the same weights and {tz.steps} fresh "
          f"batches under the same schedule, by peak lr: "
          + "; ".join(f"lr {lr}: losses {[round(x, 4) for x in ls]}, fall "
                      f"{'yes' if _falls(ls) else 'no'}" for lr, ls in wit)
          + f"; {card}")
    cc = train_card_vs_cpu(small, device)
    mb = train_microbatches(small, device)
    rs = train_resume(small, device)
    print(f"phase 9 train checks at {small.arch}'s smoke config "
          f"({small.compute}, {small.batch} x {small.seq} tokens): card == "
          f"CPU over {cc['steps']} steps, losses within {cc['loss']:.3e} "
          f"relative, parameters within {cc['params']:.3e} of each leaf's "
          f"largest; 1 vs 2 microbatches on the card, loss within "
          f"{mb['loss']:.3e}, gradients within {mb['grad']:.3e}; a "
          f"checkpoint at step 2 restored + 2 steps == 4 steps, parameters "
          f"within {rs['params']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s; {card}")


# ---- phase 10: the compile-once paths, graphed against eager --------------

#: ticks of each stream path, graphed against ``capture.disable()``
GRAPH_TICKS = 64
#: teacher-forced steps of the Yi-6B serve run, graphed against eager
GRAPH_SERVE_STEPS = 256


class _FakeClock:
    """Stands in for an executor module's ``time`` in phase 10: each
    ``perf_counter()`` advances a quarter second, so a graphed and an
    eager run stamp the same wall times into their rings and lineage."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def _same_clock():
    """Fresh fake clocks in both executor modules; returns a function
    that puts the real ``time`` back."""
    from repro_torch.stream import executor as TX
    from repro_torch.stream.fleet import executor as FX
    real = TX.time
    TX.time, FX.time = _FakeClock(), _FakeClock()

    def restore():
        TX.time = FX.time = real
    return restore


def _bits(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 as its int16 bits (the bitwise check compares numpy)."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _tree_bitwise(bitwise, a, b, what: str) -> None:
    from repro_torch.runtime import capture
    la, lb = (capture.flatten(x)[0] for x in (a, b))
    if len(la) != len(lb):
        _fail(f"{what}: {len(la)} leaves against {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor):
            bitwise(_bits(x), _bits(y), f"{what} leaf {i}")


def _quant(secs) -> tuple[float, float]:
    q = np.quantile(np.asarray(secs), [0.5, 0.99]) * 1e3
    return float(q[0]), float(q[1])


def _timed_steps(step, n: int, feed) -> tuple[list, list]:
    """``n`` calls of ``step(feed(i))``, each between two synchronizes:
    (outputs, wall seconds)."""
    outs, secs = [], []
    for i in range(n):
        args = feed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(step(*args))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return outs, secs


def graph_stream(sz: Sizes, device, bitwise) -> dict:
    """Each stream path, ``GRAPH_TICKS`` ticks graphed and the same under
    ``capture.disable()``, then after the capture a tick at a new core
    budget, a backfill tick and 3 live ticks: every ``StepOutput``, the
    final state and the lineage bank bitwise (the latency histogram
    apart: the graphed run withholds its first tick); the graphed
    executor built one signature and captured one graph; both launched
    the path's kernel as often.  Timed, then profiled 8 ticks each."""
    from contextlib import nullcontext
    from repro_torch.runtime import capture
    from repro_torch.stream import ingest as I
    out = {}
    for name, fused in (("staged", False), ("fused", True)):
        runs = {}
        for mode in ("graphed", "eager"):
            restore = _same_clock()
            try:
                ex, state = make_executor(sz, device, fused=fused)
                box = [state]
                sched = [(I.MODE_LIVE, None)] * GRAPH_TICKS + [
                    (I.MODE_LIVE, ex.cfg.windows_per_step // 8),
                    (I.MODE_BACKFILL, None)] + [(I.MODE_LIVE, None)] * 3

                def tick(i):
                    m, budget = sched[i] if i < len(sched) \
                        else (I.MODE_LIVE, None)
                    if budget is not None:
                        ex.set_core_budget(budget)
                    return (*tick_batch(sz, i, device), m)

                def step(items, ts, m):
                    box[0], o = ex.step(box[0], items, ts, mode=m)
                    return o
                zero_launches()
                with capture.disable() if mode == "eager" else nullcontext():
                    outs, secs = _timed_steps(step, len(sched), tick)
                    launches = read_launches()
                    prof = _profile(f"graph_{name}_{mode}", 8, "tick",
                                    lambda i: step(*tick(len(sched) + i)))
                runs[mode] = dict(outs=outs, secs=secs, state=box[0],
                                  lineage=ex._lineage, launches=launches,
                                  trace=ex.trace_count,
                                  compiles=ex._compile_count(),
                                  pool=ex._tick_step.pool_bytes, prof=prof)
                del ex, box
            finally:
                restore()
        g, e = runs["graphed"], runs["eager"]
        for i, (a, b) in enumerate(zip(g["outs"], e["outs"])):
            _tree_bitwise(bitwise, a, b, f"graphed vs eager {name} tick {i}")
        _tree_bitwise(bitwise, g["state"], e["state"],
                      f"graphed vs eager {name} final state")
        bitwise(g["lineage"], e["lineage"], f"graphed vs eager {name} lineage")
        if (g["trace"], g["compiles"]) != (1, 1) or e["trace"] != 0:
            _fail(f"{name} tick: trace_count {g['trace']}, "
                  f"_compile_count {g['compiles']} (want 1, 1); eager "
                  f"{e['trace']}")
        if g["launches"] != e["launches"]:
            _fail(f"{name} tick: graphed launches {g['launches']} != eager "
                  f"{e['launches']}")
        out[name] = runs
    return out


def graph_serve(sz: ServeSizes, device, bitwise) -> dict:
    """Yi-6B at ``sz``'s widths and depth: its decode step resolved and
    captured by the registry as ``serve.run`` does, then the first
    :data:`GRAPH_SERVE_STEPS` teacher-forced steps replayed; the same
    steps eagerly (``capture.disable()``) on fresh caches; the logits
    bitwise at every step, the caches at the end, one cached step, one
    decode_attn launch an attention layer a step either way.  Timed,
    then profiled 8 steps each."""
    from contextlib import nullcontext
    from repro_torch.core import profiles as P
    from repro_torch.core.serverless import FunctionRegistry
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    from repro_torch.runtime import capture
    cfg = serve_config(sz)
    b, max_len = sz.requests, sz.prompt_len + sz.tokens
    steps = GRAPH_SERVE_STEPS
    model = T.init_params(cfg, seed=0, device=device)
    prompts = torch.from_numpy(serve.prompts_for(cfg, b, sz.prompt_len)) \
        .to(device)
    interest = P.ProfileBuilder().add_single("serve").build()
    runs = {}
    for mode in ("graphed", "eager"):
        reg = FunctionRegistry(device)
        reg.store_function(f"decode:{cfg.name}", P.profile("serve", cfg.name),
                           steps_mod.build_serve_step(cfg))
        caches = T.init_caches(cfg, b, max_len, device)
        box = [caches, torch.zeros((b,), dtype=torch.int32, device=device)]
        with capture.disable() if mode == "eager" else nullcontext():
            zero_launches()
            [(_, step)] = reg.start_function(
                interest, model, prompts[:, :1], *box, donate_argnums=(2, 3))
            warm = read_launches()["decode_attn"]

            def one(tok):
                logits, box[0], box[1] = step(model, tok, *box)
                return logits
            logits, secs = _timed_steps(
                one, steps, lambda i: (prompts[:, i:i + 1],))
            launches = read_launches()["decode_attn"] - warm
            prof = _profile(f"graph_serve_{mode}", 8, "step",
                            lambda i: one(prompts[:, steps + i:
                                                  steps + i + 1]))
        torch.cuda.synchronize()
        runs[mode] = dict(logits=logits, secs=secs, caches=box[0],
                          launches=launches, warm=warm, prof=prof,
                          aot=reg.statistics()["aot_cached"], step=step,
                          pool=getattr(step, "pool_bytes", 0))
        del reg, caches, box, step, one
    g, e = runs["graphed"], runs["eager"]
    n_attn = len(attn_caches(cfg, g["caches"])) \
        * int(torch.device(device).type == "cuda")      # none on the CPU
    for i, (a, c) in enumerate(zip(g["logits"], e["logits"])):
        bitwise(_bits(a), _bits(c), f"graphed vs eager decode step {i} logits")
    _tree_bitwise(bitwise, g["caches"], e["caches"],
                  "graphed vs eager caches after the profiled steps")
    if g["aot"] != 1 or g["step"].trace_count != 1:
        _fail(f"serve: aot_cached {g['aot']}, trace_count "
              f"{g['step'].trace_count}; want 1 and 1")
    if g["launches"] != e["launches"] or \
            g["launches"] != n_attn * steps or g["warm"] != n_attn:
        _fail(f"serve: decode_attn launches graphed {g['launches']} (+ "
              f"{g['warm']} warm-up), eager {e['launches']}; want "
              f"{n_attn} a step x {steps} steps")
    out = dict(cfg=cfg, n_attn=n_attn, **{
        m: {k: v for k, v in r.items() if k not in ("logits", "caches")}
        for m, r in runs.items()})
    del model, runs, g, e
    return out


def graph_fleet(sz: Sizes, fz: FleetSizes, device, bitwise) -> dict:
    """The fused fleet at ``sz`` a shard, ``fz.ticks`` ticks graphed and
    eager: shard 3 unhealthy and shard 6 away for ticks 5-11, the core
    budget cut to a quarter and the fog budgets to two thirds and a
    sixth (within their slot ceilings) from tick 9;
    every output and the final state bitwise; one signature; then a
    remesh to 2 regions of 3 and 2 ticks: ``trace_count`` 2."""
    from contextlib import nullcontext
    from repro_torch.runtime import capture
    s = fz.shards
    runs = {}
    for mode in ("graphed", "eager"):
        restore = _same_clock()
        try:
            fx, state = make_fleet(sz, fz, device, fused=True)
            box = [state]

            def feed(i):
                if i == 5:
                    fx.set_health([k != 3 for k in range(s)])
                    fx.set_active([k != 6 for k in range(s)])
                if i == 9:
                    fx.set_core_budget(fz.core_budget // 4)
                    fx.set_region_budget([fz.fog_budget * 2 // 3,
                                          fz.fog_budget // 6])
                if i == 12:
                    fx.set_health([True] * s)
                    fx.set_active([True] * s)
                return fleet_batch(sz, fz, i, device)

            def step(items, ts):
                box[0], o = fx.step(box[0], items, ts)
                return o
            zero_launches()
            with capture.disable() if mode == "eager" else nullcontext():
                outs, secs = _timed_steps(step, fz.ticks, feed)
                launches = read_launches()
                prof = _profile(f"graph_fleet_{mode}", 4, "tick",
                                lambda i: step(*feed(fz.ticks + i)))
            runs[mode] = dict(outs=outs, secs=secs, state=box[0],
                              launches=launches, trace=fx.trace_count,
                              compiles=fx._compile_count(),
                              pool=fx._tick_step.pool_bytes, prof=prof)
            if mode == "graphed":
                st, _ = fx.remesh(box[0], 6)
                for i in range(2):
                    st, _ = fx.step(st, *fleet_batch(sz, fz, fz.ticks + 4 + i,
                                                     device, shards=6))
                runs[mode]["remesh"] = (fx.trace_count, fx._compile_count())
                del st
            del fx, box
        finally:
            restore()
    g, e = runs["graphed"], runs["eager"]
    for i, (a, b) in enumerate(zip(g["outs"], e["outs"])):
        _tree_bitwise(bitwise, a, b, f"graphed vs eager fleet tick {i}")
    _tree_bitwise(bitwise, g["state"], e["state"],
                  "graphed vs eager fleet final state")
    if (g["trace"], g["compiles"]) != (1, 1) or g["remesh"] != (2, 2):
        _fail(f"fleet: trace_count {g['trace']}, _compile_count "
              f"{g['compiles']}, after the remesh {g['remesh']}; want 1, 1 "
              "and (2, 2)")
    if g["launches"] != e["launches"]:
        _fail(f"fleet: graphed launches {g['launches']} != eager "
              f"{e['launches']}")
    return runs


def _graph_line(tag: str, unit: str, g: dict, e: dict, card: str,
                skip: int = 1) -> str:
    """p50/p99 and the busy share, eager and graphed (the graphed run's
    first ``skip`` calls, which captured, left out), and the graph's
    pool."""
    (gp, g99), (ep, e99) = _quant(g["secs"][skip:]), _quant(e["secs"])
    return (f"phase 10 {tag}: eager {unit} p50 {ep:.3f} ms, p99 {e99:.3f} "
            f"ms, busy {e['prof']['busy_share']:.4f} of the wall time "
            f"({e['prof']['ops']:.1f} device ops a {unit}); graphed p50 "
            f"{gp:.3f} ms, p99 {g99:.3f} ms, busy "
            f"{g['prof']['busy_share']:.4f} ({g['prof']['ops']:.1f} device "
            f"ops a {unit}, device busy {g['prof']['busy_ms']:.3f} ms a "
            f"{unit}); p50 {ep / gp:.2f}x; graph pool "
            f"{g['pool'] / 2**20:.1f} MiB; {card}")


def run_graph_phase(sz: Sizes, serve_sz: ServeSizes, fz: FleetSizes,
                    device) -> None:
    """Phase 10: the graphed stream ticks, Yi-6B decode step and fleet
    tick against ``capture.disable()`` at full width, each check failing
    the run; p50/p99 and the busy share of each, eager and graphed."""
    from repro_torch.testing import assert_bitwise
    t0 = time.perf_counter()
    card = _card_line()
    st = graph_stream(sz, device, assert_bitwise)
    for name in ("staged", "fused"):
        g = st[name]["graphed"]
        print(f"phase 10 {name} tick: {GRAPH_TICKS} ticks + a new budget, a "
              f"backfill and 3 live ticks after the capture, graphed == "
              f"eager bitwise (every StepOutput, the final state, the "
              f"lineage); trace_count 1, _compile_count 1; launches "
              f"{_nonzero(g['launches'])} either way")
        print(_graph_line(f"{name} tick", "tick", g, st[name]["eager"], card))
    del st
    _free()
    sv = graph_serve(serve_sz, device, assert_bitwise)
    g, e = sv["graphed"], sv["eager"]
    print(f"phase 10 serve: {sv['cfg'].name}, {GRAPH_SERVE_STEPS} of "
          f"{serve_sz.prompt_len + serve_sz.tokens} steps teacher-forced + 8 "
          f"profiled, graphed == eager bitwise (every step's logits, the "
          f"caches); aot_cached {g['aot']}; decode_attn "
          f"{g['launches'] / GRAPH_SERVE_STEPS:g} a step either way "
          f"(+ {g['warm']} in the capture's warm-up)")
    # captured at start_function: every timed step replayed
    print(_graph_line("serve decode step", "step", g, e, card, skip=0))
    del sv, g, e
    _free()
    fl = graph_fleet(sz, fz, device, assert_bitwise)
    g = fl["graphed"]
    print(f"phase 10 fleet: {fz.shards} shards fused, {fz.ticks} ticks with "
          f"a health and a membership flip and both budgets cut after the "
          f"capture, graphed == eager bitwise; trace_count 1, then 2 after "
          f"a remesh to 6 shards ({g['remesh']}); launches "
          f"{_nonzero(g['launches'])} either way")
    print(_graph_line("fleet tick", "tick", g, fl["eager"], card))
    del fl, g
    _free()
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        kernels = run()
    except Exception:                   # any failed check: no result line
        traceback.print_exc()
        return 1
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
