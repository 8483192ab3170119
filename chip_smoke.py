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
   instance its plan names; and the tracer's mark, stage_mark
   (``kernels.checks.check_stage_mark``), on a ring of the tracer's
   shape, its calibration probe's and a ragged one, through more ticks
   than the ring holds rows: the tags, the row count and the cells
   written bitwise those of its plain version on a CPU copy, the times
   in the marks' order, bad slots and rings refused; its launches
   counted from 0 over the check join the kernels line with one mark's
   device time (``check_marks``, ``time_stage_mark``);
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
   the card's name and power limit;
11. ``launch/`` and the examples: the host mesh (``make_host_mesh()``,
   one NCCL rank, printed with its backend); Yi-6B at full width and
   depth (phase 3's config and seed-0 weights, bf16 compute), 16
   requests, 32 steps through ``launch/serve`` on the mesh (weights
   placed by ``param_shardings``) and 32 without, the ids, the final
   logits and caches bitwise, every step's logits bitwise when both
   resolved steps replay the run, 32 decode_attn launches a step and
   none generic, ``aot_cached`` 1 with the mesh in the key; Yi-6B's
   smoke config in float32, 3 train steps with the mesh and
   ``sequence_shard`` against 3 without, bitwise (deterministic
   algorithms on); the five ``examples/*_torch.py`` through
   ``main(device="cuda")`` against ``main(device="cpu")`` (run in a
   second process at the same time; the model examples from the same
   CPU-drawn weights), every result number equal, the
   disaster-recovery scores and federated losses within 1e-5 relative
   with the configs in float32 and 4 bf16 ulps as shipped, a threshold
   decision differing only within that of the threshold, the kernels
   each example reaches launched (their counts join the kernels line as
   ``example_launches``, the mesh run's decode_attn count as
   ``mesh_launches``); and the dry run's probe sweep (``python -m
   repro_torch.launch.dryrun --arch all --shape all --probe``, on
   ``meta``, host only, in a third process): every applicable cell OK
   with its collectives counted (``collective_bytes`` > 0, the
   roofline's collective term with them) and every other SKIP, one line
   a cell with its collective GiB and the roofline's dominant term, its
   seconds;
12. the port across ranks: one rank a card, up to 4 (cut to 1, 2 or 4,
   the counts that divide 8 shards), each a process of
   ``launch.mesh.spawn`` on NCCL, every check failing the run: phase 7's
   fleet at full width (8 shards in 2 regions of 4, 65,536 rows a shard
   a tick, a 2^22-row ring), fused and staged, laid over the ranks
   (``FleetExecutor(mesh=rank_mesh(...))``), 16 graphed ticks with a
   health and a membership flip and both budgets cut after the capture,
   under phase 10's fake clock: every output row, the final state, the
   lineage banks and the fleet counters equal to the same fleet on one
   card (run first in this process) bitwise, through 64-bit digests of
   each row; the fused run eager too (``capture.disable()``), equal;
   ``trace_count`` 1 and ``_compile_count`` 1 on every rank, fused_tick
   ``8 / N`` and window_reduce ``40 / N`` launches a tick on each; then
   the AR exchange: each rank's 65,536 posts a step indexed through
   the hilbert kernel and routed by ``route_and_deliver(group=)`` over a
   ``(pod, data)`` mesh, ``(2, N / 2)`` (``(1, 1)`` on one card), equal
   to the stacked one-card form bitwise over 2 steps, hilbert once a
   step on each rank; and the cross-pod all-reduce of a float32
   gradient tree of one Yi-6B layer's shapes over each rank's pod
   group, equal to the dim-0 form bitwise; then (i) phase 8's
   controlled arc at full width, fused and graphed, under a
   ``FleetController`` with an event log and no ``step_times`` laid over
   the ranks (rank 0 decides and broadcasts; the sliding carry handed
   over and back), against the same arc on one card: every
   ``ControlDecision`` equal on every rank, rank 0's event log equal
   less wall times, every output row, the final state, the lineage and
   the counters bitwise, ``trace_count <= max_trace_count`` on every
   rank; and (ii) the controller's ``remesh`` 8 -> 6 -> 8 shards, twice
   (on 4 cards the 6 shards on ranks 0 and 2, ranks 1 and 3 idle; on 1
   or 2 cards the same ranks), the departed rows requeued through the
   injector on every rank and 2 ticks at each width, against the same
   widths on one card, bitwise; then, over the host mesh of every rank
   (``make_host_mesh()``, ``(N, 1)``), data-parallel serving and
   training, each model freed before the next: (iii) Yi-6B at full
   width and depth (seed-0 float32 weights, bf16 compute) through
   ``launch/serve``, 16 requests a rank (16N in all), 24 prompt ids
   teacher-forced + 8 generated: each rank's ids, final logits, caches
   and lengths bitwise one card serving its rows (run first in this
   process), every rank holding all 16N rows of ids, 32 decode_attn
   launches a step (none generic), one armatch lookup and
   ``aot_cached`` 1 on every rank; (iv) Yi-6B's widths cut to 2 layers
   in float32, 3 steps of a global batch of 2N x 1,024 tokens in 2
   microbatches through ``launch/train`` against one card on the same
   batch (run first on rank 0): losses and grad norms within 1e-5
   relative, the first step's gradients within 1e-5 and the parameters
   within 1e-4 of each leaf's largest, every replica's parameters and
   moments bitwise rank 0's after every step; (v) phase 9's run a rank
   (16 layers, 2 x 4,096 tokens a rank in 2 microbatches, 8 steps at lr
   3e-4): every loss finite and the replicas bitwise after every step,
   then the gradient all-reduce alone; then the same three for
   Mixtral-8x7B, whose MoE layers plan over the global batch: (vi) its
   full width at 8 layers, 16 requests a rank, 64 prompt ids + 32
   generated, against one card serving all 16N requests in one run on
   the ranks' path (their ids teacher-forced, eager, a hook reading
   every MoE call's expert ids): every id the card's pick or a near tie
   within 5e-2 of the largest logit, a late step from the ranks' caches
   within 5e-2 by phase 3's near-tie rule, the count of MoE calls
   whose global plan keeps other choices than the per-rank plans (above
   0 on N > 1), decode_attn launches a rank with none generic; (vii)
   its widths at 2 layers in float32, (iv)'s batch (one MoE group a
   microbatch spanning the ranks) against one card: losses within 1e-6
   relative, parameters within 1e-4, replicas bitwise; (viii) the same
   2 layers in bf16 at (v)'s batch (a group a rank), timed as (v) is.
   (vi) runs in float32 (bf16's rounding, 16 rows against 64, turns
   greedy ids) and then in bf16, timed.
   It prints the rank count and
   the backend, each path's p50/p99 tick, step or call ms (the slowest
   rank's), the device busy share, the bytes each rank sends a tick or
   step, the controller tick's p50/p99 beside one card's, each remesh's
   ms and bytes a rank, tokens/s over all ranks, each rank's peak
   memory, the gradient all-reduce's ms and bytes, and the card's name
   and power limit; the ranks' launches join the fused_tick,
   window_reduce, hilbert, decode_attn and armatch entries of the
   kernels line as ``rank_launches``.  ``python3 chip_smoke.py
   --phase12`` runs phase 1's build and this phase alone (the four-card
   run).

The line before the last is a JSON object of the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA card the
script exits 1 before printing either.
"""
from __future__ import annotations

import contextlib
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
    """``nvidia-smi``'s name and power limit, one card's after another."""
    return "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.split("\n")[:-1])


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


def check_marks(device) -> dict:
    """Phase 2's stage_mark check (``checks.check_stage_mark``), the
    kernel's launches counted from 0 over it."""
    from repro_torch.kernels import checks
    from repro_torch.kernels.stage_mark import stage_mark
    stage_mark.launches = 0
    err = checks.check_stage_mark(device)
    return {"max_abs_err": err, "launches": stage_mark.launches}


def time_stage_mark(device, marks: dict) -> dict:
    """The kernels line's stage_mark entry: one mark's device and wall
    time into a ring of the tracer's shape, beside the launches of phase
    2's check (``marks``).  A mark is one thread's two loads and one
    store, so its launch bounds it; no plain version or library call
    does its work on the card."""
    from repro_torch.kernels.stage_mark import stage_mark
    from repro_torch.obs.trace import RING_TICKS, RING_WIDTH
    ring = torch.zeros((RING_TICKS + 1, RING_WIDTH), dtype=torch.int64,
                       device=device)
    ms = _timed(lambda: stage_mark(ring, 1), 200, "stage_mark",
                kernel="stage_mark_kernel")
    print(f"kernel stage_mark a call: {_us(ms)}, bound by its launch (one "
          f"thread), launches {marks['launches']} (phase 2's check)")
    return {"name": "stage_mark", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/stage_mark.cu",
            "replaces": None, "launches": marks["launches"],
            "max_abs_err": marks["max_abs_err"], "ms": ms[0],
            "wall_ms": ms[1], "plain_ms": None, "bound_ms": None,
            "bound_by": "launch", "library_ms": None}


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
    from repro_torch.kernels.decode_attn.ops import kernel_attrs, plan_for
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
    attrs = kernel_attrs(q.dtype, d, g, how)
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
              f"{how.n_split}, {attrs['warps']} warps a block, "
              f"{attrs['registers']} registers and {attrs['local_bytes']} "
              f"local (spill) bytes a thread, {attrs['smem_bytes']} bytes "
              f"of shared memory a block, scratch 0 bytes in device memory "
              f"(the splits fold in the cluster's shared memory); kernel "
              f"{r['ms'][0] * 1e3:.3f} us = {nbytes / r['ms'][0] / 1e6:.1f} "
              f"GB/s, {row['bound_ms'] / r['ms'][0]:.4f} of the "
              f"{row['bound_ms'] * 1e3:.3f} us bound; SDPA "
              f"{r['library_ms'][0] * 1e3:.3f} us; plain "
              f"{r['plain_ms'][0] * 1e3:.3f} us")
    row.update(serve=cfg.name, shape=[b, h, hkv, d, s],
               instance=how.instance, n_split=how.n_split, **attrs,
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
    own, mine = "", 0.0
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
                busy_ms=busy * 1e3 / steps, kernel_us=mine / steps)


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


def profile_serve(sv: dict, steps=8, tag="serve") -> dict:
    """Where a decode step's time goes, over ``steps`` more steps from
    the run's final state (the ring cache wraps to its first row),
    through the run's captured step (replays); ``_profile``'s record."""
    res = sv["res"]
    box = [res.logits, res.lengths]

    def one(i):
        tok = torch.argmax(box[0], dim=-1).to(torch.int32)[:, None]
        box[0], _, box[1] = res.step(res.model, tok, res.caches, box[1])
    return _profile(tag, steps, "step", one, kernel="decode_attn_")


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
    marks = check_marks(device)
    print(f"phase 2 stage_mark: tags, row counts and cells written equal "
          f"to the plain version's on {len(checks.STAGE_MARK_RINGS)} rings "
          f"{[(t + 1, w) for t, w, _ in checks.STAGE_MARK_RINGS]}, times in "
          f"the marks' order, bad slots and rings refused; launches "
          f"{marks['launches']}")

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
    kernels["kernels"].append(time_stage_mark(device, marks))
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
    _free()
    run_launch_phase(MESH_SERVE, device, kernels["kernels"])
    _free()
    run_ranks_phase(sz, FLEET, device, kernels["kernels"])
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
    prof = profile_serve(rg, tag="serve_rg")
    p50 = float(np.quantile(np.asarray(rg["res"].secs), 0.5))
    print(f"phase 6 {rg['cfg'].name} step: graphed p50 {p50 * 1e3:.3f} ms "
          f"over {len(rg['res'].secs)} steps; decode_attn "
          f"({rg['instance']}, {rg['n_attn']} launches a step) "
          f"{prof['kernel_us']:.3f} us a step device (profiled), "
          f"{prof['kernel_us'] * 1e-3 / (p50 * 1e3):.4f} of the p50")
    row.update(step_p50_ms=p50 * 1e3, step_us=prof["kernel_us"])
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
               fog_budget=-1, drop_rule=False, mesh=None):
    """A fleet of ``regions x edges`` shards (``fz``'s by default) at the
    single tick's per-shard config and core stand-in; ``fog_budget=None``
    is non-binding; ``drop_rule`` adds :data:`DROP_RULE` to the rules;
    ``mesh``: laid over its ranks (this rank's rows)."""
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
        engine, pipe, device=device, mesh=mesh)
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


def run_controlled(fx, state, ctl, inj, feed, churn, on_tick,
                   step_times: bool = True, ctl_secs: list | None = None):
    """Drive ``fx`` under ``ctl`` through ``inj``'s schedule:
    :data:`CONTROL_TICKS` fresh ticks of ``feed``, then drain ticks
    (``fresh=False``) until the injector holds nothing, then
    :data:`CONTROL_QUIET` quiet ticks.  ``churn`` (shard, leave, join)
    is acted with the sliding carry handoff.  Each tick calls
    ``on_tick(t, out, decision, origin, offered, replay, health)``,
    ``health`` the mask the tick ran under.  ``step_times=False``: the
    controller ticks on its own wall time (rank 0's across ranks);
    ``ctl_secs`` collects each control tick's wall time.  Across ranks
    each rank steps its rows of the feed.  Returns the final state and
    the churned shard's backup."""
    s = fx.cfg.num_shards
    rows = slice(fx.shard_offset, fx.shard_offset + fx.local_shards)
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
        state, out = fx.step(state, items[rows], ts[rows],
                             offered=offered[rows], replay=replay[rows])
        t1 = time.perf_counter()
        dec = ctl.tick(state, step_times=inj.schedule.stall_time(t, s)
                       if step_times else None)
        if ctl_secs is not None:
            ctl_secs.append(time.perf_counter() - t1)
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
    magnitude, computed on ``a``'s device (``b`` copied there): a rank
    runs torch on one CPU thread, where a 3 B-parameter model's leaves
    take half a minute."""
    a = a.detach().float()
    b = b.detach().to(a.device).float()
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


# ---- phase 11: launch/ on the card and the five examples -----------------

#: Yi-6B at full width and depth through the host mesh: 24 prompt ids
#: teacher-forced and 8 generated, 32 decode steps
MESH_SERVE = ServeSizes(requests=16, prompt_len=24, tokens=8)
#: each example (``examples/<name>.py``) and the kernels it reaches on
#: the card; the disaster-recovery example's models run the
#: full-sequence forward, which no hand kernel serves
EXAMPLES = {"quickstart_torch": ("armatch", "hilbert"),
            "edge_stream_analytics_torch": ("window_reduce",),
            "fleet_stream_analytics_torch": ("window_reduce",),
            "disaster_recovery_torch": (),
            "federated_stream_train_torch": ("armatch", "hilbert")}
#: the model examples, also run with their configs computing in float32,
#: and the seeds of their models' weights
MODEL_EXAMPLES = {"disaster_recovery_torch": (0, 1),
                  "federated_stream_train_torch": (0,)}
#: their scores and losses, card against CPU, relative: float32; and
#: bfloat16 as shipped, 4 ulps (cuBLAS and the CPU round bfloat16
#: products at different points)
EXAMPLE_REL = {"float32": 1e-5, "bfloat16": 4 * 2.0 ** -8}
DR_THRESHOLD = 3.19


def _example(name: str):
    import importlib
    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _float32_configs(mod) -> dict:
    """The model example's config globals in float32 compute (the
    globals to restore are returned)."""
    import dataclasses
    old = {k: getattr(mod, k) for k in ("cfg", "edge_cfg", "core_cfg")
           if hasattr(mod, k)}
    for k, cfg in old.items():
        setattr(mod, k, dataclasses.replace(cfg, compute_dtype=torch.float32))
    return old


def _cpu_weights(mod) -> tuple:
    """The model example's weights, drawn by the port's init on the CPU
    (a card's generator draws other numbers from the same seed) and laid
    out as the reference's tree, one a model."""
    from repro_torch import convert, optim
    from repro_torch.models import transformer as T
    cfgs = [mod.edge_cfg, mod.core_cfg] if hasattr(mod, "edge_cfg") \
        else [mod.cfg]
    trees = []
    for cfg, seed in zip(cfgs, MODEL_EXAMPLES[mod.__name__]):
        model = T.init_params(cfg, seed=seed, device="cpu", trainable=True)
        trees.append(convert.train_state_tree(
            cfg, model, optim.init(model, optim.AdamWConfig()))[0])
    return tuple(trees)


def run_examples(device) -> dict:
    """Each example's ``main(device=...)``, its printing kept out of this
    script's output, then the model examples once more in float32:
    ``{(name, compute): (result, launches)}``.  The model examples take
    the same CPU-drawn weights on every device."""
    import contextlib
    import io
    out = {}
    runs = [(n, "bfloat16") for n in EXAMPLES] + \
        [(n, "float32") for n in MODEL_EXAMPLES]
    for name, compute in runs:
        mod = _example(name)
        old = _float32_configs(mod) if compute == "float32" else {}
        try:
            kw = {}
            if name in MODEL_EXAMPLES:
                w = _cpu_weights(mod)
                kw["params"] = w if len(w) > 1 else w[0]
            zero_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                res = mod.main(device=device, **kw)
            out[(name, compute)] = (res, read_launches())
        finally:
            for k, v in old.items():
                setattr(mod, k, v)
    return out


def examples_on_cpu(path: str) -> None:
    """:func:`run_examples` on the CPU, pickled to ``path`` (phase 11
    runs it in a second process, beside the card's runs)."""
    sys.path.insert(0, str(ROOT / "src"))
    torch.save(run_examples("cpu"), path)


def _rel_err(x, ref) -> float:
    """The largest ``|x - ref| / |ref|``: 0 where both are 0, infinite
    where only ``ref`` is, and infinite for a NaN on either side."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    d = np.abs(x - ref)
    err = np.max(np.divide(d, np.abs(ref), out=np.where(d == 0, 0.0, np.inf),
                           where=ref != 0), initial=0.0)
    return np.inf if np.isnan(err) else float(err)


def _compare_examples(card: dict, cpu: dict) -> list:
    """Card against CPU: every result number equal; the model examples'
    scores and losses within :data:`EXAMPLE_REL`, a threshold decision
    differing only where its score lies within that of the threshold.
    Returns one line a run."""
    lines = []
    for key, (res, launches) in card.items():
        name, compute = key
        ref = cpu[key][0]
        rel = EXAMPLE_REL[compute]
        note = ""
        if name == "disaster_recovery_torch":
            f, rf = res["features"], ref["features"]
            err = _rel_err(f, rf)
            if err > rel:
                _fail(f"{name} ({compute}): features off the CPU by {err:.3e}"
                      f" relative (tolerance {rel})")
            near = np.abs(rf[:, 0] - DR_THRESHOLD) <= rel * np.abs(rf[:, 0])
            flip = np.asarray(res["decisions"]) != np.asarray(ref["decisions"])
            if (flip & ~near).any() or res["dropped"] != ref["dropped"] or \
                    abs(res["escalated"] - ref["escalated"]) > flip.sum():
                _fail(f"{name} ({compute}): decisions differ away from the "
                      f"threshold: card {res['escalated']}/{res['stored']}/"
                      f"{res['dropped']}, CPU {ref['escalated']}/"
                      f"{ref['stored']}/{ref['dropped']}")
            note = (f"escalated/stored/dropped {res['escalated']}/"
                    f"{res['stored']}/{res['dropped']} (CPU "
                    f"{ref['escalated']}/{ref['stored']}/{ref['dropped']}), "
                    f"scores within {err:.3e} relative, {int(flip.sum())} "
                    f"decision(s) differ, all within {rel:g} of the "
                    f"threshold ({int(near.sum())} frame(s) there)")
        elif name == "federated_stream_train_torch":
            l, rl = np.asarray(res["losses"]), np.asarray(ref["losses"])
            err = _rel_err(l, rl) if len(l) == len(rl) else np.inf
            if (res["admitted"], res["rejected"], len(l)) != \
                    (ref["admitted"], ref["rejected"], len(rl)) or err > rel:
                _fail(f"{name} ({compute}): admitted {res['admitted']}, "
                      f"rejected {res['rejected']}, {len(l)} steps, losses "
                      f"{err:.3e} relative; CPU {ref['admitted']}, "
                      f"{ref['rejected']}, {len(rl)}")
            np.testing.assert_array_equal(res["ranks"], ref["ranks"])
            note = (f"admitted {res['admitted']}, rejected "
                    f"{res['rejected']}, {len(l)} steps, loss {l[0]:.3f} -> "
                    f"{l[-1]:.3f}, losses within {err:.3e} relative")
        else:
            if res != ref:
                _fail(f"{name}: card {res} != CPU {ref}")
            if name == "quickstart_torch":
                note = f"query hits {res['query_hits']}, rank {res['rank']}"
            else:
                m = res["metrics"]
                m = m.get("fleet", m)
                note = (f"{m['windows_emitted']} windows -> "
                        f"{m['windows_escalated']} escalated")
                if "core_processed" in res["metrics"]:
                    note += (f", core processed "
                             f"{sum(res['metrics']['core_processed'])}, "
                             f"per-bridge "
                             f"{res['metrics']['shard']['windows_escalated']}")
        missing = [k for k in EXAMPLES[name] if not launches[k]]
        if missing:
            _fail(f"{name}: {missing} never launched on the card "
                  f"({launches})")
        lines.append(f"phase 11 example {name} ({compute}): card == CPU; "
                     f"{note}; kernels launched {_nonzero(launches)}")
    return lines


def mesh_serve(sz: ServeSizes, mesh, device, bitwise) -> dict:
    """Yi-6B at ``sz`` through ``launch/serve`` twice from the same
    weights, on the host ``mesh`` (parameters placed by
    ``param_shardings``) and without one: the ids, the final logits and
    caches bitwise, every layer of every step through decode_attn (none
    generic), one cached step keyed on the mesh; then both resolved
    steps replay the run from fresh caches, every step's logits
    bitwise."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = serve_config(sz)
    model = T.init_params(cfg, seed=0, device=device)
    n_attn = len(attn_caches(cfg, T.init_caches(cfg, 1, 1, "meta")))
    steps = sz.prompt_len + sz.tokens
    runs = {}
    for name, m in (("mesh", mesh), ("meshless", None)):
        zero_launches()
        res = serve.run(cfg, sz.requests, sz.prompt_len, sz.tokens,
                        device=device, model=model, mesh=m)
        generic = _wrappers()["decode_attn"].generic_launches
        if res.launches != n_attn * steps or generic or res.aot_cached != 1:
            _fail(f"mesh serve ({name}): {res.launches} decode_attn launches "
                  f"({generic} generic), aot_cached {res.aot_cached}; want "
                  f"{n_attn} a step x {steps} steps, 0, 1")
        feed = torch.cat([torch.from_numpy(serve.prompts_for(
            cfg, sz.requests, sz.prompt_len)), torch.from_numpy(res.tokens)],
            dim=1).to(device)
        caches = T.init_caches(cfg, sz.requests, steps, device)
        lengths = torch.zeros((sz.requests,), dtype=torch.int32,
                              device=device)
        logits = []
        for t in range(steps):
            out, caches, lengths = res.step(model, feed[:, t:t + 1], caches,
                                            lengths)
            logits.append(out.clone())
        bitwise(_bits(logits[-1]), _bits(res.logits),
                f"mesh serve ({name}): replayed last logits")
        runs[name] = dict(res=res, logits=logits, caches=caches)
    a, b = runs["mesh"], runs["meshless"]
    np.testing.assert_array_equal(a["res"].tokens, b["res"].tokens)
    for t, (x, y) in enumerate(zip(a["logits"], b["logits"])):
        bitwise(_bits(x), _bits(y), f"mesh vs meshless step {t} logits")
    _tree_bitwise(bitwise, a["res"].caches, b["res"].caches,
                  "mesh vs meshless caches at the end")
    out = dict(cfg=cfg, n_attn=n_attn, steps=steps, launches=
               a["res"].launches, secs={k: r["res"].secs
                                        for k, r in runs.items()})
    del model, runs, a, b
    return out


def mesh_train(mesh, device, bitwise, steps: int = 3) -> str:
    """Yi-6B's smoke config in float32: ``steps`` train steps with the
    host mesh and ``sequence_shard=True`` against the same steps without
    a mesh, from the same weights and batches, bitwise (losses, grad
    norms, parameters), under deterministic algorithms (the embedding
    gradient's scatter-add otherwise adds in no fixed order)."""
    from repro_torch import optim
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as T
    cfg = train_config(TRAIN_SMALL)
    batches = [_train_batch(cfg, TRAIN_SMALL, i, device)
               for i in range(steps)]
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for m in (mesh, None):
            model = T.init_params(cfg, seed=0, device=device, trainable=True)
            if m is not None:
                model = shd.place(model, shd.param_shardings(cfg, m, model),
                                  m)
            opt_cfg = optim.AdamWConfig(lr=TRAIN_SMALL.lr)
            state = optim.init(model, opt_cfg)
            step = steps_mod.build_train_step(cfg, opt_cfg, mesh=m,
                                              sequence_shard=m is not None)
            met = []
            for b in batches:
                model, state, mt = step(model, state, b)
                met.append(torch.stack([mt["loss"], mt["grad_norm"]]))
            runs.append((model, torch.stack(met)))
    finally:
        torch.use_deterministic_algorithms(was)
    (ma, a), (mb, b) = runs
    bitwise(a, b, "mesh vs meshless train losses and grad norms")
    pb = dict(mb.named_parameters())
    for name, p in ma.named_parameters():
        bitwise(p.detach(), pb[name].detach(), f"mesh vs meshless {name}")
    return (f"{cfg.name} float32, {steps} steps of {TRAIN_SMALL.batch} x "
            f"{TRAIN_SMALL.seq}, losses {a[:, 0].tolist()}")


def _gib(rec: dict, key: str) -> str:
    return "-" if key not in rec else f"{rec[key] / 2**30:.3f}"


def dryrun_lines(out_dir: Path) -> list:
    """The single-pod probe sweep's records: every applicable cell OK
    with its collectives counted, every other SKIP (the reference's
    rule); one line a cell, with the whole program's collective GiB and
    the roofline's three terms and the dominant one."""
    from repro_torch.configs.registry import (ARCH_IDS, SHAPES, get_config,
                                              shape_applicable)
    lines = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            rec = json.loads((out_dir / f"{arch}__{shape}__sp.json")
                             .read_text())
            want = "OK" if shape_applicable(get_config(arch), shape) \
                else "SKIP"
            if rec["status"] != want:
                _fail(f"dry run {arch} {shape}: {rec['status']} (want "
                      f"{want}): {rec.get('error')}")
            if want == "SKIP":
                lines.append(f"phase 11 dryrun {arch} {shape}: SKIP "
                             f"({rec['reason']})")
                continue
            terms = rec["roofline"]
            if not (rec["collective_bytes"] > 0 and rec["collectives"]
                    and terms["collective_counted"]):
                _fail(f"dry run {arch} {shape}: collectives not counted: "
                      f"{rec['collectives']}")
            lines.append(
                f"phase 11 dryrun {arch} {shape} 16x16: OK, GiB a device "
                f"params {_gib(rec, 'param_bytes_per_device')} optimizer "
                f"{_gib(rec, 'opt_bytes_per_device')} cache "
                f"{_gib(rec, 'cache_bytes_per_device')}, flops "
                f"{rec['flops']:.4e}, useful_flops_ratio "
                f"{rec['useful_flops_ratio']:.4f}, collectives "
                f"{_gib(rec, 'collective_bytes')} GiB the whole program ("
                + ", ".join(f"{k} {v['count']}" for k, v in
                            sorted(rec["collectives"].items()))
                + f" ops a device), roofline ms compute "
                f"{terms['compute_s'] * 1e3:.3f} memory "
                f"{terms['memory_s'] * 1e3:.3f} collective "
                f"{terms['collective_s'] * 1e3:.3f}, dominant "
                f"{terms['dominant']}")
    return lines


def run_launch_phase(sz: ServeSizes, device, rows: list) -> None:
    """Phase 11: the host mesh on the card (Yi-6B served through it and
    without it, the train step with it and without it, bitwise), the
    five examples card against CPU (the CPU runs in a second process)
    with their kernels launched, and the dry run's probe sweep in a
    third process; ``mesh_launches`` and ``example_launches`` join the
    kernels line's entries."""
    import os
    import shutil
    import torch.distributed as dist
    from repro_torch.launch.mesh import (axis_sizes, make_host_mesh,
                                         release_host_mesh)
    from repro_torch.testing import assert_bitwise
    t0 = time.perf_counter()
    card = _card_line()
    build = ROOT / "build"
    out_dir = build / "dryrun_phase11"
    shutil.rmtree(out_dir, ignore_errors=True)
    cpu_path = build / "examples_cpu.pt"
    cpu_path.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dry_cmd = ("import runpy, sys, time; t = time.perf_counter(); "
               "sys.argv = ['dryrun', '--arch', 'all', '--shape', 'all', "
               f"'--probe', '--out', {str(out_dir)!r}]; "
               "runpy.run_module('repro_torch.launch.dryrun', "
               "run_name='__main__'); "
               "print('DRYRUN_SECONDS', time.perf_counter() - t)")
    procs = [subprocess.Popen([sys.executable, "-c", dry_cmd], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True),
             subprocess.Popen([sys.executable, "-c",
                               "import chip_smoke; chip_smoke."
                               f"examples_on_cpu({str(cpu_path)!r})"],
                              cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)]
    try:
        mesh = make_host_mesh(device=device)
        print(f"phase 11 host mesh: {mesh} {axis_sizes(mesh)}, backend "
              f"{dist.get_backend()}, world size {dist.get_world_size()}")
        sv = mesh_serve(sz, mesh, device, assert_bitwise)
        q = {k: _quant(v) for k, v in sv["secs"].items()}
        print(f"phase 11 mesh serve: {sv['cfg'].name} ({sv['cfg'].n_layers} "
              f"layers, {sz.compute} compute), {sz.requests} requests, "
              f"{sv['steps']} steps through launch/serve on the host mesh "
              f"== without it bitwise (ids, final logits and caches; every "
              f"step's logits replayed); decode_attn {sv['n_attn']} a step "
              f"either way, none generic; aot_cached 1 with the mesh in "
              f"its key; step p50/p99 {q['mesh'][0]:.3f}/{q['mesh'][1]:.3f} "
              f"ms on the mesh, {q['meshless'][0]:.3f}/{q['meshless'][1]:.3f}"
              f" ms without; {card}")
        _free()
        print(f"phase 11 mesh train: "
              f"{mesh_train(mesh, device, assert_bitwise)}; with the host "
              f"mesh and sequence_shard == without bitwise")
        t_ex = time.perf_counter()
        ex_card = run_examples(device)
        card_s = time.perf_counter() - t_ex
        _free()
        err = procs[1].communicate(timeout=600)[1]
        if procs[1].returncode != 0:
            _fail(f"the examples on the CPU failed: {err[-3000:]}")
        ex_cpu = torch.load(cpu_path, weights_only=False)
        for line in _compare_examples(ex_card, ex_cpu):
            print(line)
        print(f"phase 11 examples: {len(ex_card)} runs on the card in "
              f"{card_s:.1f} s, the same on the CPU in a second process")
        out, err = procs[0].communicate(timeout=600)
        if procs[0].returncode != 0:
            _fail(f"the dry run failed: {err[-3000:]}")
        secs = float(out.split("DRYRUN_SECONDS")[-1])
        for line in dryrun_lines(out_dir):
            print(line)
        print(f"phase 11 dryrun: python -m repro_torch.launch.dryrun --arch "
              f"all --shape all --probe, torch {torch.__version__}, "
              f"{secs:.1f} s in its own process (host only)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        release_host_mesh()
    ex_launches: dict = {}
    for _, launches in ex_card.values():
        for k, v in launches.items():
            ex_launches[k] = ex_launches.get(k, 0) + v
    seen = set()
    for row in rows:         # the first entry of each kernel
        name = row["name"]
        if name in seen:
            continue
        seen.add(name)
        if name == "decode_attn":
            row["mesh_launches"] = sv["launches"]
        if ex_launches.get(name):
            row["example_launches"] = ex_launches[name]
    print(f"phase 11: {time.perf_counter() - t0:.1f} s; {card}")


# ---- phase 12: the fleet, the AR exchange and the all-reduce across ranks --

#: ticks a fleet path runs across the ranks (phase 10's feed: a health
#: and a membership flip at tick 5, both budgets cut at 9, back at 12)
RANK_TICKS = 16
#: AR route steps a rank times, each of phase 3's 65,536 posts
RANK_AR_STEPS = 16
#: calls of the cross-pod all-reduce a rank times
RANK_ALLREDUCE_REPS = 4
#: the ranks' routing capacity a (source, destination) pair: twice the
#: mean share of a rank's posts, as phase 3's 4x of 256 ranks is
RANK_AR_FACTOR = 2


def phase12_ranks() -> int:
    """One rank a card, up to 4, cut to 1, 2 or 4 (the counts that
    divide the fleet's 8 shards)."""
    n = torch.cuda.device_count()
    return 4 if n >= 4 else 2 if n >= 2 else 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _digest(t: torch.Tensor) -> int:
    """A 64-bit digest of ``t``'s bytes, computed on its device: the
    bytes as int64 words (zero-padded), each times an odd weight from a
    fixed generator, summed modulo 2^64.  Any one flipped bit changes
    it; two tensors on different ranks are held bitwise equal through
    their digests."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    b = torch.nn.functional.pad(b, (0, -b.numel() % 8))
    words = b.view(torch.int64)
    k = 1 << 16
    words = torch.nn.functional.pad(words, (0, -words.numel() % k))
    words = words.view(-1, k)
    key = (str(t.device), words.shape[0])
    if key not in _DIGEST_W:
        gen = torch.Generator(t.device).manual_seed(24)
        rows = torch.randint(-2**62, 2**62, (words.shape[0], 1),
                             generator=gen, device=t.device,
                             dtype=torch.int64) | 1
        cols = torch.randint(-2**62, 2**62, (k,), generator=gen,
                             device=t.device, dtype=torch.int64) | 1
        _DIGEST_W[key] = rows * cols
    return int((words * _DIGEST_W[key]).sum())


_DIGEST_W: dict = {}


def _row_digests(tree) -> dict:
    """Each tensor leaf of a (named) tuple tree, one digest a shard row
    (its dim 0), keyed by the leaf's position."""
    from repro_torch.runtime import capture
    return {i: [_digest(x[r]) for r in range(x.shape[0])]
            for i, x in enumerate(capture.flatten(tree)[0])
            if isinstance(x, torch.Tensor) and x.ndim > 0}


def _flip_feed(fx, sz: Sizes, fz: FleetSizes, device, i: int, rows: slice):
    """Tick ``i`` of phase 10's fleet feed (:func:`graph_fleet`): shard 3
    unhealthy and shard 6 away for ticks 5-11, the core budget cut to a
    quarter and the fog budgets to two thirds and a sixth from tick 9;
    the rows ``rows`` of the batch (every rank draws all 8 shards' from
    their seeds)."""
    s = fz.shards
    if i == 5:
        fx.set_health([k != 3 for k in range(s)])
        fx.set_active([k != 6 for k in range(s)])
    if i == 9:
        fx.set_core_budget(fz.core_budget // 4)
        fx.set_region_budget([fz.fog_budget * 2 // 3, fz.fog_budget // 6])
    if i == 12:
        fx.set_health([True] * s)
        fx.set_active([True] * s)
    items, ts = fleet_batch(sz, fz, i, device)
    return items[rows], ts[rows]


def rank_fleet(sz: Sizes, fz: FleetSizes, device, fused: bool, mesh=None,
               graphed: bool = True, profile: str | None = None) -> dict:
    """The fleet of phase 7 over ``mesh``'s ranks (this rank's rows), or
    on one card (``mesh=None``), :data:`RANK_TICKS` ticks of
    :func:`_flip_feed` under phase 10's fake clock, each timed between
    two synchronizes; launch counts zeroed just before and read just
    after, and the bytes the collectives sent.  Returns the digests of
    every output row and of the final state, the fleet counters
    (gathered), the lineage banks, the trace counts and the timing;
    ``profile``: a tag under which 4 more ticks are profiled."""
    from contextlib import nullcontext
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.runtime import capture
    restore = _same_clock()
    try:
        fx, state = make_fleet(sz, fz, device, fused=fused, mesh=mesh)
        rows = slice(fx.shard_offset, fx.shard_offset + fx.local_shards)
        box, outs, secs = [state], [], []
        zero_launches()
        sent0 = COLLECTIVES.sent_bytes
        with nullcontext() if graphed else capture.disable():
            for i in range(RANK_TICKS):
                items, ts = _flip_feed(fx, sz, fz, device, i, rows)
                _sync(device)
                t0 = time.perf_counter()
                box[0], out = fx.step(box[0], items, ts)
                _sync(device)
                secs.append(time.perf_counter() - t0)
                outs.append(_row_digests(out))
            launches = read_launches()
            sent = COLLECTIVES.sent_bytes - sent0
            res = dict(outs=outs, state=_row_digests(box[0]),
                       lineage=_row_digests(fx._lineage),
                       metrics=fx.gather(box[0].metrics).as_dict(),
                       trace=fx.trace_count, compiles=fx._compile_count(),
                       launches=launches, secs=secs,
                       sent=sent / RANK_TICKS, prof=None)
            if profile is not None:     # after the record: 4 more ticks
                def tick(i):
                    box[0], _ = fx.step(box[0], *_flip_feed(
                        fx, sz, fz, device, RANK_TICKS + i, rows))
                res["prof"] = _profile(profile, 4, "tick", tick)
        return res
    finally:
        restore()


class RankAR(NamedTuple):
    table: torch.Tensor         # cell -> rank over the ("pod", "data") mesh
    pool: torch.Tensor          # [n, 128] data profiles
    num_ranks: int
    capacity: int


def rank_ar_plane(n: int, mesh_shape: tuple, device) -> RankAR:
    """The AR exchange's overlay over the ranks' ``(pod, data)`` mesh at
    phase 3's routing granularity, and phase 3's message pool."""
    from repro_torch.core.overlay import Overlay
    from repro_torch.kernels.checks import random_profiles
    ranks = mesh_shape[0] * mesh_shape[1]
    table = Overlay.from_mesh_shape(*mesh_shape, capacity=4,
                                    replication=2).routing_table(
                                        AR_GRANULARITY)
    pool = random_profiles(np.random.default_rng(7), n)
    return RankAR(torch.from_numpy(table).to(device),
                  torch.from_numpy(pool).to(device), ranks,
                  RANK_AR_FACTOR * n // ranks)


def rank_ar_feed(plane: RankAR, rank: int, step: int):
    """Rank ``rank``'s posts at ``step``: a permutation of the pool and
    ``[n, 8]`` payloads, from seed 30,000 + 100 rank + step."""
    gen = torch.Generator(plane.pool.device).manual_seed(
        30_000 + 100 * rank + step)
    n = plane.pool.shape[0]
    perm = torch.randperm(n, generator=gen, device=plane.pool.device)
    payload = torch.randn((n, AR_VALUE_DIM), generator=gen,
                          device=plane.pool.device)
    return plane.pool[perm], payload


def rank_grads(rank: int, device, smoke: bool = False) -> dict:
    """A float32 gradient tree of one Yi-6B layer's shapes (read from the
    port's model on ``meta``; ``smoke``: its smoke config's), drawn on
    ``device`` from seed 40,000 + 100 rank + the leaf's index."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import smoke_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(smoke_config("yi_6b") if smoke
                              else get_config("yi_6b"), n_layers=1)
    shapes = {n: tuple(p.shape) for n, p in
              T.init_params(cfg, device="meta").layers[0].named_parameters()}
    out = {}
    for j, (name, shape) in enumerate(sorted(shapes.items())):
        gen = torch.Generator(device).manual_seed(40_000 + 100 * rank + j)
        out[name] = torch.randn(shape, generator=gen, device=device) * 1e-3
    return out


def _rank_phase(rank: int, device, sz: Sizes, fz: FleetSizes, n_ar: int,
                pod_data: tuple, smoke: bool = False,
                models: tuple | None = None) -> dict:
    """Phase 12 on one rank (``launch.mesh.spawn``, NCCL, this rank's
    card): the fleet fused (graphed, profiled, then eager) and staged
    over the ranks' fleet mesh; the AR route step over a ``(pod, data)``
    mesh, its post indices through the hilbert kernel; the cross-pod
    all-reduce over this rank's pod group; given ``models`` (the sizes
    of (iii), (iv) and (v), then of (vi)-(viii)),
    :func:`_rank_models_phase`.  Digests,
    launches, bytes and times come back to the parent."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import routing, sfc
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.runtime import compression
    card = device.type == "cuda"
    if card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build_all()               # loads what the parent built
    res = {"rank": rank, "backend": dist.get_backend(),
           "card": torch.cuda.get_device_name(device) if card else "cpu"}
    fmesh = _fleet_mesh(sz, fz, device)
    res["fleet_mesh"] = tuple(fmesh.mesh.shape)
    res["fused"] = rank_fleet(sz, fz, device, True, fmesh, profile=(
        f"rank{rank}_fleet_fused" if card else None))
    res["fused_eager"] = rank_fleet(sz, fz, device, True, fmesh,
                                    graphed=False)
    res["staged"] = rank_fleet(sz, fz, device, False, fmesh, profile=(
        f"rank{rank}_fleet_staged" if card else None))
    if card:
        _free()
    # the controlled arc and remesh across the ranks: (i) and (ii)
    res.update(_rank_control_phase(rank, device, sz, fz, fmesh))

    # the AR exchange: one rank's posts a step, over every rank
    mesh = init_device_mesh(device.type, pod_data,
                            mesh_dim_names=("pod", "data"))
    plane = rank_ar_plane(n_ar, pod_data, device)
    world = dist.group.WORLD

    def ar_step(step):
        keys, payload = rank_ar_feed(plane, rank, step)
        idx = sfc.profile_index(keys)                       # hilbert
        return routing.route_and_deliver(payload, idx, plane.table,
                                         plane.num_ranks, plane.capacity,
                                         group=world)
    checked = [ar_step(s) for s in range(2)]     # warm-up, and checked
    res["ar"] = [(_digest(r), _digest(c), c.cpu().tolist())
                 for r, c in checked]
    zero_launches()
    sent0, secs = COLLECTIVES.sent_bytes, []
    for s in range(RANK_AR_STEPS):
        _sync(device)
        t1 = time.perf_counter()
        ar_step(2 + s)
        _sync(device)
        secs.append(time.perf_counter() - t1)
    res["ar_launches"] = read_launches()
    res["ar_secs"] = secs
    res["ar_sent"] = (COLLECTIVES.sent_bytes - sent0) / RANK_AR_STEPS
    res["ar_prof"] = _profile(f"rank{rank}_ar", 4, "step",
                              lambda i: ar_step(100 + i)) if card else None
    del checked
    if card:
        _free()

    # the cross-pod all-reduce over this rank's pod group
    grads = rank_grads(rank, device, smoke)
    pod = mesh.get_group("pod")
    synced, errs = compression.cross_pod_allreduce(
        grads, compression.init_errors(grads), group=pod)
    res["allreduce"] = {k: (_digest(synced[k]), _digest(errs[k]))
                        for k in sorted(grads)}
    del synced, errs
    sent0, secs = COLLECTIVES.sent_bytes, []
    for _ in range(RANK_ALLREDUCE_REPS):
        errs0 = compression.init_errors(grads)
        _sync(device)
        t1 = time.perf_counter()
        compression.cross_pod_allreduce(grads, errs0, group=pod)
        _sync(device)
        secs.append(time.perf_counter() - t1)
    res["allreduce_secs"] = secs
    res["allreduce_prof"] = _profile(
        f"rank{rank}_allreduce", 2, "call",
        lambda i: compression.cross_pod_allreduce(
            grads, compression.init_errors(grads), group=pod)) \
        if card else None
    res["allreduce_sent"] = (COLLECTIVES.sent_bytes - sent0) \
        / RANK_ALLREDUCE_REPS
    res["allreduce_bytes"] = sum(g.numel() * 4 for g in grads.values())
    res["coords"] = (mesh.get_local_rank("pod"), mesh.get_local_rank("data"))
    del grads
    if card:
        _free()
    if models is not None:
        res["models"] = _rank_models_phase(rank, device, *models)
    return res


def _ranks_stack(parts: list, key: str) -> dict:
    """The ranks' row digests of one record, concatenated in rank order
    (rank r holds shards r S/N onward)."""
    out: dict = {}
    for p in parts:
        for i, rows in p[key].items():
            out.setdefault(i, []).extend(rows)
    return out


def _check_rank_fleet(name: str, one: dict, parts: list,
                      counted: bool = True) -> None:
    """The ranks' fleet against the one-card fleet: every output row of
    every tick, the final state, the lineage banks and the fleet
    counters; with ``counted``, one signature and one graph on every
    rank."""
    for i, want in enumerate(one["outs"]):
        bad = _differ(_stack_rows([p["outs"][i] for p in parts]), want)
        if bad:
            _fail(f"phase 12 {name}: tick {i}'s outputs across "
                  f"{len(parts)} rank(s) differ from one card's at (leaf, "
                  f"shard) {bad[:8]}")
    for key in ("state", "lineage"):
        bad = _differ(_ranks_stack(parts, key), one[key])
        if bad:
            _fail(f"phase 12 {name}: the final {key} across ranks differs "
                  f"from one card's at (leaf, shard) {bad[:8]}")
    for p in parts:
        if p["metrics"] != one["metrics"]:
            _fail(f"phase 12 {name}: fleet counters differ on a rank")
        if counted and (p["trace"], p["compiles"]) != (1, 1):
            _fail(f"phase 12 {name}: trace_count {p['trace']}, "
                  f"_compile_count {p['compiles']} on a rank; want 1, 1")


def _differ(got: dict, want: dict) -> list:
    """(leaf, shard) of every row digest that differs."""
    return [(j, r) for j in want for r, d in enumerate(want[j])
            if got.get(j, [None] * len(want[j]))[r] != d] \
        or ([] if got.keys() == want.keys() else ["leaves"])


def _stack_rows(recs: list) -> dict:
    """Row digests of several ranks' records (``{leaf: [row, ...]}``),
    concatenated in rank order."""
    out: dict = {}
    for rec in recs:
        for j, rows in rec.items():
            out.setdefault(j, []).extend(rows)
    return out


# ---- phase 12 (i) and (ii): the control plane and remesh across ranks ------

#: (ii): a shard is offered this fraction of a micro-batch more rows a tick
#: than its ring dequeues, so the rings back up and a departed shard's
#: unconsumed rows come back as the payload
REMESH_EXTRA = 4
#: (ii)'s widths after phase 7's 8 shards in 2 regions of 4: (shards,
#: keep); 6 shards are 2 regions of 3 (shards 3 and 7 depart, their rows
#: the payload), then 8 again (a fresh joiner at the end of each region);
#: twice, so that the second round runs on groups and connections the
#: first made
REMESH_WIDTHS = ((6, (0, 1, 2, 4, 5, 6)),
                 (8, (0, 1, 2, None, 3, 4, 5, None))) * 2
#: (ii)'s ticks at each width
REMESH_TICKS = 2


def remesh_rank_sets(n: int) -> tuple:
    """(ii)'s rank set for each width of :data:`REMESH_WIDTHS`: on 4
    ranks the 6 shards on ranks 0 and 2 (a region each, ranks 1 and 3
    idle outside the fleet; the rows of shards 2 and 6 move rank to
    rank), then all 4 again (form (b)); on 1 or 2 ranks the same ranks
    at the new width (form (a))."""
    every = tuple(range(n))
    return tuple((0, 2) if n == 4 and width < 8 else every
                 for width, _ in REMESH_WIDTHS)


def _fleet_mesh(sz: Sizes, fz: FleetSizes, device):
    """The ranks' mesh of phase 7's fleet (``rank_mesh``: every rank)."""
    from repro_torch.stream import StreamConfig
    from repro_torch.stream.fleet import FleetConfig
    from repro_torch.stream.fleet.executor import rank_mesh
    return rank_mesh(FleetConfig(
        stream=StreamConfig(micro_batch=sz.batch, window=sz.window,
                            stride=sz.stride, capacity=sz.capacity),
        num_shards=fz.shards, num_regions=fz.regions), device)


def rank_control(sz: Sizes, fz: FleetSizes, device, mesh=None) -> dict:
    """Phase 12 (i): phase 8's check-1 arc -- shard 2 stalled, shard 5
    away with its stream replayed on a backup and its sliding carry
    handed over and back, the budgets pinned ample -- fused and graphed,
    under a ``FleetController`` with an event log ticking without
    ``step_times`` (rank 0's own wall time, phase 10's fake clock in the
    executors so that every stamp agrees with one card's), over
    ``mesh``'s ranks (this rank's rows) or on one card.  Launch counts
    are zeroed just before the arc and read just after.  Returns each
    tick's decision and output row digests, the final state's and the
    lineage's, the fleet counters, the event log less wall times, the
    trace counts, the launches and each control tick's seconds."""
    from repro_torch.runtime import ElasticBudget
    ample = fz.shards * (sz.batch // sz.stride)
    feed = control_feed(sz, fz, device)
    restore = _same_clock()
    try:
        fx, state, ctl, inj, log = _controlled(
            sz, fz, device,
            fleet=dict(core_budget=ample, fog_budget=None, mesh=mesh),
            budget_policy=ElasticBudget(min_budget=ample, max_budget=ample))
        decisions, outs, ctl_s = [], [], []

        def on_tick(t, out, dec, *_):
            decisions.append(_decision(dec))
            outs.append(_row_digests(out))
        zero_launches()
        state, backup = run_controlled(fx, state, ctl, inj, feed,
                                       CONTROL_CHURN, on_tick,
                                       step_times=False, ctl_secs=ctl_s)
        launches = read_launches()
        return dict(decisions=decisions, outs=outs,
                    state=_row_digests(state),
                    lineage=_row_digests(fx._lineage),
                    metrics=fx.gather(state.metrics).as_dict(),
                    events=_events(log), trace=fx.trace_count,
                    bound=ctl.max_trace_count, launches=launches,
                    ctl_s=ctl_s, backup=backup,
                    flagged=sum(not d["healthy"][CONTROL_FAULT[0]]
                                for d in decisions))
    finally:
        restore()


def rank_remesh(sz: Sizes, fz: FleetSizes, device, rank_sets=None,
                mesh=None) -> dict:
    """Phase 12 (ii): phase 7's fleet, fused and graphed, under a
    ``FleetController`` (core budget pinned, the fog policies elastic)
    ticking without ``step_times``, offered ``1 / REMESH_EXTRA`` more
    rows a shard a tick than it dequeues; :data:`REMESH_TICKS` ticks at
    8 shards, then for each width of :data:`REMESH_WIDTHS` the
    controller's ``remesh`` over ``rank_sets`` (``None`` on one card),
    the injector translated and the departed rows re-queued on their
    fold targets' slots, and :data:`REMESH_TICKS` ticks.  Each rank
    steps its rows of the feed; a rank outside the fleet idles.  Returns
    the decisions and output row digests of the ticks this rank was a
    member for, the payloads' row counts and digests, each remesh's
    seconds (from a barrier of the ranks) and the bytes this rank sent
    in it, the final state's and
    lineage's digests, the counters, the event log, the trace counts and
    the launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.obs import EventLog
    from repro_torch.runtime import ElasticBudget
    from repro_torch.stream.fleet import (FaultInjector, FaultSchedule,
                                          FleetController)
    big = sz._replace(batch=sz.batch + sz.batch // REMESH_EXTRA)
    restore = _same_clock()
    try:
        fx, state = make_fleet(sz, fz, device, mesh=mesh)
        log = EventLog()
        ctl = FleetController(fx, event_log=log, budget_policy=ElasticBudget(
            min_budget=fz.core_budget, max_budget=fz.core_budget))
        inj = FaultInjector(FaultSchedule(), event_log=log)
        rec: dict = dict(outs={}, decisions={}, payload={}, remesh=[])
        box, clock = [state], [0]

        def ticks(width):
            for _ in range(REMESH_TICKS):
                t = clock[0]
                items, ts = fleet_batch(big, fz, t, device, shards=width)
                items, ts, offered, _ = inj.inject(t, items.cpu().numpy(),
                                                   ts.cpu().numpy())
                rows = slice(fx.shard_offset,
                             fx.shard_offset + fx.local_shards)
                box[0], out = fx.step(box[0], items[rows], ts[rows],
                                      offered=offered[rows])
                dec = ctl.tick(box[0])
                if dec is not None:
                    rec["outs"][t] = _row_digests(out)
                    rec["decisions"][t] = _decision(dec)
                clock[0] += 1
        zero_launches()
        ticks(fz.shards)
        for (width, keep), ranks in zip(REMESH_WIDTHS, rank_sets
                                        or (None,) * len(REMESH_WIDTHS)):
            keep = list(keep)
            _sync(device)
            if mesh is not None:
                # the ranks meet first, so that the time is the remesh's
                # and not an idle rank's wait for the members' ticks
                dist.barrier()
            sent, t0 = COLLECTIVES.sent_bytes, time.perf_counter()
            box[0], payload = ctl.remesh(
                box[0], width, keep=keep,
                ranks=None if ranks is None else list(ranks))
            _sync(device)
            rec["remesh"].append((time.perf_counter() - t0,
                                  COLLECTIVES.sent_bytes - sent))
            inj.translate(keep, clock[0])
            fold = ctl.remesh_fold
            for k, rows in sorted(payload.items()):
                rec["payload"][(clock[0], k)] = (
                    len(rows), _digest(torch.from_numpy(rows)))
                inj.requeue(keep.index(fold[k]), rows, big.batch)
            ticks(width)
        rec.update(launches=read_launches(), state=_row_digests(box[0]),
                   lineage=_row_digests(fx._lineage),
                   metrics=fx.gather(box[0].metrics).as_dict(),
                   events=_events(log), trace=fx.trace_count,
                   bound=ctl.max_trace_count)
        return rec
    finally:
        restore()


def _rank_control_phase(rank: int, device, sz: Sizes, fz: FleetSizes,
                        mesh=None) -> dict:
    """Phase 12 (i) and (ii) on one rank (``launch.mesh.spawn``; also
    run by :func:`_rank_phase`, which passes its fleet mesh)."""
    import torch.distributed as dist
    card = device.type == "cuda"
    if mesh is None:
        mesh = _fleet_mesh(sz, fz, device)
    res = {"rank": rank, "backend": dist.get_backend(),
           "control": rank_control(sz, fz, device, mesh)}
    if card:
        _free()
    res["remesh"] = rank_remesh(sz, fz, device,
                                remesh_rank_sets(dist.get_world_size()),
                                mesh)
    if card:
        _free()
    return res


def phase12_control_references(sz: Sizes, fz: FleetSizes, device) -> dict:
    """(i) and (ii) on one card in this process: what the ranks are held
    to."""
    out = {"control": rank_control(sz, fz, torch.device(device))}
    if torch.device(device).type == "cuda":
        _free()
    out["remesh"] = rank_remesh(sz, fz, torch.device(device))
    if torch.device(device).type == "cuda":
        _free()
    return out


def check_phase12_control(refs: dict, parts: list, fz: FleetSizes,
                          launches: bool = True) -> dict:
    """Every rank's (i) and (ii) against one card's (each check fails the
    run): every ``ControlDecision`` equal on every rank, rank 0's event
    log equal less wall times, every output row, the final state and the
    lineage banks bitwise through their row digests, the fleet counters
    equal, ``trace_count <= max_trace_count`` on every rank; (ii) also
    the payloads on every rank's host.  With ``launches``: fused_tick
    once a shard a tick over the ranks, window_reduce never.  Returns
    the numbers phase 12 prints."""
    n = len(parts)
    one = refs["control"]
    runs = [p["control"] for p in parts]
    for r, c in enumerate(runs):
        if c["decisions"] != one["decisions"]:
            i = next((i for i, (a, b) in enumerate(zip(
                c["decisions"], one["decisions"])) if a != b), "count")
            _fail(f"phase 12 (i): rank {r}'s decision at tick {i} differs "
                  "from one card's")
        if c["metrics"] != one["metrics"]:
            _fail(f"phase 12 (i): rank {r}'s fleet counters differ")
        if not 1 <= c["trace"] <= c["bound"]:
            _fail(f"phase 12 (i): rank {r} trace_count {c['trace']}, "
                  f"max_trace_count {c['bound']}")
    if runs[0]["events"] != one["events"]:
        _fail("phase 12 (i): rank 0's event log differs from one card's")
    for i, want in enumerate(one["outs"]):
        bad = _differ(_stack_rows([c["outs"][i] for c in runs]), want)
        if bad:
            _fail(f"phase 12 (i): tick {i}'s outputs across {n} rank(s) "
                  f"differ from one card's at (leaf, shard) {bad[:8]}")
    for key in ("state", "lineage"):
        bad = _differ(_stack_rows([c[key] for c in runs]), one[key])
        if bad:
            _fail(f"phase 12 (i): the final {key} differs at {bad[:8]}")
    one_r = refs["remesh"]
    rem = [p["remesh"] for p in parts]
    for r, c in enumerate(rem):
        if any(one_r["decisions"][t] != d for t, d in c["decisions"].items()):
            _fail(f"phase 12 (ii): rank {r}'s decisions differ")
        if c["payload"] != one_r["payload"] or not one_r["payload"]:
            _fail(f"phase 12 (ii): rank {r}'s payload {c['payload']} != one "
                  f"card's {one_r['payload']}")
        if c["metrics"] != one_r["metrics"]:
            _fail(f"phase 12 (ii): rank {r}'s fleet counters differ")
        if not 1 <= c["trace"] <= c["bound"]:
            _fail(f"phase 12 (ii): rank {r} trace_count {c['trace']}, "
                  f"max_trace_count {c['bound']}")
    if rem[0]["events"] != one_r["events"] \
            or rem[0]["decisions"].keys() != one_r["decisions"].keys():
        _fail("phase 12 (ii): rank 0's event log or ticks differ")
    for t, want in one_r["outs"].items():
        bad = _differ(_stack_rows([c["outs"][t] for c in rem
                                   if t in c["outs"]]), want)
        if bad:
            _fail(f"phase 12 (ii): tick {t}'s outputs differ at {bad[:8]}")
    for key in ("state", "lineage"):
        bad = _differ(_stack_rows([c[key] for c in rem]), one_r[key])
        if bad:
            _fail(f"phase 12 (ii): the final {key} differs at {bad[:8]}")
    ticks = len(one["decisions"])
    widths = [fz.shards] + [w for w, _ in REMESH_WIDTHS]
    want = {"control": fz.shards * ticks,
            "remesh": sum(widths) * REMESH_TICKS}
    got = {k: sum(p[k]["launches"]["fused_tick"] for p in parts)
           for k in want}
    if launches:
        for k in want:
            if got[k] != want[k] or any(p[k]["launches"]["window_reduce"]
                                        for p in parts):
                _fail(f"phase 12 ({k}): fused_tick {got[k]} launches over "
                      f"the ranks, want {want[k]}; window_reduce "
                      f"{[p[k]['launches']['window_reduce'] for p in parts]}")
    idle = [r for r, c in enumerate(rem)
            if len(c["decisions"]) < len(one_r["decisions"])]
    return dict(ticks=ticks, launches=got, idle=idle,
                payload=sum(k for k, _ in one_r["payload"].values()),
                flagged=one["flagged"], backup=one["backup"],
                health=sum(e["kind"] == "health_change"
                           for e in one["events"]))


# ---- phase 12 (iii)-(v): data-parallel serving and training across ranks ---

#: (iii) Yi-6B at phase 3's width and depth (seed-0 float32 weights,
#: bfloat16 compute), phase 11's 24 prompt ids teacher-forced and 8
#: generated, ``requests`` a rank (N x that in all)
RANK_SERVE = MESH_SERVE
#: (iv) the equality check: Yi-6B's widths cut to 2 layers, float32
#: compute (TF32 off), 3 steps of ``batch`` x 1,024 tokens a rank (a
#: global batch of 2N rows) in 2 microbatches, ``TRAIN_SMALL``'s lr
RANK_TRAIN_CHECK = TrainSizes(steps=3, batch=2, seq=1024, microbatches=2,
                              layers=2, compute="float32", lr=2e-3)
#: (v) phase 9's run a rank: Yi-6B at full width, 16 of 32 layers, 8
#: steps of 2 x 4,096 tokens a rank in 2 microbatches at lr 3e-4
RANK_TRAIN_FULL = TRAIN_FULL._replace(witness=())
#: calls of the gradient all-reduce timed apart from the step
RANK_GRAD_REPS = 3
#: (iv)'s parameters after its 3 steps against one card's, of each
#: leaf's largest magnitude.  AdamW divides each gradient element by its
#: own magnitude plus 1e-8, so an element near 1e-8 turns the last-bit
#: differences of the two sums (each rank's share, then the ring against
#: one card's GEMMs) into up to its whole update, ``lr`` x the schedule
#: (4e-4 at step 2): 2.81e-5 of the embedding's largest value on four
#: H100s.  The sums themselves, the gradients the first step hands AdamW
#: from the same weights, are held to :data:`TRAIN_CARD_VS_CPU`.
RANK_TRAIN_PARAM = 1e-4


@contextlib.contextmanager
def _first_update(fn):
    """Within the block, ``optim.update``'s first call hands its
    gradients to ``fn`` first; ``fn``'s value is the list's one item."""
    from repro_torch import optim
    real, seen = optim.update, []

    def update(grads, *args, **kw):
        if not seen:
            seen.append(fn(grads))
        return real(grads, *args, **kw)
    optim.update = update
    try:
        yield seen
    finally:
        optim.update = real


def _serve_digests(res) -> dict:
    """A serve run's rows as 64-bit digests: this rank's ids, every
    rank's block of the gathered ids, the final logits, caches and
    lengths."""
    ids = torch.from_numpy(res.tokens)
    per = res.rows.stop - res.rows.start
    return dict(ids=_digest(ids[res.rows]),
                gathered=[_digest(ids[j:j + per])
                          for j in range(0, ids.shape[0], per)],
                shape=tuple(ids.shape), logits=_digest(res.logits),
                caches=[{k: _digest(v) for k, v in c.items()}
                        for c in res.caches],
                lengths=_digest(res.lengths))


def rank_serve(sz: ServeSizes, device, mesh=None, prompts=None,
               model=None) -> dict:
    """``sz``'s model (Yi-6B for (iii)) through ``launch/serve``: over
    ``mesh``'s N data ranks, ``sz.requests`` a rank of N x that many
    prompts (this rank's rows); on one card, ``prompts``' rows.  The
    weights are seed 0's (``model`` if given); the launch counts are
    zeroed just before the run and read just after.  Returns
    :func:`_serve_digests`, the launches, ``aot_cached`` and each
    step's seconds."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import data_group, dp_size
    from repro_torch.models import transformer as T
    cfg = serve_config(sz)
    n = 1 if data_group(mesh) is None else dp_size(mesh)
    if model is None:
        model = T.init_params(cfg, seed=0, device=device)
    zero_launches()
    res = serve.run(cfg, sz.requests * n if prompts is None
                    else len(prompts), sz.prompt_len, sz.tokens,
                    device=device, model=model, mesh=mesh, prompts=prompts)
    launches = read_launches()
    n_attn = len(attn_caches(cfg, T.init_caches(cfg, 1, 1, "meta")))
    return dict(_serve_digests(res), launches=launches,
                loop_launches=res.launches, n_attn=n_attn,
                generic=_wrappers()["decode_attn"].generic_launches,
                aot_cached=res.aot_cached, secs=res.secs,
                finite=res.finite, name=cfg.name)


#: int64 words a chunk of :func:`_chunk_digests` holds (128 MiB)
DIGEST_CHUNK = 1 << 24


def _chunk_digests(t: torch.Tensor) -> list:
    """``t``'s bytes as :func:`_digest`s of :data:`DIGEST_CHUNK`-word
    chunks: a model's state is digested with one chunk's weights and
    temporaries at a time, not its largest tensor's."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 8:
        b = torch.nn.functional.pad(b, (0, -b.numel() % 8))
    words = b.view(torch.int64)
    return [_digest(words[i:i + DIGEST_CHUNK])
            for i in range(0, words.numel(), DIGEST_CHUNK)]


def _state_digests(model, opt_state) -> list:
    """A parameter's and its moments' chunk digests, in parameter order
    (the digests' weight cache is emptied after, so that the train
    step's memory does not hold it)."""
    out = []
    for name, p in model.named_parameters():
        for t in (p, opt_state.m[name], opt_state.v[name]):
            out += _chunk_digests(t)
    _DIGEST_W.clear()
    return out


def rank_train_check(tz: TrainSizes, device, mesh) -> dict:
    """(iv): rank 0 first trains one card on the whole global batch
    (``tz.batch`` x N rows, no mesh) from seed 0's weights and keeps the
    losses, the gradients its first step hands AdamW and the final
    parameters on the host; then every rank trains its share over
    ``mesh`` from the same weights (rank 0's, broadcast), each
    parameter's and moment's digest taken after every step.  Rank 0
    returns the losses' and grad norms' relative differences and the
    first gradients' and final parameters' leaf differences
    (:func:`_leaf_err`) from one card."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import data_group, data_rank, dp_size
    from repro_torch.models import transformer as T
    cfg = train_config(tz)
    n = 1 if data_group(mesh) is None else dp_size(mesh)
    rank = data_rank(mesh)
    kw = dict(microbatches=tz.microbatches, lr=tz.lr, device=device)
    rec = {}
    if rank == 0:
        with _first_update(lambda g: {name: t.detach().cpu()
                                      for name, t in g.items()}) as first:
            one = train.run(cfg, tz.steps, tz.batch * n, tz.seq, model=(
                T.init_params(cfg, seed=0, device=device, trainable=True)),
                **kw)
        want = {name: p.detach().cpu()
                for name, p in one.model.named_parameters()}
        want_grads = first[0]
        rec["one_losses"], rec["one_norms"] = one.losses, one.grad_norms
        del one, first
        _free()
    digests = []
    with _first_update(lambda g: max(
            _leaf_err(t, want_grads[name]) for name, t in g.items())
            if rank == 0 else None) as grad_err:
        res = train.run(cfg, tz.steps, tz.batch * n, tz.seq, model=(
            T.init_params(cfg, seed=0, device=device, trainable=True)),
            mesh=mesh, on_step=lambda s, m, o: digests.append(
                _state_digests(m, o)), **kw)
    rec.update(losses=res.losses, grad_norms=res.grad_norms,
               digests=digests, ranks=res.health.num_ranks)
    if rank == 0:
        rec["loss_err"] = max(abs(a - b) / abs(b) for a, b in
                              zip(res.losses + res.grad_norms,
                                  rec["one_losses"] + rec["one_norms"]))
        rec["losses_err"] = max(abs(a - b) / abs(b) for a, b in
                                zip(res.losses, rec["one_losses"]))
        rec["grad_err"] = grad_err[0]
        rec["param_err"] = max(_leaf_err(p, want[name]) for name, p in
                               res.model.named_parameters())
    return rec


def rank_train_full(tz: TrainSizes, device, mesh) -> dict:
    """(v): phase 9's run a rank over ``mesh`` (``tz.batch`` x N rows a
    step, this rank's share), each parameter's and moment's digest and
    the bytes this rank has sent (``COLLECTIVES``) after every step, the
    peak of ``max_memory_allocated``; then the gradient all-reduce alone
    (:func:`steps.sum_gradients` of zeros of every parameter's shape, as
    the step sums them) :data:`RANK_GRAD_REPS` times, each between two
    synchronizes, and the bytes a call sends."""
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import COLLECTIVES, data_group, dp_size
    from repro_torch.models import transformer as T
    cfg = train_config(tz)
    group = data_group(mesh)
    n = 1 if group is None else dp_size(mesh)
    card = device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(device)
    digests, sent = [], []

    def on_step(step, model, opt_state):
        sent.append(COLLECTIVES.sent_bytes)
        digests.append(_state_digests(model, opt_state))
    res = train.run(cfg, tz.steps, tz.batch * n, tz.seq,
                    microbatches=tz.microbatches, lr=tz.lr, device=device,
                    model=T.init_params(cfg, seed=0, device=device,
                                        trainable=True),
                    mesh=mesh, on_step=on_step)
    peak = torch.cuda.max_memory_allocated(device) if card else 0
    retries = torch.cuda.memory_stats(device).get("num_alloc_retries", 0) \
        if card else 0
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in res.model.parameters())
    ar_secs, ar_sent = [], 0.0
    if group is not None:
        grads = {name: torch.zeros_like(p)
                 for name, p in res.model.named_parameters()}
        sent0 = COLLECTIVES.sent_bytes
        for _ in range(RANK_GRAD_REPS):
            _sync(device)
            t0 = time.perf_counter()
            steps.sum_gradients(grads, group)
            _sync(device)
            ar_secs.append(time.perf_counter() - t0)
        ar_sent = (COLLECTIVES.sent_bytes - sent0) / RANK_GRAD_REPS
        del grads
    return dict(losses=res.losses, grad_norms=res.grad_norms,
                secs=res.secs, digests=digests,
                step_sent=np.diff(sent).tolist(), peak=peak,
                retries=retries,
                ar_secs=ar_secs, ar_sent=ar_sent, grad_bytes=grad_bytes,
                ranks=res.health.num_ranks, layers=cfg.n_layers,
                name=cfg.name)


def _rank_models_phase(rank: int, device, serve_sz: ServeSizes,
                       check_tz: TrainSizes, full_tz: TrainSizes,
                       moe: tuple | None = None) -> dict:
    """Phase 12 (iii)-(v) on one rank (``launch.mesh.spawn``; also run by
    :func:`_rank_phase`) over the host mesh of every rank, then, given
    ``moe`` (the sizes of (vi), (vii) and (viii)), the same three for
    the MoE model (:func:`_rank_moe_phase`), each model freed before the
    next is built."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    card = device.type == "cuda"
    _DIGEST_W.clear()               # the fleet rows' digest weights
    if card:
        _free()
    mesh = make_host_mesh(device=device)
    res = {"rank": rank, "backend": dist.get_backend(),
           "serve": rank_serve(serve_sz, device, mesh)}
    if rank == 0:       # its rows on one card in this process: the timing
        from repro_torch.launch import serve
        prompts = serve.prompts_for(serve_config(serve_sz), serve_sz.requests
                                    * dist.get_world_size(),
                                    serve_sz.prompt_len)
        res["serve_here"] = rank_serve(serve_sz, device, prompts=prompts[
            :serve_sz.requests])["secs"]
    if card:
        _free()
    res["train_check"] = rank_train_check(check_tz, device, mesh)
    if card:
        _free()
    res["train_full"] = rank_train_full(full_tz, device, mesh)
    if card:
        _free()
    if moe is not None:
        res.update(_rank_moe_phase(rank, device, mesh, *moe))
    return res


def _rank_moe_phase(rank: int, device, mesh, serve_sz: ServeSizes,
                    timed_sz: ServeSizes, check_tz: TrainSizes,
                    full_tz: TrainSizes) -> dict:
    """(vi)-(viii) on one rank over ``mesh``: the MoE model served at
    ``serve_sz`` a rank (:func:`rank_moe_serve`), then at ``timed_sz``
    (:func:`rank_serve`; on rank 0 also its rows alone on one card: the
    one-card step time), trained at ``check_tz`` against one card
    (:func:`rank_train_check`) and at ``full_tz``
    (:func:`rank_train_full`), each model freed before the next."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    card = device.type == "cuda"
    res = {"moe_serve": rank_moe_serve(serve_sz, device, mesh)}
    if card:
        _free()
    res["moe_timed"] = rank_serve(timed_sz, device, mesh)
    if rank == 0:
        prompts = serve.prompts_for(serve_config(timed_sz), timed_sz.requests
                                    * dist.get_world_size(),
                                    timed_sz.prompt_len)
        res["moe_timed_here"] = rank_serve(timed_sz, device, prompts=prompts[
            :timed_sz.requests])["secs"]
    if card:
        _free()
    res["moe_check"] = rank_train_check(check_tz, device, mesh)
    if card:
        _free()
    res["moe_full"] = rank_train_full(full_tz, device, mesh)
    if card:
        _free()
    return res


def phase12_model_references(sz: ServeSizes, device, n: int) -> dict:
    """(iii)'s one-card runs in this process: rank r's ``sz.requests``
    rows of the N x ``sz.requests`` prompts, one run a rank from the same
    seed-0 weights, freed after.  That is a dense model's reference
    only: an MoE layer plans over every rank's rows, so an MoE model's
    is one card serving the whole batch, (vi)'s
    (:func:`phase12_moe_reference`); an MoE ``sz`` raises."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = serve_config(sz)
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name} is an MoE model: its reference is one "
                         "card serving the whole batch, (vi)'s")
    model = T.init_params(cfg, seed=0, device=device)
    prompts = serve.prompts_for(cfg, sz.requests * n, sz.prompt_len)
    q = sz.requests
    out = [rank_serve(sz, device, prompts=prompts[r * q:(r + 1) * q],
                      model=model) for r in range(n)]
    del model
    if torch.device(device).type == "cuda":
        _free()
    return {"serve": out}


def _check_replicas(tag: str, runs: list) -> None:
    """Every rank's losses, grad norms and per-step digests equal rank
    0's."""
    first = runs[0]
    for r, run in enumerate(runs):
        if len(run["digests"]) != len(first["losses"]):
            _fail(f"phase 12 {tag}: rank {r} took {len(run['digests'])} "
                  f"digests over {len(first['losses'])} steps")
        for step, (a, b) in enumerate(zip(run["digests"], first["digests"])):
            if a != b:
                bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
                _fail(f"phase 12 {tag}: rank {r}'s replica differs from "
                      f"rank 0's after step {step} (parameter/moment "
                      f"digests {bad[:8]})")
        if run["losses"] != first["losses"] \
                or run["grad_norms"] != first["grad_norms"]:
            _fail(f"phase 12 {tag}: rank {r}'s losses or grad norms differ "
                  f"from rank 0's")
        if run["ranks"] != len(runs):
            _fail(f"phase 12 {tag}: rank {r}'s monitors count "
                  f"{run['ranks']} rank(s), want {len(runs)}")


def _check_serve_run(tag: str, r: int, got: dict, sz: ServeSizes,
                     launches: bool) -> None:
    """Rank ``r``'s serve run: ``aot_cached`` 1 and finite logits; with
    ``launches`` the attention layers' decode_attn launches every step,
    none generic, and one armatch lookup."""
    if got["aot_cached"] != 1 or not got["finite"]:
        _fail(f"phase 12 {tag}: rank {r} aot_cached {got['aot_cached']}, "
              f"logits finite {got['finite']}")
    steps = sz.prompt_len + sz.tokens
    if launches and (got["loop_launches"] != got["n_attn"] * steps
                     or got["generic"] or got["launches"]["armatch"] != 1):
        _fail(f"phase 12 {tag}: rank {r} launched decode_attn "
              f"{got['loop_launches']} times in its loop ({got['generic']}"
              f" generic), armatch {got['launches']['armatch']}; want "
              f"{got['n_attn']} a step x {steps} steps, 0, 1")


def check_phase12_models(refs: dict, parts: list, sz: ServeSizes,
                         launches: bool = True) -> None:
    """(iii)-(v) on every rank, each check failing the run: (iii) each
    rank's ids, final logits, caches and lengths equal to one card
    serving its rows (:func:`phase12_model_references`) through their
    digests, every rank holding all N x ``sz.requests`` rows of ids,
    ``aot_cached`` 1, and with ``launches`` the attention layers'
    decode_attn launches every step (none generic) and one armatch
    lookup; (iv) rank 0's losses, grad norms and first gradients within
    :data:`TRAIN_CARD_VS_CPU` of one card's, its parameters within
    :data:`RANK_TRAIN_PARAM`, and (iv) and (v) every replica bitwise
    rank 0's after every step (:func:`_check_replicas`), every loss
    finite."""
    n = len(parts)
    for r, p in enumerate(parts):
        got, want = p["serve"], refs["serve"][r]
        for key in ("ids", "logits", "caches", "lengths"):
            if got[key] != want[key]:
                _fail(f"phase 12 (iii): rank {r}'s served {key} differ from "
                      f"one card serving its {sz.requests} requests")
        if got["gathered"] != [w["ids"] for w in refs["serve"]] \
                or got["shape"] != (n * sz.requests, sz.tokens):
            _fail(f"phase 12 (iii): rank {r}'s gathered ids {got['shape']} "
                  f"are not every rank's rows")
        _check_serve_run("(iii)", r, got, sz, launches)
    check = parts[0]["train_check"]
    if check["loss_err"] > TRAIN_CARD_VS_CPU \
            or check["grad_err"] > TRAIN_CARD_VS_CPU \
            or check["param_err"] > RANK_TRAIN_PARAM:
        _fail(f"phase 12 (iv): {n} rank(s) against one card: losses "
              f"{check['losses']} vs {check['one_losses']} (losses and "
              f"grad norms within {check['loss_err']:.3e} relative), the "
              f"first step's gradients within {check['grad_err']:.3e} of "
              f"each leaf's largest (tolerance {TRAIN_CARD_VS_CPU}), the "
              f"parameters within {check['param_err']:.3e} (tolerance "
              f"{RANK_TRAIN_PARAM})")
    for tag, key in (("(iv)", "train_check"), ("(v)", "train_full")):
        runs = [p[key] for p in parts]
        if not np.isfinite(runs[0]["losses"]).all():
            _fail(f"phase 12 {tag}: non-finite losses {runs[0]['losses']}")
        _check_replicas(tag, runs)


def print_phase12_models(refs: dict, parts: list, sz: ServeSizes,
                         check_tz: TrainSizes, full_tz: TrainSizes,
                         card: str) -> dict:
    """(iii)-(v)'s lines, each with the card's name and power limit:
    tokens/s over all ranks, the slowest rank's step p50/p99, the peaks,
    the gradient all-reduce's ms and bytes.  Returns the ranks' launch
    totals for the kernels line."""
    n = len(parts)
    backend = parts[0]["backend"]
    sv = [p["serve"] for p in parts]
    steps = len(sv[0]["secs"])
    slow = [max(s["secs"][i] for s in sv) for i in range(steps)]
    q, q1 = _quant(slow), _quant(refs["serve"][0]["secs"])
    q0 = _quant(parts[0]["serve_here"])
    print(f"phase 12 (iii) serve across {n} {backend} rank(s): "
          f"{sv[0]['name']} at full width and depth, {sz.requests} requests "
          f"a rank ({n * sz.requests} in all), {sz.prompt_len} prompt ids "
          f"teacher-forced + {sz.tokens} generated: every rank's ids, final "
          f"logits, caches and lengths == one card serving its rows "
          f"bitwise, every rank holds the {sv[0]['shape']} ids; "
          f"aot_cached 1 on every rank; decode_attn "
          f"{[s['loop_launches'] for s in sv]} loop launches a rank "
          f"({sv[0]['n_attn']} a step, none generic), armatch "
          f"{[s['launches']['armatch'] for s in sv]} a rank; "
          f"{n * sz.requests * steps / sum(slow):.1f} tokens/s over all "
          f"ranks (every rank's ids over the slowest rank's steps); step "
          f"p50 {q[0]:.3f} ms, p99 {q[1]:.3f} ms (the slowest rank's; one "
          f"card at {sz.requests} requests p50 {q1[0]:.3f} ms, p99 "
          f"{q1[1]:.3f} ms in this process, {q0[0]:.3f} ms, {q0[1]:.3f} ms "
          f"without the mesh in rank 0's); {card}")
    c = parts[0]["train_check"]
    print(f"phase 12 (iv) train across {n} {backend} rank(s): "
          f"{check_tz.arch}'s widths at {check_tz.layers} layers, "
          f"{check_tz.compute} (TF32 off), {check_tz.steps} steps of "
          f"{check_tz.batch * n} x {check_tz.seq} tokens ({check_tz.batch} "
          f"rows a rank) in {check_tz.microbatches} microbatches at lr "
          f"{check_tz.lr}: losses {c['losses']} against one card's "
          f"{c['one_losses']} (losses and grad norms within "
          f"{c['loss_err']:.3e} relative), the first step's gradients "
          f"within {c['grad_err']:.3e} of each leaf's largest (tolerance "
          f"{TRAIN_CARD_VS_CPU}), the parameters after {check_tz.steps} "
          f"steps within {c['param_err']:.3e} (tolerance "
          f"{RANK_TRAIN_PARAM}); every replica's parameters and moments "
          f"bitwise rank 0's after every step; {card}")
    print(_train_full_line("(v)", [p["train_full"] for p in parts],
                           full_tz, backend, card))
    return {"decode_attn": sum(s["launches"]["decode_attn"] for s in sv),
            "armatch": sum(s["launches"]["armatch"] for s in sv)}


def _train_full_line(tag: str, full: list, full_tz: TrainSizes,
                     backend: str, card: str) -> str:
    """(v)'s or (viii)'s line: the losses, tokens/s over all ranks, the
    slowest rank's step p50/p99 (the first step left out), each rank's
    peak memory, the gradient all-reduce alone and the bytes a rank
    sends a step."""
    n = len(full)
    f0 = full[0]
    slow = [max(f["secs"][i] for f in full)
            for i in range(1, len(f0["secs"]))]
    q = _quant(slow)
    tokens = full_tz.batch * n * full_tz.seq
    ar_ms = _quant([max(f["ar_secs"][i] for f in full)
                    for i in range(len(f0["ar_secs"]))])[0] \
        if f0["ar_secs"] else 0.0
    sent = [int(np.mean(f["step_sent"])) if f["step_sent"] else 0
            for f in full]
    ar = (f"gradient all-reduce alone {ar_ms:.3f} ms "
          f"p50 over {RANK_GRAD_REPS} calls (the slowest rank's; "
          f"{f0['grad_bytes'] / 1e9:.3f} GB of float32 gradients), "
          f"{f0['ar_sent'] / 1e9:.3f} GB sent a rank a call "
          f"(COLLECTIVES: bytes x (N - 1))"
          if f0["ar_secs"] else "no gradient all-reduce on one rank")
    return (f"phase 12 {tag} train across {n} {backend} rank(s): "
            f"{f0['name']} "
            f"at full width, {f0['layers']} layers, {full_tz.steps} steps of "
            f"{full_tz.batch} x {full_tz.seq} tokens a rank "
            f"({full_tz.batch * n} rows in all) in {full_tz.microbatches} "
            f"microbatches at lr "
            f"{full_tz.lr}: losses {[round(x, 4) for x in f0['losses']]}, all "
            f"finite, every replica bitwise rank 0's after every step; "
            f"{tokens * len(slow) / sum(slow):.1f} trained tokens/s over all "
            f"ranks; step p50 {q[0]:.3f} ms, p99 {q[1]:.3f} ms (the slowest "
            f"rank's, the first step left out; rank 0's first "
            f"{f0['secs'][0] * 1e3:.3f} ms); peak max_memory_allocated a rank "
            f"{[round(f['peak'] / 2**30, 3) for f in full]} GiB (allocator "
            f"retries {[f['retries'] for f in full]}); {ar}; bytes "
            f"sent a rank a step {sent}; {card}")


# ---- phase 12 (vi)-(viii): MoE serving and training across ranks -----------

#: (vi) Mixtral-8x7B at full width cut to 8 of 32 layers (phase 6's
#: run), ``requests`` a rank (N x that in all), 64 prompt ids
#: teacher-forced and 32 generated: every decode step's N x 16 tokens
#: are one MoE group across the ranks.  Checked in float32 compute: in
#: bfloat16 a rank's GEMMs of 16 rows round otherwise than one card's of
#: 64, and greedy decoding carries that into other ids (on four H100s,
#: 189 of 2,048 ids off the card's picks on the ranks' own path, by up
#: to 0.15 of the largest logit); then timed in bfloat16 (phase 6's run)
RANK_MOE_SERVE = MIXTRAL_FULL._replace(compute="float32")
RANK_MOE_TIMED = MIXTRAL_FULL
#: (vii) Mixtral's widths cut to 2 layers (3.17 B parameters, 50.6 GB of
#: float32 AdamW state), float32 compute (TF32 off), (iv)'s 3 steps of 2
#: x 1,024 tokens a rank in 2 microbatches: a global microbatch's N x
#: 1,024 tokens are one MoE group, which spans every rank
RANK_MOE_CHECK = RANK_TRAIN_CHECK._replace(arch="mixtral_8x7b")
#: (viii) the same 2 layers, bfloat16 compute with float32 parameters,
#: (v)'s 8 steps of 2 x 4,096 tokens a rank in 2 microbatches: a rank's
#: 4,096 tokens a microbatch are a group of their own, and only the
#: expert ids and the load statistics cross the ranks
RANK_MOE_FULL = RANK_TRAIN_FULL._replace(layers=2, arch="mixtral_8x7b")
#: (vi), (vii) and (viii)'s sizes, as ``_rank_moe_phase`` takes them
RANK_MOE = (RANK_MOE_SERVE, RANK_MOE_TIMED, RANK_MOE_CHECK, RANK_MOE_FULL)
#: (vii)'s losses against one card's, relative: the ranks' aux-loss
#: shares and cross-entropy shares sum in another order than one card's
#: means (the grad norms and first gradients keep (iv)'s
#: :data:`TRAIN_CARD_VS_CPU`, the parameters :data:`RANK_TRAIN_PARAM`)
RANK_MOE_LOSS = 1e-6


@contextlib.contextmanager
def _moe_routes(model, inputs: bool = False):
    """Within the block, every call of ``model``'s MoE layers appends a
    record to the list the block gets: its tokens' top-k expert ids
    (``ids``, ``[tokens * k]``, token-major) and, with ``inputs``, the
    router's probabilities (``probs``, ``[tokens, E]``) and the layer's
    input (``h``, float32).  A forward hook: the calls Python runs (an
    eager step; a replayed graph runs none)."""
    from repro_torch.models import moe as M
    recs = []

    def hook(mod, args, result):
        h = args[0].reshape(-1, args[0].shape[-1])
        probs, _, ids = M.route(h[None], mod.p["router"], mod.cfg.top_k)
        rec = {"ids": ids.reshape(-1)}
        if inputs:
            rec.update(probs=probs[0], h=h.float())
        recs.append(rec)
    hooks = [layer.moe.register_forward_hook(hook) for layer in model.layers
             if getattr(layer, "moe", None) is not None]
    try:
        yield recs
    finally:
        for h in hooks:
            h.remove()


def _keep(cfg, dest: torch.Tensor) -> torch.Tensor:
    """Which of the choices ``dest`` (``[tokens * k]``, one call's whole
    batch) the layer keeps: its groups, capacity and plan."""
    from repro_torch.models import moe as M
    t = dest.numel() // cfg.top_k
    g = M._pick_groups(t)
    return M.dispatch_plan(dest.reshape(g, -1), cfg.num_experts,
                           M.capacity(cfg, t // g)).keep.reshape(-1)


def plan_differences(cfg, ids: list, n: int) -> tuple[int, int]:
    """Of the MoE calls whose expert ids ``ids`` holds (each over the
    global batch), (those whose plan keeps other choices than the plans
    each of ``n`` ranks would make of its own contiguous share, those
    whose plan drops a choice)."""
    differ = drop = 0
    for dest in ids:
        per = dest.numel() // n
        keep = _keep(cfg, dest)
        local = torch.cat([_keep(cfg, dest[r * per:(r + 1) * per])
                           for r in range(n)])
        differ += not torch.equal(keep, local)
        drop += not bool(keep.all())
    return differ, drop


def _late_moe_step(cfg, model, tok: torch.Tensor, caches, lengths,
                   split) -> tuple:
    """One more eager decode step of ``tok`` ``[b, 1]`` from ``caches``
    (written in place) under the batch split ``split`` (``None``: the
    whole batch): (its logits, float32, and each MoE layer's routing of
    these rows with probabilities and inputs, on the host)."""
    from repro_torch.launch import shardctx
    from repro_torch.models import transformer as T
    with torch.inference_mode(), shardctx.batch_split(split), \
            _moe_routes(model, inputs=True) as recs:
        logits, _, _ = T.decode_step(cfg, model, tok, caches, lengths)
    return logits.float().cpu(), [{k: v.cpu() for k, v in r.items()}
                                  for r in recs]


def rank_moe_serve(sz: ServeSizes, device, mesh) -> dict:
    """(vi) on one rank: the MoE model at ``sz`` through ``launch/serve``
    over ``mesh``'s N data ranks, ``sz.requests`` a rank of N x that
    many prompts, from seed 0's weights, the launch counts zeroed just
    before the run and read just after; then one late step
    (:func:`_late_moe_step`) of each request's next greedy id, under
    the batch split, as every rank takes it.  Returns the gathered ids,
    the next ids (gathered), this rank's final logits, its caches and
    lengths before the late step (on the host), its late logits and
    late routing, the launches, ``aot_cached`` and each step's
    seconds."""
    from repro_torch.launch import serve, shardctx
    from repro_torch.launch.mesh import all_gather, data_group, dp_size
    from repro_torch.models import transformer as T
    cfg = serve_config(sz)
    group = data_group(mesh)
    n = 1 if group is None else dp_size(mesh)
    model = T.init_params(cfg, seed=0, device=device)
    zero_launches()
    res = serve.run(cfg, sz.requests * n, sz.prompt_len, sz.tokens,
                    device=device, model=model, mesh=mesh)
    launches = read_launches()
    generic = _wrappers()["decode_attn"].generic_launches
    nxt = torch.argmax(res.logits, dim=-1).to(torch.int32)
    every = nxt if group is None else all_gather(nxt, group).reshape(-1)
    caches = [{k: v.cpu() for k, v in c.items()} for c in res.caches]
    late, routes = _late_moe_step(cfg, res.model, nxt[:, None], res.caches,
                                  res.lengths, shardctx.mesh_split(mesh))
    return dict(tokens=res.tokens, next=every.cpu(),
                logits=res.logits.float().cpu(), caches=caches,
                lengths=res.lengths.cpu(), late=late, routes=routes,
                rows=(res.rows.start, res.rows.stop), launches=launches,
                loop_launches=res.launches, generic=generic,
                n_attn=len(attn_caches(cfg, res.caches)),
                aot_cached=res.aot_cached, secs=res.secs, finite=res.finite,
                name=cfg.name)


def phase12_moe_reference(sz: ServeSizes, device, runs: list) -> dict:
    """(vi)'s reference, in this process after the ranks (``runs``: each
    rank's :func:`rank_moe_serve`): one card serving all N x
    ``sz.requests`` prompts in one run from seed 0's weights, each
    prompt followed by the ranks' generated ids teacher-forced, so that
    the card takes the ranks' path: at each step where the ranks
    generated an id, the card's greedy pick and the margin of its
    largest logit over that id's; the final logits.  Eager
    (``capture.disable``) so that a hook reads every MoE call's expert
    ids: the calls whose plan of the whole batch differs from the
    per-rank plans, and those that drop a choice
    (:func:`plan_differences`).  Then the late step
    (:func:`_late_moe_step`) from the ranks' own caches and next ids,
    stacked in rank order: the inputs the ranks' late step took, bit
    for bit.  Freed after."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.runtime import capture
    cfg = serve_config(sz)
    n, tokens = len(runs), runs[0]["tokens"]
    model = T.init_params(cfg, seed=0, device=device)
    prompts = serve.prompts_for(cfg, sz.requests * n, sz.prompt_len)
    forced = torch.as_tensor(tokens, device=device).long()
    picks, margins, scales = [], [], []
    real = T.decode_step

    def decode_step(*args, **kw):   # the ranks' step j follows prompt id
        out = real(*args, **kw)     # P - 1 + j
        j = int(args[4][0]) - (sz.prompt_len - 1)
        if 0 <= j < sz.tokens:
            logits = out[0].float()
            top = logits.max(-1)
            picks.append(top.indices)
            margins.append(top.values - logits.gather(
                1, forced[:, j:j + 1])[:, 0])
            scales.append(logits.abs().max())
        return out
    T.decode_step = decode_step
    try:
        with capture.disable(), _moe_routes(model) as recs:
            res = serve.run(cfg, sz.requests * n,
                            sz.prompt_len + sz.tokens, 0, device=device,
                            model=model, prompts=np.concatenate(
                                [prompts, tokens], axis=1))
    finally:
        T.decode_step = real
    stacked = [{k: torch.cat([r["caches"][i][k] for r in runs]).to(device)
                for k in c} for i, c in enumerate(runs[0]["caches"])]
    late, routes = _late_moe_step(
        cfg, res.model, runs[0]["next"].to(device)[:, None], stacked,
        torch.cat([r["lengths"] for r in runs]).to(device), None)
    differ, drop = plan_differences(cfg.moe, [r["ids"] for r in recs], n)
    out = dict(forced=tokens, picks=torch.stack(picks, 1).cpu(),
               margins=torch.stack(margins, 1).cpu(),
               scales=torch.stack(scales).cpu(),
               logits=res.logits.float().cpu(), late=late, routes=routes,
               calls=len(recs), differing=differ, dropping=drop,
               moe=cfg.moe, name=cfg.name)
    del model, res, recs, stacked
    if torch.device(device).type == "cuda":
        _free()
    return out


def moe_serve_stats(ref: dict, runs: list) -> dict:
    """(vi)'s comparison of the ranks (``runs``: each rank's
    :func:`rank_moe_serve`) with one card (:func:`phase12_moe_reference`),
    checking nothing: ``ties``, the generated ids the card would not
    pick, each a (request, step, margin over the largest logit);
    ``final``, each rank's final logits' largest difference over the
    largest; and the late step, which both sides took from the ranks'
    caches, by :func:`late_step`'s rule: ``flips``,
    the requests whose own expert choice differs in some MoE layer
    (the first such layer, its input's difference over its largest,
    the card's router margin there), ``moved``, those whose kept
    choices differ only because another request's did, and ``late``,
    the logits' difference over the other requests."""
    ids = torch.from_numpy(runs[0]["tokens"]).long()
    off = ref["picks"] != ids
    rel = ref["margins"] / ref["scales"][None, :]
    ties = [(int(i), int(j), float(rel[i, j]))
            for i, j in off.nonzero().tolist()]
    final = [_rel(g["logits"], ref["logits"][slice(*g["rows"])])
             for g in runs]
    cfg, k = ref["moe"], ref["moe"].top_k
    rows = ids.shape[0]
    flips, moved = {}, set()
    for layer, want in enumerate(ref["routes"]):
        got = {key: torch.cat([g["routes"][layer][key] for g in runs])
               for key in ("ids", "probs", "h")}
        mine = (got["ids"] != want["ids"]).reshape(rows, k).any(1)
        for i in mine.nonzero()[:, 0].tolist():
            if i not in flips:
                top = torch.sort(want["probs"][i], descending=True).values
                flips[i] = dict(request=i, layer=layer,
                                input=_rel(got["h"][i], want["h"][i]),
                                margin=float(top[k - 1] - top[k]))
        kept = (_keep(cfg, got["ids"]) != _keep(cfg, want["ids"])) \
            .reshape(rows, k).any(1)
        moved |= set(kept.nonzero()[:, 0].tolist()) - set(flips)
    same = torch.ones(rows, dtype=torch.bool)
    same[list(flips) + list(moved)] = False
    late = _rel(torch.cat([g["late"] for g in runs])[same],
                ref["late"][same]) if same.any() else float("nan")
    return dict(ties=ties, generated=int(ids.numel()), final=final,
                flips=list(flips.values()), moved=sorted(moved),
                late=late, rows=rows)


def check_moe_serve(tag: str, ref: dict, runs: list, sz: ServeSizes,
                    launches: bool = True) -> dict:
    """An MoE model served over the ranks against one card serving the
    whole batch on the ranks' path (:func:`moe_serve_stats`), each check
    failing the run: over N > 1 ranks some MoE call's global plan
    differs from the per-rank plans (else nothing is tested); every
    rank holds the same gathered ids; every generated id is the card's
    greedy pick or a near tie, its logit within
    :data:`SERVE_KERNEL_VS_PLAIN` of the largest logit below the card's
    pick (each rank's GEMMs take its rows alone and round otherwise
    than the whole batch's); at the late step, by
    :func:`late_step`'s rule, each request whose expert choice flipped
    a near tie (its MoE input within the tolerance), not every request
    left out, and the other requests' logits within the tolerance; each
    rank's final logits within it of the card's on the same path;
    :func:`_check_serve_run`.  Returns the stats."""
    n = len(runs)
    if n > 1 and ref["differing"] == 0:
        _fail(f"phase 12 {tag}: at none of the {ref['calls']} MoE calls "
              f"does the plan of the {n * sz.requests} requests differ from "
              f"the {n} per-rank plans: the check tests nothing")
    first = runs[0]
    for r, got in enumerate(runs):
        if got["tokens"].shape != (n * sz.requests, sz.tokens) \
                or not (got["tokens"] == first["tokens"]).all() \
                or not torch.equal(got["next"], first["next"]):
            _fail(f"phase 12 {tag}: rank {r}'s gathered ids "
                  f"{got['tokens'].shape} differ from rank 0's")
        _check_serve_run(tag, r, got, sz, launches)
    if not (first["tokens"] == ref["forced"]).all():
        _fail(f"phase 12 {tag}: the card's reference followed other ids "
              f"than the ranks generated")
    st = moe_serve_stats(ref, runs)
    far = [t for t in st["ties"] if t[2] > SERVE_KERNEL_VS_PLAIN]
    if far:
        _fail(f"phase 12 {tag}: {len(far)} generated id(s) one card serving "
              f"all {n * sz.requests} requests on the ranks' path would not "
              f"pick, by more than a near tie (request, step, margin over "
              f"the largest logit; > {SERVE_KERNEL_VS_PLAIN}): {far[:6]}")
    bad = [f for f in st["flips"] if f["input"] > SERVE_KERNEL_VS_PLAIN]
    if bad or len(st["flips"]) + len(st["moved"]) == st["rows"]:
        _fail(f"phase 12 {tag}: at the late step the expert choices of "
              f"requests {[f['request'] for f in st['flips']]} differ from "
              f"one card's (those whose MoE input differs by more than "
              f"{SERVE_KERNEL_VS_PLAIN}: {bad[:4]}), and the kept choices "
              f"of {st['moved']}")
    if not st["late"] <= SERVE_KERNEL_VS_PLAIN \
            or max(st["final"]) > SERVE_KERNEL_VS_PLAIN:
        _fail(f"phase 12 {tag}: the late step's logits differ from one "
              f"card's by {st['late']:.3e} of the largest over the requests "
              f"whose routing agrees, each rank's final logits by "
              f"{st['final']} (tolerance {SERVE_KERNEL_VS_PLAIN})")
    return st


def check_phase12_moe(ref: dict, parts: list, sz: ServeSizes,
                      timed_sz: ServeSizes, launches: bool = True) -> dict:
    """(vi)-(viii) on every rank, each check failing the run: (vi)
    :func:`check_moe_serve`, and the timed run's ids gathered alike on
    every rank and :func:`_check_serve_run`; (vii) rank 0's losses within
    :data:`RANK_MOE_LOSS` of one card's, its grad norms and first
    gradients within :data:`TRAIN_CARD_VS_CPU`, its parameters within
    :data:`RANK_TRAIN_PARAM`; (vii) and (viii) every replica bitwise
    rank 0's after every step (:func:`_check_replicas`), every loss
    finite.  Returns (vi)'s stats (:func:`moe_serve_stats`)."""
    n = len(parts)
    out = check_moe_serve("(vi)", ref, [p["moe_serve"] for p in parts], sz,
                          launches)
    for r, p in enumerate(parts):
        got = p["moe_timed"]
        if got["gathered"] != parts[0]["moe_timed"]["gathered"] \
                or got["shape"] != (n * timed_sz.requests, timed_sz.tokens):
            _fail(f"phase 12 (vi) timed: rank {r}'s gathered ids "
                  f"{got['shape']} differ from rank 0's")
        _check_serve_run("(vi) timed", r, got, timed_sz, launches)
    check = parts[0]["moe_check"]
    if check["losses_err"] > RANK_MOE_LOSS \
            or check["loss_err"] > TRAIN_CARD_VS_CPU \
            or check["grad_err"] > TRAIN_CARD_VS_CPU \
            or check["param_err"] > RANK_TRAIN_PARAM:
        _fail(f"phase 12 (vii): {n} rank(s) against one card: losses "
              f"{check['losses']} vs {check['one_losses']} (within "
              f"{check['losses_err']:.3e} relative, tolerance "
              f"{RANK_MOE_LOSS}; with the grad norms "
              f"{check['loss_err']:.3e}), the first step's gradients "
              f"within {check['grad_err']:.3e} of each leaf's largest "
              f"(tolerance {TRAIN_CARD_VS_CPU}), the parameters within "
              f"{check['param_err']:.3e} (tolerance {RANK_TRAIN_PARAM})")
    for tag, key in (("(vii)", "moe_check"), ("(viii)", "moe_full")):
        runs = [p[key] for p in parts]
        if not np.isfinite(runs[0]["losses"]).all():
            _fail(f"phase 12 {tag}: non-finite losses {runs[0]['losses']}")
        _check_replicas(tag, runs)
    return out


def print_phase12_moe(ref: dict, parts: list, got: dict, sz: ServeSizes,
                      timed_sz: ServeSizes, check_tz: TrainSizes,
                      full_tz: TrainSizes, card: str) -> dict:
    """(vi)-(viii)'s lines, each with the card's name and power limit.
    Returns (vi)'s launch totals over the ranks for the kernels line."""
    n = len(parts)
    backend = parts[0]["backend"]
    sv = [p["moe_serve"] for p in parts]
    tv = [p["moe_timed"] for p in parts]
    steps = len(tv[0]["secs"])
    slow = [max(s["secs"][i] for s in tv) for i in range(steps)]
    q, q0 = _quant(slow), _quant(parts[0]["moe_timed_here"])
    flips = [(f["request"], f["layer"], f"{f['input']:.2e}",
              f"{f['margin']:.2e}") for f in got["flips"][:4]]
    print(f"phase 12 (vi) MoE serve across {n} {backend} rank(s): "
          f"{sv[0]['name']} at full width, {sz.layers} layers, "
          f"{sz.compute}, {sz.requests} requests a rank ({n * sz.requests} "
          f"in all), {sz.prompt_len} prompt ids teacher-forced + "
          f"{sz.tokens} generated, every MoE layer planning over all "
          f"{n * sz.requests} requests, against one card serving all of them "
          f"in one run on the ranks' path (their ids teacher-forced): the "
          f"card's greedy pick at {got['generated'] - len(got['ties'])} of "
          f"the {got['generated']} generated ids, near ties at the rest "
          f"(largest margin "
          f"{max([t[2] for t in got['ties']], default=0.0):.3e} of the "
          f"largest logit, tolerance {SERVE_KERNEL_VS_PLAIN}; (request, "
          f"step) {[t[:2] for t in got['ties'][:8]]}); final logits within "
          f"{[f'{x:.3e}' for x in got['final']]} of the largest by rank; "
          f"a late step from the ranks' own caches: {len(got['flips'])} "
          f"request(s) flipped an expert choice ((request, layer, MoE input "
          f"apart, router margin) {flips}), {len(got['moved'])} kept other "
          f"choices because of them, the rest's logits within "
          f"{got['late']:.3e}; MoE calls (layer-steps) whose global plan's "
          f"kept set differs from the per-rank plans' {ref['differing']} of "
          f"{ref['calls']} ({ref['dropping']} drop a choice); decode_attn "
          f"{[s['loop_launches'] for s in sv]} loop launches a rank "
          f"({sv[0]['n_attn']} a step, {[s['generic'] for s in sv]} "
          f"generic); {card}")
    print(f"phase 12 (vi) MoE serve timed across {n} {backend} rank(s): "
          f"the same in {timed_sz.compute}: aot_cached 1 on every rank; "
          f"decode_attn {[s['loop_launches'] for s in tv]} loop launches a "
          f"rank ({tv[0]['n_attn']} a step, {[s['generic'] for s in tv]} "
          f"generic), armatch {[s['launches']['armatch'] for s in tv]} a "
          f"rank; {n * timed_sz.requests * steps / sum(slow):.1f} tokens/s "
          f"over all ranks; step p50 {q[0]:.3f} ms, p99 {q[1]:.3f} ms (the "
          f"slowest rank's; one card serving {timed_sz.requests} requests "
          f"alone in rank 0's process p50 {q0[0]:.3f} ms, p99 "
          f"{q0[1]:.3f} ms); {card}")
    c = parts[0]["moe_check"]
    print(f"phase 12 (vii) MoE train across {n} {backend} rank(s): "
          f"{check_tz.arch}'s widths at {check_tz.layers} layers, "
          f"{check_tz.compute} (TF32 off), {check_tz.steps} steps of "
          f"{check_tz.batch * n} x {check_tz.seq} tokens ({check_tz.batch} "
          f"rows a rank) in {check_tz.microbatches} microbatches at lr "
          f"{check_tz.lr}, one MoE group a microbatch across the ranks: "
          f"losses {c['losses']} against one card's {c['one_losses']} "
          f"(within {c['losses_err']:.3e} relative, tolerance "
          f"{RANK_MOE_LOSS}; with the grad norms {c['loss_err']:.3e}), the "
          f"first step's gradients within {c['grad_err']:.3e} of each "
          f"leaf's largest (tolerance {TRAIN_CARD_VS_CPU}), the parameters "
          f"after {check_tz.steps} steps within {c['param_err']:.3e} "
          f"(tolerance {RANK_TRAIN_PARAM}); every replica's parameters and "
          f"moments bitwise rank 0's after every step; {card}")
    print(_train_full_line("(viii) MoE", [p["moe_full"] for p in parts],
                           full_tz, backend, card))
    return {name: sum(s["launches"][name] for s in sv + tv)
            for name in ("decode_attn", "armatch")}


def phase12_mesh(n: int) -> tuple:
    """The AR exchange's and the all-reduce's ``(pod, data)`` mesh of
    ``n`` ranks: two pods from 2 ranks on."""
    return (2, n // 2) if n >= 2 else (1, 1)


def phase12_references(sz: Sizes, fz: FleetSizes, device, n: int,
                       n_ar: int, smoke: bool = False) -> dict:
    """What phase 12's ranks are held to, computed in this process on
    one device: the fleet fused and staged on one card, the stacked
    one-card form of every rank's first two AR steps, and the dim-0
    all-reduce of each data column's pods."""
    from repro_torch.core import routing, sfc
    from repro_torch.runtime import compression
    pod_data = phase12_mesh(n)
    device = torch.device(device)
    out = {name: rank_fleet(sz, fz, device, fused)
           for name, fused in (("fused", True), ("staged", False))}
    if device.type == "cuda":
        _free()
    out["control_refs"] = phase12_control_references(sz, fz, device)
    plane = rank_ar_plane(n_ar, pod_data, device)
    out["ar"] = []
    for step in range(2):
        feeds = [rank_ar_feed(plane, r, step) for r in range(n)]
        idx = torch.stack([sfc.profile_index(k) for k, _ in feeds])
        recv, counts = routing.route_and_deliver(
            torch.stack([p for _, p in feeds]), idx, plane.table, n,
            plane.capacity)
        out["ar"].append([(_digest(recv[r]), _digest(counts[r]),
                           counts[r].cpu().tolist()) for r in range(n)])
    del feeds, idx, recv, counts, plane
    out["allreduce"] = {}
    pods, cols = pod_data
    for d in range(cols):
        trees = [rank_grads(p * cols + d, device, smoke)
                 for p in range(pods)]
        g = {k: torch.stack([t[k] for t in trees]) for k in trees[0]}
        del trees
        synced, errs = compression.cross_pod_allreduce(
            g, compression.init_errors(g))
        for p in range(pods):
            out["allreduce"][p * cols + d] = {
                k: (_digest(synced[k][p]), _digest(errs[k][p]))
                for k in sorted(g)}
        del g, synced, errs
    if device.type == "cuda":
        _free()
    return out


def check_phase12(refs: dict, parts: list, fz: FleetSizes, n_ar: int,
                  launches: bool = True) -> int:
    """Every rank against the references (:func:`phase12_references`):
    the fleet fused (graphed and eager) and staged, the AR exchange's
    two checked steps, the all-reduce, the backend; with ``launches``,
    fused_tick ``S / N`` and window_reduce ``5 S / N`` launches a tick
    and hilbert once an AR step on every rank; then (i) and (ii)
    (:func:`check_phase12_control`).  Returns the posts kept at the
    first AR step and what :func:`check_phase12_control` returns."""
    n = len(parts)
    for name in ("fused", "staged"):
        _check_rank_fleet(name, refs[name], [p[name] for p in parts])
    _check_rank_fleet("fused eager", refs["fused"],
                      [p["fused_eager"] for p in parts], counted=False)
    per = fz.shards // n
    for p in parts:
        r = p["rank"]
        for step, (got, want) in enumerate(zip(p["ar"], refs["ar"])):
            if got != want[r]:
                _fail(f"phase 12: rank {r}'s AR exchange at step {step} "
                      "differs from the stacked form")
        if p["allreduce"] != refs["allreduce"][r]:
            _fail(f"phase 12: rank {r}'s all-reduce differs from the "
                  "dim-0 form")
        if not launches:
            continue
        if p["backend"] != "nccl":
            _fail(f"phase 12: rank {r} ran {p['backend']}")
        fl, st = p["fused"]["launches"], p["staged"]["launches"]
        if fl["fused_tick"] != per * RANK_TICKS or fl["window_reduce"]:
            _fail(f"phase 12: rank {r} launched {fl}; want fused_tick "
                  f"{per} a tick")
        if st["window_reduce"] != 5 * per * RANK_TICKS or st["fused_tick"]:
            _fail(f"phase 12: rank {r} staged launched {st}; want "
                  f"window_reduce {5 * per} a tick")
        if p["ar_launches"]["hilbert"] != RANK_AR_STEPS:
            _fail(f"phase 12: rank {r} AR launched {p['ar_launches']}; "
                  "want hilbert once a step")
    kept = sum(sum(p["ar"][0][2]) for p in parts)
    if not 0 < kept <= n * n_ar:
        _fail(f"phase 12: the AR exchange kept {kept} posts")
    return kept, check_phase12_control(refs["control_refs"], parts, fz,
                                       launches)


def run_ranks_phase(sz: Sizes, fz: FleetSizes, device, rows: list,
                    n_ar: int | None = None) -> None:
    """Phase 12: the one-card references in this process, then one rank a
    card (NCCL, :func:`phase12_ranks`) through ``launch.mesh.spawn``
    running :func:`_rank_phase`; every check fails the run.  The ranks'
    launch counts join the kernels line as ``rank_launches``."""
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    n = phase12_ranks()
    pod_data = phase12_mesh(n)
    n_ar = AR_FULL.n if n_ar is None else n_ar
    card = _card_line()
    refs = phase12_references(sz, fz, device, n, n_ar)
    refs["models"] = phase12_model_references(RANK_SERVE, device, n)
    _DIGEST_W.clear()               # card 0's memory for its rank
    _free()
    t_ref = time.perf_counter() - t0
    parts = M.spawn(_rank_phase, n, "cuda", sz, fz, n_ar, pod_data, False,
                    (RANK_SERVE, RANK_TRAIN_CHECK, RANK_TRAIN_FULL,
                     RANK_MOE))
    t_ranks = time.perf_counter() - t0 - t_ref
    kept, ctl = check_phase12(refs, parts, fz, n_ar)
    models = [p["models"] for p in parts]
    check_phase12_models(refs["models"], models, RANK_SERVE)
    refs["moe"] = phase12_moe_reference(           # on the ranks' path
        RANK_MOE_SERVE, device, [p["moe_serve"] for p in models])
    moe = check_phase12_moe(refs["moe"], models, *RANK_MOE[:2])
    per = fz.shards // n
    print(f"phase 12 ranks: {n} NCCL rank(s), one a card ({parts[0]['card']}"
          f"), started by launch.mesh.spawn over a FileStore; fleet mesh "
          f"{parts[0]['fleet_mesh']} (region, edge), {per} shards a rank; "
          f"AR and all-reduce mesh {pod_data} (pod, data); references on "
          f"one card {t_ref:.1f} s, ranks {t_ranks:.1f} s; {card}")
    for name in ("fused", "staged"):
        runs = [p[name] for p in parts]
        q = _quant([max(r["secs"][i] for r in runs)
                    for i in range(1, RANK_TICKS)])
        busy = runs[0]["prof"]["busy_share"]
        print(f"phase 12 fleet {name}: {fz.shards} shards, {RANK_TICKS} "
              f"ticks (a health and a membership flip, both budgets cut "
              f"after the capture) across {n} rank(s) == one card bitwise "
              f"(every output row, the final state, the lineage banks, the "
              f"counters)" + (", graphed == eager" if name == "fused"
                              else "")
              + f"; trace_count 1, _compile_count 1 on every rank; tick "
              f"p50 {q[0]:.3f} ms, p99 {q[1]:.3f} ms (the slowest rank's, "
              f"the capture tick left out; one card "
              f"{_quant(refs[name]['secs'][1:])[0]:.3f} ms); "
              + f"busy {busy:.4f} of rank 0's profiled wall time; "
              f"{runs[0]['sent']:.0f} bytes sent a rank a tick; launches "
              f"a rank {[_nonzero(r['launches']) for r in runs]}; {card}")
    q = _quant([max(p["ar_secs"][i] for p in parts)
                for i in range(RANK_AR_STEPS)])
    print(f"phase 12 AR exchange: {n_ar} posts a rank a step routed over "
          f"{n} rank(s) (capacity {RANK_AR_FACTOR * n_ar // n} a pair) == "
          f"the stacked one-card form bitwise over 2 steps, {kept} posts "
          f"kept at step 0; step p50 {q[0]:.3f} ms, p99 {q[1]:.3f} ms; busy "
          f"{parts[0]['ar_prof']['busy_share']:.4f}; "
          f"{parts[0]['ar_sent']:.0f} bytes sent a rank a step; hilbert "
          f"{[p['ar_launches']['hilbert'] for p in parts]}; {card}")
    q = _quant([max(p["allreduce_secs"][i] for p in parts)
                for i in range(RANK_ALLREDUCE_REPS)])
    print(f"phase 12 all-reduce: one Yi-6B layer's gradients "
          f"({parts[0]['allreduce_bytes'] / 2**20:.1f} MiB float32) a rank "
          f"over {pod_data[0]} pod(s) == the dim-0 form bitwise; call p50 "
          f"{q[0]:.3f} ms, p99 {q[1]:.3f} ms; busy "
          f"{parts[0]['allreduce_prof']['busy_share']:.4f}; "
          f"{parts[0]['allreduce_sent']:.0f} bytes sent a rank a call; "
          f"{card}")
    print_phase12_control(refs["control_refs"], parts, ctl, card)
    totals = {"fused_tick": sum(p["fused"]["launches"]["fused_tick"]
                                for p in parts)
              + ctl["launches"]["control"] + ctl["launches"]["remesh"],
              "window_reduce": sum(p["staged"]["launches"]["window_reduce"]
                                   for p in parts),
              "hilbert": sum(p["ar_launches"]["hilbert"] for p in parts)}
    totals.update(print_phase12_models(refs["models"], models, RANK_SERVE,
                                       RANK_TRAIN_CHECK, RANK_TRAIN_FULL,
                                       card))
    for name, count in print_phase12_moe(refs["moe"], models, moe,
                                         *RANK_MOE, card).items():
        totals[name] += count
    seen = set()
    for row in rows:
        name = row["name"]
        if name in totals and name not in seen:
            seen.add(name)
            row["rank_launches"] = totals[name]
            row["rank_count"] = n
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")


def print_phase12_control(refs: dict, parts: list, ctl: dict,
                          card: str) -> None:
    """(iii): the controller tick's p50/p99 across the ranks (the
    slowest rank's) beside one card's, each remesh's wall ms (the
    slowest rank's) and the bytes each rank sent in it, the rank count,
    the backend and the card."""
    n = len(parts)
    runs = [p["control"] for p in parts]
    q = _quant([max(c["ctl_s"][i] for c in runs)
                for i in range(len(runs[0]["ctl_s"]))])
    q1 = _quant(refs["control"]["ctl_s"])
    print(f"phase 12 (i) controlled fleet across {n} {parts[0]['backend']} "
          f"rank(s): phase 8's arc (shard {CONTROL_FAULT[0]} stalled, shard "
          f"{CONTROL_CHURN[0]} away with its carry handed to backup "
          f"{ctl['backup']} and back, budgets pinned) fused and graphed, "
          f"{ctl['ticks']} ticks under a FleetController without "
          f"step_times: every ControlDecision equal on every rank and to "
          f"one card's ({ctl['health']} health changes, shard "
          f"{CONTROL_FAULT[0]} flagged on {ctl['flagged']} ticks), rank 0's "
          f"event log equal, every output row, the final state, the lineage "
          f"banks and the counters bitwise; trace_count "
          f"{[c['trace'] for c in runs]} <= max_trace_count "
          f"{[c['bound'] for c in runs]}; FleetController.tick p50 "
          f"{q[0]:.3f} ms, p99 {q[1]:.3f} ms across the ranks (one card "
          f"p50 {q1[0]:.3f} ms, p99 {q1[1]:.3f} ms); fused_tick "
          f"{ctl['launches']['control']} launches over the ranks; {card}")
    rem = [p["remesh"] for p in parts]
    steps = []
    for k, ((width, _), ranks) in enumerate(zip(REMESH_WIDTHS,
                                                remesh_rank_sets(n))):
        ms = max(c["remesh"][k][0] for c in rem) * 1e3
        one_ms = refs["remesh"]["remesh"][k][0] * 1e3
        steps.append(f"to {width} shards on ranks {list(ranks)} "
                     f"{ms:.1f} ms (one card {one_ms:.1f} ms), bytes sent "
                     f"a rank {[int(c['remesh'][k][1]) for c in rem]}")
    print(f"phase 12 (ii) remesh across {n} {parts[0]['backend']} rank(s): "
          f"{'; '.join(steps)}; {ctl['payload']} departed rows requeued "
          f"through the injector on every rank, {REMESH_TICKS} ticks at "
          f"each width == one card bitwise (decisions, outputs, payloads, "
          f"final state, lineage, counters), ranks idle outside the fleet "
          f"{ctl['idle']}; fused_tick {ctl['launches']['remesh']} launches "
          f"over the ranks; {card}")


def run_phase12_alone(device="cuda") -> dict:
    """Phase 1's build and phase 12 alone (``--phase12``: the run on four
    cards); the kernels line holds the five kernels phase 12 drives."""
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"phase 1 build: {len(build.SOURCES)} kernels ready in "
          f"{time.perf_counter() - t0:.2f} s ({build.builds} compiled)")
    print(f"card: {_card_line()}")
    rows = [{"name": k} for k in ("fused_tick", "window_reduce", "hilbert",
                                  "decode_attn", "armatch")]
    run_ranks_phase(FULL, FLEET, device, rows)
    return {"kernels": rows}


def main(argv: list | None = None) -> int:
    """The smoke run; ``argv`` ``["--phase12"]``: phase 12 alone."""
    args = list(argv or [])
    if args not in ([], ["--phase12"]):
        print("usage: chip_smoke.py [--phase12]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        kernels = run_phase12_alone() if args else run()
    except Exception:                   # any failed check: no result line
        traceback.print_exc()
        return 1
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
