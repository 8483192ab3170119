"""Edge-fleet stream analytics on PyTorch: many bridges, one core tier.

The twin of ``fleet_stream_analytics.py`` over ``repro_torch``: 8
bridges each stream acceleration tuples to their own edge RP.  The
reference lays the bridges over an 8-device mesh; here they are 8
shards of one fleet tick on one card (rows of the state, a compile-once
step, a CUDA graph on the card): per-bridge ingest, windows (the
``window_reduce`` kernel) and rules, then every rule-escalated window
crosses to the 2 core ranks, where the damage model runs under a
*fleet-level* budget: when a regional quake lights up several bridges
at once, the first ``CORE_BUDGET`` windows (shard-major order) get core
compute and the rest keep their edge results.

A lagging bridge (delayed uplink) also holds the fleet watermark back.
The adaptive control plane rides on top: a ``FleetController`` grows
the core budget while the quake escalations burst (and shrinks it
after); when bridge 6's uplink dies mid-run the straggler detectors
exclude it from the watermark, its buffered tuples drain through the
catch-up path on recovery (counted in ``late_excluded``, never
dropped), and it rejoins once the backlog drains.  Bridge 4's RP is
decommissioned mid-run (``Churn``): ``FleetController.leave`` picks the
backup bridge that replays its buffered batches, and a replacement
joins the slot later -- the whole arc on one signature.

With ``--ranks N`` (1, 2, 4 or 8) the 8 bridges run across N ranks, one
process a rank (``launch.mesh.spawn``: a card each, or gloo on the
CPU), each holding 8 / N of them; every rank runs the same controller
on the fleet-wide view, and the results are the one-rank run's.

    PYTHONPATH=src python examples/fleet_stream_analytics_torch.py \\
        [--device cpu] [--ranks N]
"""
import argparse
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pipeline as pipe
from repro_torch.launch import mesh as M
from repro_torch.core import rules
from repro_torch.obs import SLO, EventLog, Tracer
from repro_torch.runtime.elastic import ElasticBudget
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.stream import StreamConfig
from repro_torch.stream.fleet import (Churn, Fault, FaultInjector,
                                      FaultSchedule, FleetConfig,
                                      FleetController, FleetExecutor)
from repro_torch.stream.fleet.executor import rank_mesh

E = 8              # bridges (edge shards)
D = 3              # accel_rms, strain, temperature
BATCH = 64         # tuples per bridge per micro-batch
STEPS = 36
QUAKE = range(12, 18)          # steps during which the burst happens
HIT = (2, 3, 4, 5)             # bridges in the affected region
CORE_BUDGET = 6                # initial fleet-wide core windows / tick
DEAD = Fault(shard=6, start=20, end=26)     # bridge 6's uplink dies
GONE = Churn(shard=4, leave=22, join=30)    # bridge 4's RP decommissioned


def edge_fn(params, batch):
    return batch, batch[:, :5]


def core_fn(params, batch):
    h = batch
    for _ in range(16):
        h = torch.tanh(h @ params)
    return h, batch[:, :5]


def main(device=None, ranks: int = 1) -> dict:
    """Runs the fleet on ``device`` (``None``: the card), across
    ``ranks`` processes when more than one; returns the fleet's counters
    and each tick's escalations and budget (rank 0's, the same on every
    rank)."""
    if ranks == 1:
        return run(resolve_device(device))
    dev_type = "cuda" if device is None else torch.device(device).type
    return M.spawn(_rank, ranks, dev_type)[0]


def _rank(rank: int, device) -> dict:
    """One rank of :func:`main`: the run over the ranks' fleet mesh, only
    rank 0 printing."""
    return run(device, across_ranks=True, say=print if rank == 0
               else (lambda *a, **k: None))


def run(dev, across_ranks: bool = False, say=print) -> dict:
    """The example's run on ``dev``; ``across_ranks``: its bridges laid
    over the process group's ranks (:func:`main` starts them)."""
    # tumbling windows: bridge 4's batches replay on a foreign bridge,
    # and batch-granular replay needs stride == window (the executor
    # enforces it — a sliding carry would smear two bridges' tuples
    # into one window; see stream README "Shard churn")
    scfg = StreamConfig(micro_batch=BATCH, window=32, stride=32,
                        capacity=8 * BATCH, lateness=16.0)
    engine = rules.RuleEngine([
        rules.threshold_rule("burst", 1, ">=", 3.0, rules.C_SEND_CORE,
                             priority=2),
        rules.threshold_rule("thin_window", 4, "<", 8.0,
                             rules.C_STORE_EDGE, priority=1),
    ])
    core_p = torch.as_tensor(
        np.random.default_rng(0).standard_normal((5 + D, 5 + D)) * 0.2,
        dtype=torch.float32, device=dev)
    pl = pipe.two_tier_pipeline(edge_fn, core_fn, engine,
                                core_params=core_p)
    cfg = FleetConfig(stream=scfg, num_shards=E, num_core=2,
                      core_budget=CORE_BUDGET, core_budget_max=16)
    ex = FleetExecutor(cfg, engine, pl, device=dev,
                       mesh=rank_mesh(cfg, dev) if across_ranks else None)
    # this rank's bridges (all 8 on one rank)
    rows = slice(ex.shard_offset, ex.shard_offset + ex.local_shards)
    # full observability rides along: host spans + device named scopes
    # via the tracer, every control-plane decision in the event log
    # (JSONL to $REPRO_OBS_EVENTS if set, in-memory otherwise)
    tracer = Tracer()
    log = EventLog(os.environ.get("REPRO_OBS_EVENTS") if say is print
                   else None)
    ex.set_tracer(tracer)
    # ... plus a declared SLO: 95% of end-to-end window latencies
    # under 50 ms, burn-rate-alerted (breach/recover transitions land
    # in the event log; the level rides ControlDecision.slo_breached)
    ctl = FleetController(
        ex,
        budget_policy=ElasticBudget(min_budget=2, max_budget=32,
                                    patience=2),
        wall_detector=StragglerDetector(E, window=3, threshold=3.0,
                                        patience=2),
        event_log=log, tracer=tracer,
        slos=(SLO("e2e-50ms", target_seconds=50e-3, stage="e2e",
                  objective=0.95, fast_window=3, slow_window=10,
                  burn_threshold=2.0),))
    sched = FaultSchedule([DEAD], churn=[GONE])
    inj = FaultInjector(sched, event_log=log)
    state = ex.init_state(D)

    rng = np.random.default_rng(42)
    t0, backups, ticks = 0.0, {}, []
    for step in range(STEPS):
        if step == GONE.leave:
            backup = ctl.leave(GONE.shard)
            backups = {GONE.shard: backup}
            say(f"step {step:2d}: bridge {GONE.shard} decommissioned; "
                  f"bridge {backup} replays its buffered batches")
        if step == GONE.join:
            ctl.join(GONE.shard)
            say(f"step {step:2d}: replacement RP joined at slot "
                  f"{GONE.shard}")
        accel = np.abs(rng.standard_normal((E, BATCH))) \
            .astype(np.float32) * 0.5
        if step in QUAKE:
            accel[HIT, :] += rng.gamma(4.0, 1.5, (len(HIT), BATCH)) \
                .astype(np.float32)
        items = np.stack(
            [accel, rng.standard_normal((E, BATCH)).astype(np.float32),
             np.full((E, BATCH), 21.5, np.float32)], axis=2)
        ts = np.tile(t0 + np.arange(BATCH, dtype=np.float32), (E, 1))
        # bridge 7's uplink lags: its tuples arrive one batch behind
        ts[7] -= BATCH
        t0 += BATCH
        # stalled uplink: tuples buffer at the bridge; recovered:
        # backlog drains oldest-first while fresh batches keep queueing;
        # decommissioned: the stream replays on the backup's uplink
        items, ts, offered, replay = inj.inject(step, items, ts,
                                                backups=backups)
        state, out = ex.step(state, items[rows], ts[rows],
                             offered=offered[rows], replay=replay[rows])
        dec = ctl.tick(state, step_times=sched.stall_time(step, E))
        out = ex.gather(out)            # every bridge's rows, on each rank
        esc = out.escalated.cpu().numpy()           # [E, NW]
        ticks.append({"escalated": int(esc.sum()), "budget": dec.budget,
                      "stragglers": list(dec.stragglers)})
        if esc.any() or dec.stragglers or dec.resized:
            hit = np.nonzero(esc.any(axis=1))[0]
            outs = out.outputs.cpu().numpy()
            cored = (np.abs(outs) <= 1.0).all(axis=-1) & esc  # tanh range
            note = f", excluded bridges {dec.stragglers}" \
                if dec.stragglers else ""
            say(f"step {step:2d}: bridges {hit.tolist()} escalated "
                  f"{int(esc.sum())} windows, core processed "
                  f"{int(cored.sum())} (budget {dec.budget})" + note)

    # the stream is over but bridge 6's buffered tail isn't: drain it
    # (plus a few quiet ticks) so every record is processed and the
    # bridge earns its way back into the watermark pmin
    step, quiet = STEPS, 0
    while inj.pending or quiet < 3:
        quiet = 0 if inj.pending else quiet + 1
        items, ts, offered, replay = inj.inject(
            step, np.zeros((E, BATCH, D), np.float32),
            np.zeros((E, BATCH), np.float32), fresh=False,
            backups=backups)
        state, out = ex.step(state, items[rows], ts[rows],
                             offered=offered[rows], replay=replay[rows])
        dec = ctl.tick(state, step_times=sched.stall_time(step, E))
        step += 1
    say(f"drained bridge {DEAD.shard}'s backlog by step {step}; "
          f"healthy again: {bool(dec.healthy[DEAD.shard])}")

    healthy = bool(dec.healthy[DEAD.shard])
    m = ex.gather(state.metrics).as_dict()   # one host pull of every counter
    f = m["fleet"]
    say(f"\nfleet: {f['items_offered']} tuples offered, "
          f"{f['items_late']} late-dropped, "
          f"{f['windows_emitted']} windows emitted")
    say(f"escalated {f['windows_escalated']} -> core processed "
          f"{sum(m['core_processed'])} on the core sub-mesh, "
          f"{m['fleet_core_overflow']} over budget kept edge results")
    say(f"per-bridge escalations: {m['shard']['windows_escalated']}")
    say(f"bridge {DEAD.shard} catch-up records past the fleet "
          f"watermark: {m['late_excluded'][DEAD.shard]} "
          f"(late-dropped: 0 — counted, not lost)")
    rep = m["shard"]["items_replayed"]
    say(f"bridge {GONE.shard}'s stream while decommissioned: "
          f"{sum(rep)} tuples replayed on bridge "
          f"{int(np.argmax(rep))} (lateness-exempt, never dropped)")
    say(f"final budget {ex.core_budget} after {ctl.resizes} elastic "
          f"resizes; fleet step traced {ex.trace_count} time(s) "
          f"(bound: {ctl.max_trace_count})")

    # the observability layer's view of the same run
    lat = ex.latency_percentiles()
    say(f"\nstep latency (in-step device histogram, {lat['count']} "
          f"samples): p50 {lat['p50_us']:.0f}us, p95 {lat['p95_us']:.0f}us,"
          f" p99 {lat['p99_us']:.0f}us")
    # record-level event-time lineage: every tuple stamped at ingest,
    # latency measured per stage on-device (same donated-histogram
    # trick — the trace bound above already covered it)
    lin = ex.lineage_percentiles()
    say("event-time lineage (per-stage p95):")
    for stage in ("queueing", "window", "hop1", "hop2", "e2e"):
        s = lin[stage]
        say(f"  {stage:>8}: p95 {s['p95_us']:10.0f}us  "
              f"({s['count']} samples)")
    disp = tracer.stage_percentiles().get("fleet.dispatch", {})
    say(f"host dispatch span: p50 {disp.get('p50_us', 0.0):.0f}us over "
          f"{disp.get('count', 0)} ticks")
    EventLog.validate(log.records)
    kinds = sorted({r["kind"] for r in log.records})
    say(f"event log: {len(log)} causally-ordered records "
          f"({', '.join(kinds)})"
          + (f" -> {log.path}" if log.path else ""))
    log.close()
    trace_path = os.environ.get("REPRO_OBS_TRACE")
    if trace_path and say is print:
        tracer.export_chrome_trace(trace_path)
        say(f"chrome trace -> {trace_path}")
    return {"metrics": m, "ticks": ticks, "drained_by": step,
            "healthy": healthy, "final_budget": ex.core_budget,
            "resizes": ctl.resizes, "event_kinds": kinds,
            "trace_count": ex.trace_count}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes the 8 bridges run across (1, 2, 4, 8)")
    args = ap.parse_args()
    main(args.device, args.ranks)
