"""The program's own trace of graphed ticks: stage times from device
marks inside the captured tick, and the step's host time split where
the work happens.

With ``Tracer(device_marks=True)`` installed, the program captures a
graph of its own for the tick (its ``obs:*`` spans and the step body
mark a device ring) and opens its host spans (``fleet.prepare``,
``fleet.dispatch``, ``step.copy_in``, ``step.launch``,
``step.copy_out``) on every tick.  :func:`stretch` runs :data:`TICKS`
such ticks of the run's feed with no profiler, after one tick that
captures, then puts ``NULL_TRACER`` back.  The ticks are ticks of the
run: the reference checks them like every other.  What it returns is a
run's ``program`` key, read by the ``edge_stages_graphed_ms``,
``exchange_graphed_ms``, ``step_launch_host_ms``,
``step_prepare_host_ms`` and ``launch_wait_ms`` readers.

Device times are wall time between two marks on the card: the gaps
inside the graph and the marks themselves count, unlike the eager
kernel sums of ``devtrace.stages``.  Marks are mapped onto the host's
clock by the tracer's calibration (the narrowest of 16 brackets of a
mark between two host stamps), before and after the stretch.
"""
from __future__ import annotations

import numpy as np

#: graphed ticks traced by the program (about 2.2 s of the fleet cell)
TICKS = 512

#: the host spans kept a tick
HOST_SPANS = ("fleet.prepare", "stream.prepare", "fleet.dispatch",
              "stream.dispatch", "step.copy_in", "step.launch",
              "step.copy_out")


def stretch(tk, tracer=None) -> dict | None:
    """Run the traced ticks on ``tk`` (a ``runner.Ticker``) with
    ``tracer`` (a new marking tracer by default); the run's ``program``
    key, or None where the program cannot mark."""
    from repro_torch.obs import trace as T
    if tracer is None:
        try:
            tracer = T.Tracer(device_marks=True)
        except TypeError:               # a program without device marks
            return None
    tk.system.set_tracer(tracer)
    try:
        tk.tick()                       # the marking signature's capture
        tk.sync()
        tracer.clear()
        before = tracer.calibrate()
        step_s, tick_s = [], []
        for _ in range(TICKS):
            h, d = tk.tick()
            step_s.append(h)
            tick_s.append(d)
        tk.sync()
        after = tracer.calibrate()
        dev = tracer.device_stages()
        spans = tracer.spans
    finally:
        tk.system.set_tracer(T.NULL_TRACER)
    host, starts, copy_in = {}, {}, {"tensors": [], "bytes": []}
    for name, t0, t1, _, args in spans:
        if name not in HOST_SPANS:
            continue
        host.setdefault(name, []).append(t1 - t0)
        starts.setdefault(name, []).append(t0)
        if name == "step.copy_in":
            copy_in["tensors"].append(args.get("tensors", 0))
            copy_in["bytes"].append(args.get("bytes", 0))
    marks = dev["graph"]
    steps = np.diff(np.sort(np.concatenate(
        [marks.ravel()] + [np.concatenate([s[2], s[3]])
                           for g in dev["openings"] for s in g["spans"]])))
    steps = steps[steps > 0]
    return dict(
        ticks=dev["ticks"], step_s=step_s, tick_s=tick_s, host=host,
        host_start=starts, copy_in=copy_in,
        stages={k: v.tolist() for k, v in dev["stages"].items()},
        openings=[{"ticks": g["ticks"].tolist(),
                   "spans": [(n, d, a.tolist(), b.tolist())
                             for n, d, a, b in g["spans"]]}
                  for g in dev["openings"]],
        graph=marks.tolist(), graph_host_s=dev["host_graph"].tolist(),
        marks_per_tick=[2 + 2 * len(g["spans"]) for g in dev["openings"]],
        calibration=[before, after],
        timer_step_ns=int(np.gcd.reduce(steps)) if steps.size else None,
        timer_min_step_ns=int(steps.min()) if steps.size else None)


def per_tick(run: dict, names) -> np.ndarray | None:
    """Host seconds a tick summed over the spans ``names`` that the
    stretch opened (each once a tick); None where it opened none."""
    prog = run.get("program")
    if not prog:
        return None
    have = [np.asarray(prog["host"][n]) for n in names if n in prog["host"]]
    if not have or len({len(h) for h in have}) != 1:
        return None
    return np.sum(have, axis=0)


def stage_ns(run: dict, names) -> np.ndarray | None:
    """Device ns a traced tick under the stage spans ``names``; None
    where the stretch marked none of them."""
    prog = run.get("program")
    if not prog or not any(n in prog["stages"] for n in names):
        return None
    return np.sum([prog["stages"][n] for n in names if n in prog["stages"]],
                  axis=0)
