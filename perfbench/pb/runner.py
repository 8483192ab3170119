"""One run of a cell: set-up, warm-up, the measured window, the traced
stretches (``--trace 1``), then the check against the reference.  The
cell's system module (``systems/__init__.py``) gives the weights, the
feed, the traced stretches after the runner's own, and the check.

Every tick of a run, warm-up and traced ticks included, is a tick of
the same feed: tick ``t`` offers the feed's ``tick(t)``.  A tick runs
from the call of the program's ``step`` to the return of the
``torch.cuda.synchronize()`` after it.  The window is its ticks back to
back: its clock runs only while a tick's does, so the harness's own
work between two ticks (the feed's next tick and its synchronize, a
checked tick's copies to the host) stands outside it, and the window
closes once its ticks have taken the run's seconds.  The window's items
per second (``rows``: the feed's ``items_per_tick`` a tick) are taken
over all of its ticks and all of its time; the harness's time between
ticks is reported beside it (``harness_ms_per_tick``).
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from perfbench.pb import devtrace
from perfbench.pb.feed import Sampler


class Ticker:
    """Drives one system tick by tick and keeps what the check needs;
    ``stretches``: the system's traced stretches."""

    def __init__(self, system, feed, seed: int, one_in: int,
                 device: torch.device, stretches):
        self.system, self.feed, self.stretches = system, feed, stretches
        self.sampled = Sampler(seed, one_in)
        self.sync = torch.cuda.synchronize if device.type == "cuda" \
            else (lambda: None)
        self.t = 0
        self.kept: dict = {0: {"before": system.counters()}}

    def tick(self) -> tuple[float, float]:
        """One tick: (host seconds of the call, seconds to the end of the
        synchronize after it)."""
        t = self.t
        with torch.profiler.record_function("pb:feed"):
            args = self.feed.tick(t)
            self.sync()
        a = time.perf_counter()
        out = self.system.step(*args)
        b = time.perf_counter()
        with torch.profiler.record_function("pb:sync"):
            self.sync()
        c = time.perf_counter()
        with torch.profiler.record_function("pb:keep"):
            if t in self.kept:
                self.kept[t]["out"] = self.system.outputs(out)
                self.kept[t]["after"] = self.system.counters()
            if self.sampled(t + 1):
                self.kept[t + 1] = {"before": self.kept[t]["after"]
                                    if "after" in self.kept.get(t, {})
                                    else self.system.counters()}
        self.t = t + 1
        return b - a, c - a

    def checked(self) -> dict:
        return {t: v for t, v in self.kept.items() if "out" in v}


def measure(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float, ranks=None, stop=None, scratch: Path | None = None,
            patch=None, say=None) -> dict:
    """Set up, warm up and measure one run; check it.  ``ranks``: this
    rank's part of a run over ranks (its shards), ``stop(elapsed) ->
    bool`` the ranks' shared decision to close the window; ``patch`` a
    context that breaks the program underneath (the harness's own
    tests); ``say`` reports progress (across ranks)."""
    say = say or (lambda what: None)
    cfg, traffic, sysm = spec["config"], spec["traffic"], spec["system"]
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    p = sysm.params(cfg, seed)
    marks = [("start", time.perf_counter())]
    with patch() if patch else contextlib.nullcontext():
        system = sysm.build(cfg, p, device, ranks)
        marks.append(("system", time.perf_counter()))
        say("system built")
        first = getattr(system, "first_shard", 0)
        mine = range(first, first + system.shards)
        feed = sysm.feed(traffic, cfg, mine, seed, device)
        tk = Ticker(system, feed, seed, cfg["check_one_in"], device,
                    sysm.stretches)
        tk.sync()
        marks.append(("feed", time.perf_counter()))
        for _ in range(cfg["warmup_ticks"]):
            tk.tick()
        marks.append(("warmup", time.perf_counter()))
        say("warmed up")
        from repro_torch.launch import mesh as M
        sent0 = M.COLLECTIVES.sent_bytes
        tick_s, host_s = [], []
        tk.sync()
        w0 = time.perf_counter()
        window_s = 0.0
        while True:
            h, d = tk.tick()
            tick_s.append(d)
            host_s.append(h)
            window_s += d
            if (stop(window_s) if stop else window_s >= seconds):
                break
        w1 = time.perf_counter()
        run = dict(setup_s=w0 - t_start, window_s=window_s,
                   harness_ms_per_tick=(w1 - w0 - window_s)
                   / len(tick_s) * 1e3,
                   setup_parts={k: round(t - t_start, 3) for k, t in marks},
                   window_ticks=len(tick_s),
                   rows=len(tick_s) * feed.items_per_tick,
                   tick_s=tick_s, host_s=host_s,
                   collective_bytes=M.COLLECTIVES.sent_bytes - sent0)
        run["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        say("window closed")
        if trace:
            run.update(traced(tk, cfg, device, scratch))
            say("traced")
        final = system.counters()
        ticks = tk.checked()
        n_ticks = tk.t
        system.close()
        del tk, system, feed
    c0 = time.perf_counter()
    run["numbers"], run["counter_diffs"] = sysm.check(
        cfg, p, traffic, seed, device, ticks, final, n_ticks, mine)
    run["ticks"] = n_ticks
    run["check_s"] = time.perf_counter() - c0
    say("checked")
    return run


def traced(tk: Ticker, cfg: dict, device, scratch: Path) -> dict:
    """The traced stretches: ``trace_ticks`` graphed ticks under the
    profiler (busy and idle time, device ops, kernel durations), then
    each of the system's ``stretches`` in order."""
    devtrace.prime(device)

    def graphed():
        with torch.profiler.record_function(devtrace.WINDOW_RANGE):
            for _ in range(cfg["trace_ticks"]):
                tk.tick()
            tk.sync()
    out = dict(graphed=devtrace.window(devtrace.capture(graphed, scratch)),
               traced_ticks=cfg["trace_ticks"])
    for stretch in tk.stretches:
        out.update(stretch(tk, cfg, device, scratch))
    return out
