"""One run of a cell: set-up, warm-up, the measured window, the traced
stretch (``--trace 1``), then the check against the reference.

Every tick of a run, warm-up and traced ticks included, is a tick of
the same feed: tick ``t`` offers the pool's tick ``t mod P`` stamped for
``t``.  A tick runs from the call of the program's ``step`` to the
return of the ``torch.cuda.synchronize()`` after it.  The window is its
ticks back to back: its clock runs only while a tick's does, so the
harness's own work between two ticks (the feed's add for the next tick
and its synchronize, a checked tick's copies to the host) stands
outside it, and the window closes once its ticks have taken the run's
seconds.  The window's rows per second are taken over all of its ticks
and all of its time; the harness's time between ticks is reported
beside it (``harness_ms_per_tick``).
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from perfbench.pb import devtrace
from perfbench.pb.feed import Feed, Sampler, sub_seed
from perfbench.reference import compare as RC
from perfbench.reference import stream as RS


def core_weights(cfg: dict, seed: int) -> np.ndarray:
    """The core's ``[5 + D, 5 + D]`` float32 weights, from the seed."""
    w = 5 + cfg["features"]
    rng = np.random.default_rng(sub_seed(seed, 2))
    return (rng.standard_normal((w, w)) * cfg["core_weight_scale"]) \
        .astype(np.float32)


class Ticker:
    """Drives one system tick by tick and keeps what the check needs."""

    def __init__(self, system, feed: Feed, seed: int, one_in: int,
                 device: torch.device):
        self.system, self.feed = system, feed
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
            items, ts = self.feed.tick(t)
            self.sync()
        a = time.perf_counter()
        out = self.system.step(items, ts)
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
    rank's fleet over ranks (its rows), ``stop(elapsed) -> bool`` the
    ranks' shared decision to close the window; ``patch`` a context that
    breaks the program underneath (the harness's own tests); ``say``
    reports progress (across ranks)."""
    say = say or (lambda what: None)
    cfg, traffic = spec["config"], spec["traffic"]
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    p = core_weights(cfg, seed)
    total = cfg.get("num_regions", 1) * cfg.get("edges_per_region", 1)
    marks = [("start", time.perf_counter())]
    with patch() if patch else contextlib.nullcontext():
        system = spec["system"].build(cfg, torch.as_tensor(p, device=device),
                                      device, ranks)
        marks.append(("system", time.perf_counter()))
        say("system built")
        first = getattr(system, "first_shard", 0)
        mine = range(first, first + system.shards)
        feed = Feed(traffic, cfg, mine, seed, device)
        tk = Ticker(system, feed, seed, cfg["check_one_in"], device)
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
                   rows=len(tick_s) * cfg["micro_batch"] * total,
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
        del tk, system
    c0 = time.perf_counter()
    ref_p = torch.as_tensor(p, device=device).to(torch.float64)
    ref = RS.Stream(cfg, ref_p, device)
    all_feed = feed if len(mine) == total else \
        Feed(traffic, cfg, range(total), seed, device)
    del feed
    ref_ticks = ref.run(all_feed, n_ticks, set(ticks))
    mine = slice(first, first + len(mine))
    run["numbers"] = RC.compare(ticks, final, ref_ticks, ref.counters(),
                                mine)
    run["counter_diffs"] = RC.final_diffs(final, ref.counters(), mine)
    run["ticks"] = n_ticks
    run["check_s"] = time.perf_counter() - c0
    say("checked")
    return run


def traced(tk: Ticker, cfg: dict, device, scratch: Path) -> dict:
    """The traced stretch: ``trace_ticks`` graphed ticks under the
    profiler (busy and idle time, device ops, kernel durations), then
    ``eager_ticks`` eager ticks with the program's tracer on (device time
    by stage span)."""
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    devtrace.prime(device)

    def graphed():
        with torch.profiler.record_function(devtrace.WINDOW_RANGE):
            for _ in range(cfg["trace_ticks"]):
                tk.tick()
            tk.sync()
    win = devtrace.window(devtrace.capture(graphed, scratch))
    tk.system.set_tracer(Tracer())

    def eager():
        with tk.system.eager():
            for _ in range(cfg["eager_ticks"]):
                tk.tick()
    st = devtrace.stages(devtrace.capture(eager, scratch))
    tk.system.set_tracer(NULL_TRACER)
    return dict(graphed=win, traced_ticks=cfg["trace_ticks"],
                stages=st, eager_ticks=cfg["eager_ticks"])
