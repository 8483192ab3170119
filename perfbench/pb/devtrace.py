"""Reading ``torch.profiler`` captures of the card: device busy time,
device operations, the longest idle gaps by what the host was doing,
each kernel's durations, and device time attributed to the program's
stage spans (``obs:*`` ranges of its ``Tracer``).

A capture is exported as a Chrome trace into the checkout's ``build/``
folder, read and deleted.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
#: the range the harness opens around a profiled stretch
WINDOW_RANGE = "pb:traced_window"
#: idle gaps shorter than this (microseconds) are pooled under SHORT
GAP_US = 5.0
SHORT = "(gaps under 5 us between device ops)"


def base_name(name: str) -> str:
    """A kernel's unqualified function name (``fused_tick_kernel_span``
    of ``void fused_tick_kernel_span<...>(...)``), or the op's name."""
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0),
              default=len(name))
    words = name[:cut].split()
    return (words[-1].split("::")[-1] if words else name)[:96]


def prime(device) -> None:
    """A throw-away capture: a process's first one can miss the device
    ops launched while the device tracer starts."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(16):
            x = x + 1
        torch.cuda.synchronize()
        time.sleep(0.05)


def capture(fn, scratch: Path) -> list:
    """Profile ``fn()`` on the host and the card; the capture's events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    scratch.mkdir(parents=True, exist_ok=True)
    path = scratch / f"trace_{os.getpid()}.json"
    try:
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)


def _union(spans: list) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def window(events: list) -> dict:
    """The profiled stretch inside :data:`WINDOW_RANGE`: its length, the
    device's busy seconds (the union of its operations), the operations,
    each kernel's durations, the top operations by device time and the
    idle gaps labelled by the innermost host event over them."""
    marks = [e for e in events if e.get("name") == WINDOW_RANGE
             and "dur" in e]
    if not marks:
        raise RuntimeError(f"the capture holds no {WINDOW_RANGE!r} range")
    w0 = marks[0]["ts"]
    w1 = w0 + marks[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e
           and w0 <= e["ts"] <= w1]
    busy = _union([(e["ts"], min(w1, e["ts"] + e["dur"])) for e in dev])
    by_name: dict[str, float] = {}
    kernels: dict[str, list] = {}
    for e in dev:
        n = base_name(e["name"])
        by_name[n] = by_name.get(n, 0.0) + e["dur"] * 1e-6
        kernels.setdefault(n, []).append(e["dur"] * 1e-6)
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e["ts"] < w1 and e["ts"] + e["dur"] > w0
            and e.get("name") != WINDOW_RANGE]
    h0 = np.array([e["ts"] for e in host], dtype=np.float64)
    h1 = h0 + np.array([e["dur"] for e in host], dtype=np.float64)
    gaps: dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a < GAP_US:
            if b > a:
                gaps[SHORT] = gaps.get(SHORT, 0.0) + (b - a) * 1e-6
            continue
        mid = (a + b) / 2
        over = np.flatnonzero((h0 <= mid) & (h1 >= mid))
        label = host[over[np.argmax(h0[over])]]["name"][:96] \
            if over.size else "(no host event)"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return dict(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        ops=len(dev), kernels=kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:10])


def stages(events: list, prefix: str = "obs:") -> dict:
    """Device seconds by the innermost ``prefix`` range open on the host
    thread when each device operation was launched (matched through the
    launch's correlation id)."""
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e:
            c = e["args"].get("correlation")
            if c is not None:
                launch[c] = (e["ts"], e.get("tid"))
    ranges: dict = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e \
                and str(e.get("name", "")).startswith(prefix):
            ranges.setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    out: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        if at is None:
            continue
        ts, tid = at
        inner = [r for r in ranges.get(tid, ()) if r[0] <= ts <= r[1]]
        if inner:
            name = max(inner, key=lambda r: r[0])[2]
            out[name] = out.get(name, 0.0) + e["dur"] * 1e-6
    return out


def stage_ms(run: dict, names: tuple):
    """Device milliseconds a traced eager tick under the stage spans
    ``names``; None where the trace holds none of them."""
    st = run.get("stages")
    if not st or not any(n in st for n in names):
        return None
    return sum(st.get(n, 0.0) for n in names) / run["eager_ticks"] * 1e3
