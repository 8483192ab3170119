"""Host-side tracing hooks: the part of ``repro.obs.trace`` the executor
calls.

An enabled ``Tracer`` marks a tick and its stages (``obs:ingest``,
``obs:window``, ...) as ``torch.profiler.record_function`` ranges
(where the reference used JAX profiler annotations and
``jax.named_scope``), so they show on a live ``torch.profiler``
capture's timeline beside the device ops.  A range costs the host a
few microseconds even with no profiler running, so a disabled tracer
(``NULL_TRACER``, the executor's default) marks nothing: one attribute
lookup and a pre-built null context per span.  The reference's own span
recording, Chrome-trace export and stage percentiles belong to a later
slice.
"""
from __future__ import annotations

import contextlib

import torch

_NULL_CTX = contextlib.nullcontext()


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def span(self, name: str, **args):
        """Context manager marking ``name`` around the enclosed block;
        ``args`` are accepted for the reference's signature."""
        if not self.enabled:
            return _NULL_CTX
        return torch.profiler.record_function(name)

    def step_annotation(self, name: str, step_num: int):
        """A range marking one tick (``name#step_num``)."""
        if not self.enabled:
            return _NULL_CTX
        return torch.profiler.record_function(f"{name}#{step_num}")


#: shared disabled tracer: the executor's default
NULL_TRACER = Tracer(enabled=False)
