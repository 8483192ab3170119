"""Serverless function layer (paper §IV-D1 actions, §III serverless model).

Port of ``repro.core.serverless``.  ``store_function`` registers a
*function profile* -> callable mapping; ``find`` resolves an interest
against the registry by associative matching (``matching.
profile_match``, so the ``armatch`` kernel on the card);
``start_function`` returns the matching functions, compiled ahead of
time, and marks them running; ``stop_function`` retires them.

The reference AOT-compiles there; the port captures there.  Each
match's cached step is a ``runtime.capture.Step`` over the stored
callable, keyed as the reference keys its cache (function name and the
signature of the arguments, ``_cache_key``; a module by identity, since
the graph reads its parameters where they lie).  On the card the step
warms up on copies of the donated arguments and is captured as a CUDA
graph at ``start_function``, so its first call replays; on the CPU, or
for abstract (``meta``) arguments, it is built at its first call.
``statistics()["aot_cached"]`` counts the cached steps.  The
reference's ``mesh``, ``in_shardings`` and ``out_shardings`` have no
counterpart on one card and are not taken.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import matching
from repro_torch.runtime import capture


@dataclasses.dataclass
class FunctionEntry:
    name: str
    profile: np.ndarray                  # encoded function profile
    fn: Callable
    running: bool = False
    meta: dict | None = None


class FunctionRegistry:
    """Associative store of function profiles (paper: distributed function
    store enabling sharing/reuse).  The profiles live on the host and, as
    one ``[F, 128]`` table, on ``device`` (``None``: the CUDA card),
    where ``find`` matches them."""

    def __init__(self, device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self._entries: list[FunctionEntry] = []
        self._table: torch.Tensor | None = None      # rebuilt on demand
        self._aot_cache: dict[tuple, Any] = {}

    # -- actions ------------------------------------------------------------

    def store_function(self, name: str, profile: np.ndarray, fn: Callable,
                       meta: dict | None = None) -> None:
        self._entries.append(FunctionEntry(name, np.asarray(profile), fn,
                                           False, meta))
        self._table = None

    def find(self, interest: np.ndarray) -> list[FunctionEntry]:
        """All stored functions whose profile matches the interest."""
        if not self._entries:
            return []
        if self._table is None:
            self._table = torch.from_numpy(np.stack(
                [e.profile for e in self._entries]).astype(np.int32)) \
                .to(self.device)
        interest = torch.as_tensor(np.asarray(interest, np.int32)) \
            .to(self.device)
        hits = matching.profile_match(interest[None, :], self._table).cpu()
        return [e for e, h in zip(self._entries, hits.tolist()) if h]

    def start_function(self, interest: np.ndarray, *abstract_args,
                       donate_argnums=()) -> list[tuple[FunctionEntry, Any]]:
        """Match, capture ahead of time (cached), mark running.  Returns
        [(entry, step)] for every match (paper: the function is executed
        wherever its profile resolves).  ``donate_argnums``: the
        arguments that are the function's state, whose new values it
        returns as its last outputs, in order (a serve step's caches and
        lengths), as the reference donates them."""
        out = []
        for e in self.find(interest):
            key = self._cache_key(e, abstract_args)
            if key not in self._aot_cache:
                self._aot_cache[key] = capture.Step(
                    e.fn, device=self.device, donate_argnums=donate_argnums,
                    name=e.name).prepare(*abstract_args)
            e.running = True
            out.append((e, self._aot_cache[key]))
        return out

    def stop_function(self, interest: np.ndarray) -> int:
        n = 0
        for e in self.find(interest):
            if e.running:
                e.running, n = False, n + 1
        return n

    def statistics(self) -> dict:
        """Paper's ``statistics`` action: registry + cache status."""
        return {
            "stored": len(self._entries),
            "running": sum(e.running for e in self._entries),
            "aot_cached": len(self._aot_cache),
            "names": [e.name for e in self._entries],
        }

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _sig(a) -> tuple:
        if isinstance(a, torch.nn.Module):
            return ("module", type(a).__name__, id(a))
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            return ("arr", tuple(a.shape), str(a.dtype))
        if isinstance(a, (list, tuple)):
            return tuple(FunctionRegistry._sig(x) for x in a)
        if isinstance(a, dict):
            return tuple(sorted((k, FunctionRegistry._sig(v))
                                for k, v in a.items()))
        return ("obj", str(a))

    def _cache_key(self, e: FunctionEntry, args) -> tuple:
        return (e.name, self._sig(args))
