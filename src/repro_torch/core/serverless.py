"""Serverless function layer (paper §IV-D1 actions, §III serverless model).

Port of ``repro.core.serverless``.  ``store_function`` registers a
*function profile* -> callable mapping; ``find`` resolves an interest
against the registry by associative matching (``matching.
profile_match``, so the ``armatch`` kernel on the card);
``start_function`` returns the callables that match and marks them
running; ``stop_function`` retires them.

PyTorch has no ahead-of-time compile to cache.  ``start_function``
keeps the reference's cache and its key (function name and the
abstract signature of the arguments, ``_cache_key``), but caches the
callable itself; the reference's ``mesh``, ``in_shardings``,
``out_shardings`` and ``donate_argnums`` have no counterpart and are
not taken.  ``statistics()["aot_cached"]`` counts the cached entries,
under the reference's key name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import matching


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

    def start_function(self, interest: np.ndarray, *abstract_args
                       ) -> list[tuple[FunctionEntry, Any]]:
        """Match, cache, mark running.  Returns [(entry, callable)] for
        every match (paper: the function is executed wherever its profile
        resolves)."""
        out = []
        for e in self.find(interest):
            key = self._cache_key(e, abstract_args)
            if key not in self._aot_cache:
                self._aot_cache[key] = e.fn
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
