"""Bucketed latency histograms carried on the device.

Port of ``repro.obs.latency``.  Step latency and the event-time
lineage live in fixed-shape int32 count tensors, bucket-incremented on
the device every tick; percentiles are read on the host on demand (one
transfer for the whole bank).  Buckets are log-spaced
(``DEFAULT_EDGES``: 1 us .. 100 s, ~17% ratio per bucket); edges are
float32 on the device, as in the reference.  ``torch.searchsorted``
with ``right=False`` is ``jnp.searchsorted``'s default left side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device_constant, resolve_device

#: Log-spaced bucket upper edges in seconds: 1 us .. 100 s, 121 edges
#: (122 buckets with the overflow bucket).
DEFAULT_EDGES = np.logspace(-6.0, 2.0, 121)

#: Event-time lineage stages, in hot-path order (see the reference
#: module for each stage's definition).  A single device fills
#: ``queueing``, ``window`` and ``e2e``; the hops belong to the fleet.
LINEAGE_STAGES = ("queueing", "window", "hop1", "hop2", "e2e")


_DEFAULT_KEY = tuple(DEFAULT_EDGES.tolist())


def _edges(edges: np.ndarray, device: torch.device) -> torch.Tensor:
    """Float32 bucket edges on ``device``."""
    key = _DEFAULT_KEY if edges is DEFAULT_EDGES \
        else tuple(np.asarray(edges, np.float64).tolist())
    return device_constant(key, torch.float32, torch.device(device))


def histogram_init(edges: np.ndarray = DEFAULT_EDGES,
                   device: str | torch.device | None = None
                   ) -> torch.Tensor:
    """Zeroed counts: one bucket per edge plus the overflow bucket, on
    ``device`` (``None``: the CUDA card)."""
    return torch.zeros((len(edges) + 1,), dtype=torch.int32,
                       device=resolve_device(device))


def histogram_update(counts: torch.Tensor, value: torch.Tensor,
                     edges: np.ndarray = DEFAULT_EDGES) -> torch.Tensor:
    """Bucket-increment ``counts`` with one sample (a 0-dim f32 tensor).
    Non-positive values are skipped: the executors feed 0.0 for a
    missing measurement."""
    value = value.to(torch.float32)
    idx = torch.searchsorted(_edges(edges, counts.device), value[None])
    return counts.index_add(0, idx, (value > 0.0).to(counts.dtype)[None])


def histogram_update_batch(counts: torch.Tensor, values: torch.Tensor,
                           mask: torch.Tensor,
                           edges: np.ndarray = DEFAULT_EDGES
                           ) -> torch.Tensor:
    """Bucket-increment ``counts`` with a batch of samples: ``values``
    [N] f32 seconds, ``mask`` [N] bool.  Masked-in values are clamped up
    to the first bucket: a zero latency is a real measurement here.
    With leading dims (``counts [..., buckets]``, ``values``/``mask``
    ``[..., N]``: a fleet's shards) each row takes its own samples."""
    e = _edges(edges, counts.device)
    v = torch.maximum(values.to(torch.float32), e[0] * 0.5)
    idx = torch.searchsorted(e, v)
    nb = counts.shape[-1]
    if counts.ndim > 1:
        rows = torch.arange(counts.numel() // nb, device=counts.device) * nb
        idx = idx + rows.reshape(counts.shape[:-1] + (1,))
    return counts.reshape(-1).index_add(
        0, idx.reshape(-1), mask.to(counts.dtype).reshape(-1)) \
        .reshape(counts.shape)


def histogram_merge(a, b):
    """Merge two histograms (or stacks of them) by summing counts."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.as_tensor(a) + torch.as_tensor(b)
    return np.asarray(a) + np.asarray(b)


def lineage_init(edges: np.ndarray = DEFAULT_EDGES,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Zeroed per-stage lineage bank ``[len(LINEAGE_STAGES), buckets]``
    on ``device`` (``None``: the CUDA card)."""
    return torch.zeros((len(LINEAGE_STAGES), len(edges) + 1),
                       dtype=torch.int32, device=resolve_device(device))


def lineage_update(bank: torch.Tensor, samples: dict,
                   edges: np.ndarray = DEFAULT_EDGES) -> torch.Tensor:
    """Batch-update stage rows of a lineage bank ``[..., stages,
    buckets]`` (leading dims: one bank a fleet shard).  ``samples`` maps
    stage names to ``(values, mask)`` pairs (``[..., N]``); other stages
    keep their counts."""
    bank = bank.clone()
    for name, (values, mask) in samples.items():
        i = LINEAGE_STAGES.index(name)     # ValueError -> typo'd stage
        bank[..., i, :] = histogram_update_batch(bank[..., i, :], values,
                                                 mask, edges)
    return bank


def lineage_percentiles(bank, qs=(50, 95, 99),
                        edges: np.ndarray = DEFAULT_EDGES) -> dict:
    """Host-side per-stage percentiles of a lineage bank ``[...,
    n_stages, buckets]``; leading axes are pooled by summation."""
    c = _host(bank)
    c = c.reshape(-1, c.shape[-2], c.shape[-1]).sum(axis=0)
    return {name: histogram_percentiles(c[i], qs, edges)
            for i, name in enumerate(LINEAGE_STAGES)}


def histogram_percentiles(counts, qs=(50, 95, 99),
                          edges: np.ndarray = DEFAULT_EDGES) -> dict:
    """Host-side percentile extraction: ``{"count": n, "p50_us": ...}``.
    A percentile is the upper edge of the bucket where the CDF crosses
    it (never under-reports; exact to one bucket ratio)."""
    c = _host(counts)
    total = int(c.sum())
    out = {"count": total}
    if total == 0:
        for q in qs:
            out[f"p{q}_us"] = 0.0
        return out
    cdf = np.cumsum(c)
    uppers = np.append(edges, edges[-1])
    for q in qs:
        idx = int(np.searchsorted(cdf, q / 100.0 * total))
        out[f"p{q}_us"] = float(uppers[min(idx, len(uppers) - 1)] * 1e6)
    return out


def _host(counts) -> np.ndarray:
    if isinstance(counts, torch.Tensor):
        counts = counts.cpu().numpy()
    return np.asarray(counts, np.int64)
