"""Sharded DHT storage layer (paper §IV-C3), memory-tier discipline.

Port of ``repro.core.store``.  One shard is an append-log of fixed
capacity on the device: keys ``[C, 128]`` int32 (encoded profiles),
values ``[C, D]``, an insertion stamp per slot (-1 = empty) and a
cursor.
  - ``store``: append a batch at the cursor (ring overwrite when full —
    the paper's LRU spill, oldest evicted first).
  - ``query_exact`` / ``query_match``: masked compare against the whole
    log, a sequential scan; ``query_match`` goes through the
    ``armatch`` kernel on the card.

As in the port's ring buffer, each tensor has one discard row past the
capacity (keys, values and stamps ``[C + 1, ...]``; the discard row's
stamp stays -1 and nothing reads its keys or values), and ``store``
and ``delete_matching`` write the shard's tensors in place instead of
copying the log: a shard handed to either must not be read again as
the state before the call.

Duplicate slots: a batch that keeps more rows than the capacity would
put several kept rows on one slot.  The reference's scatter gives
"newest wins" on the CPU, while ``index_put_`` on the card leaves the
order of duplicates open; so only the last ``C`` kept rows of a batch
write, the rest go to the discard row, and every live slot is written
once, deterministically on both devices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import matching, profiles as P


class ShardStore(NamedTuple):
    keys: torch.Tensor     # [C + 1, PROFILE_WIDTH] int32 encoded profiles
    values: torch.Tensor   # [C + 1, D]
    stamps: torch.Tensor   # [C + 1] int32 monotone insertion stamp (-1 = empty)
    cursor: torch.Tensor   # [] int32 total items ever inserted

    @property
    def capacity(self) -> int:
        return self.keys.shape[0] - 1

    def log(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(keys, values, stamps) of the log proper, without the discard
        row (views)."""
        c = self.capacity
        return self.keys[:c], self.values[:c], self.stamps[:c]


def init_store(capacity: int, value_dim: int, dtype=torch.float32,
               device: str | torch.device | None = None) -> ShardStore:
    """An empty shard on ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    return ShardStore(
        keys=torch.zeros((capacity + 1, P.PROFILE_WIDTH), dtype=torch.int32,
                         device=device),
        values=torch.zeros((capacity + 1, value_dim), dtype=dtype,
                           device=device),
        stamps=torch.full((capacity + 1,), -1, dtype=torch.int32,
                          device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def store(st: ShardStore, keys: torch.Tensor, values: torch.Tensor,
          mask: torch.Tensor | None = None) -> ShardStore:
    """Append a batch; ring-overwrites oldest entries when full.  Writes
    ``st``'s tensors in place.

    mask: [N] bool — padding rows (False) are skipped without consuming
    log slots (routing delivers fixed-capacity buckets with padding).
    """
    n = keys.shape[0]
    cap = st.capacity
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=st.keys.device)
    kept = mask.to(torch.int32)
    # compact: kept rows get consecutive slots starting at cursor
    offs = torch.cumsum(kept, 0, dtype=torch.int32) - 1          # [N]
    n_kept = kept.sum(dtype=torch.int32)
    # only the last `cap` kept rows write (see the module docstring)
    write = mask.to(torch.bool) & (offs >= n_kept - cap)
    stamp = st.cursor + offs
    slot = torch.where(write, stamp % cap, cap).long()           # cap = discard
    st.keys.index_put_((slot,), keys.to(torch.int32))
    st.values.index_put_((slot,), values.to(st.values.dtype))
    st.stamps.index_put_((slot,), torch.where(write, stamp, -1))
    return st._replace(cursor=st.cursor + n_kept)


def query_match(st: ShardStore, interest: torch.Tensor, max_results: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Associative query: one interest profile vs the whole log.

    Returns (values [max_results, D], hit_mask [max_results], n_hits).
    Wildcard/range/prefix interests supported (paper Figs. 6-7).
    """
    keys, values, stamps = st.log()
    hits = matching.profile_match(interest[None, :], keys) & (stamps >= 0)
    # rank hits by recency (stamp desc), take top max_results; a k
    # beyond the log capacity just pads the result with misses.  Ties
    # are misses only (stamps of live slots are distinct), whose values
    # are zeroed, so topk's order among ties does not show.
    k = min(max_results, st.capacity)
    score = torch.where(hits, stamps, -1)
    top_idx = torch.topk(score, k, sorted=True).indices
    top_hit = score[top_idx] >= 0
    vals = torch.where(top_hit[:, None], values[top_idx], 0)
    pad = max_results - k
    if pad:
        vals = torch.cat([vals, vals.new_zeros((pad, vals.shape[1]))])
        top_hit = torch.cat([top_hit, top_hit.new_zeros((pad,))])
    return vals, top_hit, hits.sum(dtype=torch.int32)


def query_exact(st: ShardStore, key: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-key lookup: latest value stored under an identical profile."""
    keys, values, stamps = st.log()
    eq = (keys == key.to(torch.int32)[None, :]).all(-1) & (stamps >= 0)
    score = torch.where(eq, stamps, -1)
    best = torch.argmax(score)
    found = score[best] >= 0
    return torch.where(found, values[best], 0), found


def delete_matching(st: ShardStore, interest: torch.Tensor) -> ShardStore:
    """Paper's ``delete`` action: tombstone all matching entries (in
    place)."""
    keys, _, stamps = st.log()
    hits = matching.profile_match(interest[None, :], keys) & (stamps >= 0)
    stamps.masked_fill_(hits, -1)
    return st
