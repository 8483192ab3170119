"""Dedupe-window stage of the admission lane, in plain PyTorch.

Port of ``repro.kernels.dedupe_window`` (which has no Pallas kernel):
FNV-1a event ids over the raw f32 bit patterns of the wire row, a
bounded seen-window membership test, and the accepted-hash recording
scatter.  Same ``fresh``/``dup`` masks and seen ring, bit for bit.

Two representation choices differ from the reference:

* hashes live in int64 tensors holding values in ``[0, 2^32)`` --
  torch's uint32 arithmetic is thin, so FNV-1a runs in int64 with
  ``& 0xFFFFFFFF`` after each multiply.  ``repro_torch.convert`` maps
  a ``seen`` ring to the reference's uint32 and back;
* membership is a sort-based test (``torch.sort`` + ``searchsorted``)
  instead of the reference's ``[N, K]`` and ``[N, N]`` compare
  matrices, which at N = 65,536 and K = 131,072 would take 8.6 GB and
  4.3 GB.  One implementation serves both devices.
"""
from __future__ import annotations

import torch

#: FNV-1a 32-bit offset basis / prime (the classic constants).
FNV_BASIS = 2166136261
FNV_PRIME = 16777619

#: Hash value reserved for "empty seen-ring slot".  Real hashes landing
#: on it are bumped to 1, so an all-zero ring never phantom-matches.
EMPTY_HASH = 0

_U32 = 0xFFFFFFFF


def row_hash(rows: torch.Tensor) -> torch.Tensor:
    """[N, C] f32 wire rows -> [N] int64 FNV-1a event ids in
    ``[0, 2^32)`` (exact: the f32 words are reinterpreted, not rounded,
    so a re-sent row hashes identically on every device)."""
    words = rows.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64) & _U32
    h = torch.full(words.shape[:1], FNV_BASIS, dtype=torch.int64,
                   device=rows.device)
    for c in range(words.shape[1]):
        h = ((h ^ words[:, c]) * FNV_PRIME) & _U32
    return torch.where(h == EMPTY_HASH, 1, h)


def dedupe_window(hashes: torch.Tensor, offered: torch.Tensor,
                  seen: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership test: ``(fresh, dup)`` [N] bool masks.

    ``dup`` marks offered rows already in the ``seen`` ring **or**
    equal to an earlier offered slot of this batch (first delivery
    wins, FIFO); ``fresh = offered & ~dup``.  A ``seen`` ring of size 0
    disables the window."""
    offered = offered.to(torch.bool)
    k = seen.shape[0]
    if k == 0:
        return offered, torch.zeros_like(offered)
    n = hashes.shape[0]
    sorted_seen, _ = torch.sort(seen)
    pos = torch.searchsorted(sorted_seen, hashes).clamp_(max=k - 1)
    in_seen = sorted_seen[pos] == hashes
    # earlier offered duplicate: a stable sort keeps equal hashes in slot
    # order, so every offered row but the first of its hash follows an
    # equal key.  Rows not offered get distinct keys past 2^32 and so
    # never match anything.
    ar = torch.arange(n, dtype=torch.int64, device=hashes.device)
    key = torch.where(offered, hashes, (1 << 32) + ar)
    skey, perm = torch.sort(key, stable=True)
    repeat = torch.zeros_like(offered)
    repeat[1:] = skey[1:] == skey[:-1]
    earlier = torch.empty_like(offered).index_put_((perm,), repeat)
    dup = offered & (in_seen | earlier)
    return offered & ~dup, dup


def seen_record(seen: torch.Tensor, seen_pos: torch.Tensor,
                hashes: torch.Tensor, accepted: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Record hashes of ring-*accepted* rows into the seen window, in
    offer order from ``seen_pos`` (oldest entries overwritten).  When a
    batch accepts more than K rows only the last K are written, so no
    two writes share a slot; the rest go to a discard slot past the
    ring.  Returns a new ring and cursor."""
    k = seen.shape[0]
    if k == 0:
        return seen, seen_pos
    acc = accepted.to(torch.int32)
    rank = torch.cumsum(acc, 0, dtype=torch.int32) - 1
    n_rec = acc.sum(dtype=torch.int32)
    keep = accepted.to(torch.bool) & (rank >= n_rec - k)   # last K accepted
    idx = torch.where(keep, (seen_pos + rank) % k, k)      # k = discard
    out = torch.cat([seen, seen.new_zeros(1)])
    out.index_put_((idx.long(),), hashes.to(seen.dtype))
    return out[:k], (seen_pos + n_rec) % k
