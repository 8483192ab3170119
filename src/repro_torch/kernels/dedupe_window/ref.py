"""Pure-numpy oracle for the dedupe-window stage.

A copy of ``repro.kernels.dedupe_window.ref`` (the port imports nothing
of the reference): the semantics ``ops.py`` is held to.  The
contract is the idempotent-ingestion dedupe window: an event's identity
is the FNV-1a hash of its full wire row (event timestamp + feature
words), membership is tested against a bounded ring of the hashes of
the last ``K`` *accepted* rows plus the earlier offered rows of the
same batch, and only rows that actually entered the ring buffer are
recorded (a row bounced by backpressure must NOT inoculate the window
against its own re-send).  The oracle keeps uint32 hashes; ``ops.py``
keeps their values in int64.
"""
from __future__ import annotations

import numpy as np

#: FNV-1a 32-bit offset basis / prime (the classic constants).
FNV_BASIS = np.uint32(2166136261)
FNV_PRIME = np.uint32(16777619)

#: Hash value reserved for "empty seen-ring slot".  Real hashes landing
#: on it are bumped to 1, so an all-zero ring never phantom-matches.
EMPTY_HASH = np.uint32(0)


def row_hash_ref(rows: np.ndarray) -> np.ndarray:
    """[N, C] f32 wire rows -> [N] uint32 FNV-1a event ids.

    Hashes the raw bit patterns (f32 reinterpreted as u32), so the id
    is exact under retransmission: a re-sent row hashes identically, a
    row differing in any bit does not (up to 32-bit collisions; the
    window is a dedupe heuristic, not a cryptographic ledger).
    """
    words = np.ascontiguousarray(
        np.asarray(rows, np.float32)).view(np.uint32)
    h = np.full(words.shape[0], FNV_BASIS, np.uint32)
    with np.errstate(over="ignore"):
        for c in range(words.shape[1]):
            h = (h ^ words[:, c]) * FNV_PRIME
    return np.where(h == EMPTY_HASH, np.uint32(1), h)


def dedupe_window_ref(hashes: np.ndarray, offered: np.ndarray,
                      seen: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Membership test: which offered rows are re-deliveries?

    ``hashes`` [N] uint32, ``offered`` [N] bool (which slots hold real
    items this tick), ``seen`` [K] uint32 (the accepted-hash ring;
    ``EMPTY_HASH`` marks unused slots).  Returns ``(fresh, dup)``, both
    [N] bool: ``dup`` marks offered rows whose hash is already in the
    window **or** appeared at an earlier offered slot of this same
    batch (intra-batch duplicates dedupe too — FIFO order, first
    delivery wins); ``fresh = offered & ~dup``.  K == 0 disables the
    window: everything offered is fresh.
    """
    n = hashes.shape[0]
    dup = np.zeros(n, bool)
    if seen.size == 0:                 # window disabled: intra-batch too
        return offered.astype(bool), dup
    batch_seen: set[int] = set()
    for i in range(n):
        if not offered[i]:
            continue
        h = np.uint32(hashes[i])
        if (seen.size and (seen == h).any()) or int(h) in batch_seen:
            dup[i] = True
        else:
            batch_seen.add(int(h))
    return offered & ~dup, dup


def seen_record_ref(seen: np.ndarray, seen_pos: int, hashes: np.ndarray,
                    accepted: np.ndarray) -> tuple[np.ndarray, int]:
    """Record the hashes of rows the ring actually *accepted*.

    ``accepted`` [N] bool must mark the admitted rows that survived
    backpressure (the enqueue acceptance prefix).  They are written
    into the ``seen`` ring in offer order starting at ``seen_pos``
    (oldest entries overwritten — the bounded-window part).  Returns
    the new ring and cursor; K == 0 is a no-op.
    """
    seen = np.array(seen, np.uint32, copy=True)
    k = seen.shape[0]
    if k == 0:
        return seen, seen_pos
    pos = int(seen_pos)
    for i in range(hashes.shape[0]):
        if accepted[i]:
            seen[pos % k] = np.uint32(hashes[i])
            pos += 1
    return seen, pos % k
