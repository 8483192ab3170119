"""Structured JSONL event log for the fleet control plane.

Port of ``repro.obs.events``, host-side: a copy.

Every control-plane decision — budget resize, health-mask change,
leave/join, remesh, backup reassignment, replay/backlog movement —
becomes one typed record:

    {"seq": 17, "wall_time": 1754630000.12, "tick": 23,
     "kind": "leave", "shard": 4, "cause": "decommissioned",
     "backup": 6}

``seq`` is a per-log monotone counter (total order even when wall
clocks collide), ``tick`` the caller's tick number (may be ``None``
for out-of-band events), ``shard`` the acting shard (or ``None`` for
fleet-wide events), ``cause`` a free-form human string.  Extra
kind-specific payload keys ride alongside.

The writer is append-only: with a ``path`` the record is written
through (one JSON object per line, flushed) as it is emitted, so a
crashed run keeps its history up to the crash.  :func:`EventLog.load`
parses a file back; :meth:`EventLog.validate` checks the causal-order
invariants a reconstruction relies on (``seq`` strictly increasing,
``wall_time`` and ``tick`` non-decreasing).

``EVENT_KINDS`` is the closed schema: emitting an unknown kind raises
immediately (a typo'd kind would otherwise silently split a churn arc
across two spellings), and the golden-schema test pins the set so a
rename can never silently orphan old logs.
"""
from __future__ import annotations

import json
import time
from typing import IO, Iterable

#: The closed set of record kinds (golden-tested; extend deliberately).
EVENT_KINDS = frozenset({
    "budget_resize",     # elastic core budget changed (payload: from/to)
    "health_change",     # watermark health mask changed (payload: masks)
    "leave",             # member left within the mesh width
    "join",              # member (re)joined its slot
    "backup_assign",     # replay backup chosen for a departed stream
    "remesh",            # device set changed: mesh rebuilt, state migrated
    "stall_buffer",      # a stalled uplink buffered a batch upstream
    "replay_queue",      # a departed stream's batch entered its replay queue
    "replay_delivery",   # a backup re-ran one replayed batch
    "backlog_drain",     # a recovered shard drained one buffered batch
    "slot_drain",        # a rejoined slot drained its own replay queue
    "requeue",           # remesh payload pushed back as replay deliveries
    "fog_budget_resize",  # a region's elastic fog budget changed
    "slo_breach",        # an SLO's burn rate crossed threshold (both windows)
    "slo_recover",       # a breached SLO's burn rate dropped back under
    "ingest_reject",     # admission lane dropped rows (contract/backpressure)
    "drift_detected",    # per-field contract violations moved this tick
})

#: Envelope fields present on every record (payload keys ride alongside).
ENVELOPE_FIELDS = ("seq", "wall_time", "tick", "kind", "shard", "cause")


class EventLog:
    """Append-only typed event log with optional JSONL write-through."""

    def __init__(self, path: str | None = None):
        self.records: list[dict] = []
        self._seq = 0
        self._fh: IO | None = open(path, "w") if path else None
        self.path = path

    def emit(self, kind: str, *, tick: int | None = None,
             shard: int | None = None, cause: str | None = None,
             **payload) -> dict:
        """Append one record; returns it (already sequenced/stamped)."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; known: "
                             f"{sorted(EVENT_KINDS)}")
        clash = set(payload) & set(ENVELOPE_FIELDS)
        if clash:
            raise ValueError(f"payload keys shadow the envelope: {clash}")
        rec = {"seq": self._seq, "wall_time": time.time(), "tick": tick,
               "kind": kind, "shard": shard, "cause": cause, **payload}
        self._seq += 1
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- reading -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def of_kind(self, *kinds: str) -> list[dict]:
        return [r for r in self.records if r["kind"] in kinds]

    def to_jsonl(self) -> str:
        return "".join(json.dumps(r) + "\n" for r in self.records)

    def dump(self, path: str) -> str:
        """Write the in-memory records to ``path`` (independent of any
        write-through handle); returns ``path``."""
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    @staticmethod
    def load(path: str) -> list[dict]:
        """Parse a JSONL event log back into records."""
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    @staticmethod
    def validate(records: Iterable[dict]) -> None:
        """Causal-order invariants a post-hoc reconstruction relies on:
        every record carries the envelope, ``seq`` is strictly
        increasing, ``wall_time`` is non-decreasing, and ``tick`` (where
        present) never goes backwards.  Raises ``ValueError`` on the
        first violation."""
        prev_seq, prev_wall, prev_tick = -1, -float("inf"), None
        for i, r in enumerate(records):
            missing = [k for k in ENVELOPE_FIELDS if k not in r]
            if missing:
                raise ValueError(f"record {i} missing envelope {missing}")
            if r["kind"] not in EVENT_KINDS:
                raise ValueError(f"record {i}: unknown kind {r['kind']!r}")
            if r["seq"] <= prev_seq:
                raise ValueError(f"record {i}: seq {r['seq']} <= "
                                 f"{prev_seq} (not strictly increasing)")
            if r["wall_time"] < prev_wall:
                raise ValueError(f"record {i}: wall_time went backwards")
            if r["tick"] is not None:
                if prev_tick is not None and r["tick"] < prev_tick:
                    raise ValueError(f"record {i}: tick {r['tick']} < "
                                     f"{prev_tick} (not causally ordered)")
                prev_tick = r["tick"]
            prev_seq, prev_wall = r["seq"], r["wall_time"]
