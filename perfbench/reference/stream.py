"""Plain PyTorch reference of the edge stream tick and the edge fleet.

Written from the semantics the configuration files state, not from the
program: it imports nothing of the system under test and takes nothing
the program made.  It is handed the inputs the benchmark made (the feed
and the core's weights) and works out again, tick by tick, what a
gateway or a fleet must answer:

- admission: a row's identity is the ordinal of its first sending,
  which the feed knows exactly (``Feed.ids``), not anything computed
  from its contents; a row is a re-delivery while its identity is among
  the last ``dedupe_window`` accepted ones or appeared earlier in its
  batch; a row that breaks the contract (a value outside ``[lo, hi]``,
  or not finite) is rejected and never remembered.  So a fresh row is
  never taken for a re-delivery;
- the ring: a FIFO of the accepted rows; a tick dequeues up to
  ``micro_batch`` of them;
- the watermark: a dequeued row older than the watermark less the
  lateness is late and leaves the windows;
- windows of ``window`` rows every ``stride`` rows over the carried
  ``window - stride`` rows and the dequeued block, each summed left to
  right (float32 adds in that order, so the aggregates are exact), the
  five rule features of feature 0, the IF-THEN rules with the highest
  priority winning;
- the two tiers: windows whose rules send them to the core, the first
  ``budget`` of them (in a fleet: the first ``fog_budget`` of a region's
  candidates in edge-major order, then the first ``core_budget`` of the
  survivors in region-major order) get ``layers`` x ``tanh(h @ p)``;
  every other window keeps its record;
- the counters the program keeps, tick by tick.

Every step is a whole-tensor operation on the device the caller names.
"""
from __future__ import annotations

import torch

CODES = {"none": 0, "store_edge": 1, "send_core": 2, "drop": 4}
CMP = {">=": torch.ge, ">": torch.gt, "<=": torch.le, "<": torch.lt,
       "==": torch.eq}
F32_MIN = torch.finfo(torch.float32).min
F32_MAX = torch.finfo(torch.float32).max

#: the program's cumulative stream counters that admission and the ring
#: decide (the reference follows every tick for these)
ADMISSION_COUNTERS = ("steps", "items_offered", "items_accepted",
                      "items_rejected", "items_deduped", "items_dequeued",
                      "items_late")
#: the counters a tick's windows decide (compared tick by tick where
#: the outputs are)
WINDOW_COUNTERS = ("windows_emitted", "rules_fired", "windows_escalated",
                   "windows_stored", "windows_dropped", "core_overflow")


def first_in_batch(h: torch.Tensor) -> torch.Tensor:
    """``[..., N]`` bool: the first occurrence of each identity in its batch
    (the last dim)."""
    order = torch.argsort(h, dim=-1, stable=True)
    hs = torch.gather(h, -1, order)
    first_sorted = torch.ones_like(hs, dtype=torch.bool)
    first_sorted[..., 1:] = hs[..., 1:] != hs[..., :-1]
    return torch.empty_like(first_sorted).scatter_(-1, order, first_sorted)


class Rules:
    """The configuration's IF-THEN rules over the five window features
    (mean, max, min, sum, count of feature 0): every rule is tested and
    the one with the highest priority fires (ties: the earlier rule)."""

    def __init__(self, rules: list):
        ranked = sorted(range(len(rules)),
                        key=lambda i: (-rules[i]["priority"], i))
        self.apply_order = [rules[i] for i in reversed(ranked)]

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        cons = torch.zeros(feats.shape[:-1], dtype=torch.int32,
                           device=feats.device)
        for r in self.apply_order:
            hit = CMP[r["op"]](feats[..., r["feature"]],
                               torch.tensor(r["value"], dtype=feats.dtype))
            cons = torch.where(hit, CODES[r["consequence"]], cons)
        return cons


def windows(seq: torch.Tensor, valid: torch.Tensor, window: int,
            stride: int, min_count: int, rules: Rules) -> dict:
    """Complete windows over a ``[..., T, 1 + D]`` block of ``[stamp |
    features]`` rows: aggregates (means), the five features of feature
    0, the valid count, the rules' consequence (0 where a window has
    fewer than ``min_count`` rows), each sum added left to right."""
    t = seq.shape[-2]
    nw = (t - window) // stride + 1
    idx = (torch.arange(nw, device=seq.device) * stride)[:, None] \
        + torch.arange(window, device=seq.device)[None, :]
    x = seq[..., 1:][..., idx, :]                     # [..., NW, W, D]
    m = valid[..., idx][..., None]                    # [..., NW, W, 1]
    xs = torch.where(m, x, 0.0)
    s = xs[..., 0, :]
    for w in range(1, window):
        s = s + xs[..., w, :]
    sig = x[..., 0]
    mx = torch.where(m[..., 0], sig, F32_MIN).amax(-1)
    mn = torch.where(m[..., 0], sig, F32_MAX).amin(-1)
    count = m[..., 0].sum(-1, dtype=torch.int32)
    cf = torch.clamp(count.to(torch.float32), min=1.0)
    nonempty = count > 0
    mx = torch.where(nonempty, mx, 0.0)
    mn = torch.where(nonempty, mn, 0.0)
    agg = s / cf[..., None]
    feats = torch.stack([s[..., 0] / cf, mx, mn, s[..., 0],
                         count.to(torch.float32)], -1)
    emit = count >= min_count
    cons = torch.where(emit, rules(feats), 0)
    return dict(aggregates=agg, features=feats, window_count=count,
                consequence=cons, emit=emit,
                record=torch.cat([feats, agg], -1))


def core(record: torch.Tensor, p: torch.Tensor, layers: int) -> torch.Tensor:
    """The core tier: ``layers`` x ``tanh(h @ p)`` on each record row."""
    h = record.to(p.dtype)
    for _ in range(layers):
        h = torch.tanh(h @ p)
    return h


class Stream:
    """A gateway (no fleet keys in ``cfg``: one shard) or a fleet of
    ``num_regions x edges_per_region`` shards, followed tick by tick from
    the same inputs the program is offered.

    Each shard's state is a row of: the dedupe window (the last K
    accepted identities, a ring of K slots),
    the carried rows, the running max event time, and the counters.  A
    closed loop offers ``micro_batch`` rows a shard a tick into a ring
    that holds them, so each tick's dequeued block is exactly its
    accepted rows in offer order: the reference keeps no queue and
    checks those two conditions.

    ``p``: the core's ``[5 + D, 5 + D]`` weights as the benchmark made
    them; the core runs in ``p``'s dtype (float64 for the reference)."""

    def __init__(self, cfg: dict, p: torch.Tensor, device):
        if cfg["capacity"] < cfg["micro_batch"]:
            raise ValueError("the reference follows rings that hold a "
                             "micro-batch")
        self.cfg = cfg
        self.p = p
        self.rules = Rules(cfg["rules"])
        self.fleet = "num_regions" in cfg
        s = cfg["num_regions"] * cfg["edges_per_region"] \
            if self.fleet else 1
        self.shards_n = s
        d, k = cfg["features"], cfg.get("dedupe_window", 0)
        c = cfg["window"] - cfg["stride"]
        z = dict(device=device)
        # a slot never written holds its own mark below every identity
        # (those are at least -micro_batch), so that the window's entries
        # are distinct
        self.ring = -(1 << 50) - torch.arange(k, **z).expand(s, k).clone()
        self.ring_pos = torch.zeros((s,), dtype=torch.int64, **z)
        self.carry = torch.zeros((s, c, 1 + d), **z)
        self.carry_valid = torch.zeros((s, c), dtype=torch.bool, **z)
        self.max_ts = torch.full((s,), F32_MIN, **z)
        self.counts = {n: torch.zeros((s,), dtype=torch.int64, **z)
                       for n in ADMISSION_COUNTERS}
        self.drift = torch.zeros((s, d), dtype=torch.int64, **z)
        self.wm = torch.tensor(F32_MIN, **z)

    def violations(self, items: torch.Tensor) -> torch.Tensor:
        """The contract's verdict on each value of ``items [..., D]``."""
        cfg = self.cfg
        viol = torch.zeros_like(items, dtype=torch.bool)
        if "contract_lo" in cfg:
            if cfg["require_finite"]:
                viol = ~torch.isfinite(items)
            viol = viol | (items < cfg["contract_lo"]) \
                | (items > cfg["contract_hi"])
        return viol

    def run(self, feed, ticks: int, want, chunk: int = 32) -> dict:
        """Follow ``ticks`` ticks of ``feed`` (its pool ``items [S, P, B,
        D]`` and ``stamps(t) [S, B]``, every shard of the fleet).
        Returns, for each tick in ``want``, the window counters'
        increments ``{name: [S] ints}`` and the tick's outputs.

        Only the dedupe window runs tick after tick; everything else of
        a stretch of ``chunk`` ticks is computed at once: a tick's
        dequeued block is its accepted rows, the running maxima are
        cumulative maxima over the stretch."""
        cfg = self.cfg
        if feed.items.shape[2] != cfg["micro_batch"]:
            raise ValueError("the reference follows a closed loop of one "
                             "micro-batch a shard a tick")
        done = {}
        pool_viol = self.violations(feed.items)            # [S, P, B, D]
        pool_ok = ~pool_viol.any(-1)                       # [S, P, B]
        dedupe = cfg.get("dedupe_window", 0)
        lateness = torch.tensor(cfg["lateness"], dtype=torch.float32)
        b = cfg["micro_batch"]
        c = self.counts
        for t0 in range(0, ticks, chunk):
            span = list(range(t0, min(ticks, t0 + chunk)))
            slots = torch.tensor([t % feed.p for t in span],
                                 device=feed.items.device)
            ts = torch.stack([feed.stamps(t) for t in span])    # [T, S, B]
            ok = pool_ok[:, slots].transpose(0, 1)              # [T, S, B]
            if dedupe:
                ids = torch.stack([feed.ids(t) for t in span])  # [T, S, B]
                first = first_in_batch(ids)
                dup = torch.stack([self._dedupe(ids[i], first[i], ok[i])
                                   for i in range(len(span))])
            else:
                dup = torch.zeros_like(ok)
            acc = ~dup & ok
            n_acc = acc.sum(-1)                                 # [T, S]
            n_dup = dup.sum(-1)
            c["items_offered"] += b * len(span)
            c["items_accepted"] += n_acc.sum(0)
            c["items_deduped"] += n_dup.sum(0)
            c["items_rejected"] += (b - n_acc - n_dup).sum(0)
            if "contract_lo" in cfg:
                viol = pool_viol[:, slots].transpose(0, 1)
                self.drift += (viol & ~dup[..., None]).sum((0, 2))
            # the watermark: each shard's running max of its dequeued
            # stamps; a fleet's reference is the least of the shards'
            # maxima as of the last tick, never rolled back
            tmax = torch.where(acc, ts, F32_MIN).amax(-1)       # [T, S]
            run_max = torch.cummax(torch.cat([self.max_ts[None], tmax]),
                                   0).values                    # [T + 1, S]
            if self.fleet:
                least = torch.cat([self.wm[None], run_max[:-1].amin(-1)])
                wm = torch.cummax(least, 0).values              # [T + 1]
                ref = wm[1:, None].expand_as(tmax)
                self.wm = wm[-1]
            else:
                ref = run_max[:-1]
            late = acc & (ts < (ref - lateness)[..., None])
            self.max_ts = run_max[-1]
            c["steps"] += len(span)
            c["items_dequeued"] += n_acc.sum(0)
            c["items_late"] += late.sum((0, 2))
            for i, t in enumerate(span):
                if t not in want and t + 1 not in want \
                        and i != len(span) - 1:
                    continue
                rows = torch.cat([ts[i][..., None],
                                  feed.items[:, t % feed.p]], -1)
                block, valid = self._block(rows, acc[i], late[i])
                if t in want:
                    done[t] = self._windows(block, valid)
                # the carry: the last rows of this tick's block
                keep = self.carry.shape[1]
                self.carry = block[:, -keep:]
                self.carry_valid = valid[:, -keep:]
        return done

    @staticmethod
    def _block(rows, acc, late):
        """A tick's dequeued block ``[S, B, 1 + D]``: its accepted rows in
        offer order, then the rest (not valid); valid are the accepted
        rows that are not late."""
        order = torch.argsort((~acc).to(torch.int8), dim=-1, stable=True)
        block = torch.gather(rows, 1, order[..., None].expand_as(rows))
        return block, torch.gather(acc & ~late, 1, order)

    def _windows(self, block, valid):
        """A checked tick's windows over the carry and its block, the two
        tiers, and the window counters' increments."""
        cfg = self.cfg
        seq = torch.cat([self.carry, block], 1)
        seq_valid = torch.cat([self.carry_valid, valid], 1)
        w = windows(seq, seq_valid, cfg["window"], cfg["stride"],
                    cfg["min_count"], self.rules)
        emit, cons = w["emit"], w["consequence"]
        candidate = emit & (cons == CODES["send_core"])
        processed, extra = self._select(candidate)
        inc = {
            "windows_emitted": emit.sum(-1),
            "rules_fired": (cons != 0).sum(-1),
            "windows_escalated": candidate.sum(-1),
            "windows_stored": (emit & (cons == CODES["store_edge"])).sum(-1),
            "windows_dropped": (emit & (cons == CODES["drop"])).sum(-1),
            "core_overflow": (candidate & ~processed).sum(-1),
        }
        inc = {k: v.tolist() for k, v in inc.items()}
        inc.update(extra)
        out = dict(w)
        out["escalated"] = candidate
        out["processed"] = processed
        out["core"] = core(w["record"][processed], self.p,
                           cfg["core_layers"])
        return inc, out

    def _dedupe(self, ids, first, ok):
        """One tick's re-deliveries ``[S, B]`` against each shard's
        window, which then remembers the tick's accepted ids."""
        # an identity is tested once, at its first place in the batch
        # (the window's entries and the tested ones are then distinct); a
        # later place is a re-delivery anyway
        b = ids.shape[-1]
        lone = torch.where(first, ids, -(1 << 40) - torch.arange(
            b, device=ids.device))
        dup = torch.stack([
            torch.isin(lone[s], self.ring[s], assume_unique=True)
            for s in range(self.shards_n)]) | ~first
        self._remember(ids, ~dup & ok)
        return dup

    def _remember(self, ids: torch.Tensor, accepted: torch.Tensor) -> None:
        """Write the accepted identities into each shard's window in offer order
        (only the last K of a tick when it accepts more)."""
        k = self.ring.shape[1]
        acc = accepted.to(torch.int64)
        rank = torch.cumsum(acc, -1) - 1
        n = acc.sum(-1, keepdim=True)
        keep = accepted & (rank >= n - k)
        slot = torch.where(keep, (self.ring_pos[:, None] + rank) % k, k)
        buf = torch.cat([self.ring, self.ring.new_zeros((self.shards_n, 1))],
                        1)
        buf.scatter_(1, slot, torch.where(keep, ids, 0))
        self.ring = buf[:, :k]
        self.ring_pos = (self.ring_pos + n[:, 0]) % k

    def counters(self) -> dict:
        """The cumulative admission counters and the per-field contract
        counts, ``{name: [S]}``, and a fleet's watermark."""
        out = {k: v.tolist() for k, v in self.counts.items()}
        out["drift_counts"] = self.drift.tolist()
        if self.fleet:
            out["watermark"] = float(self.wm)
        return out

    def _select(self, candidate: torch.Tensor):
        """Which candidates ``[S, NW]`` the core processes, and the
        fleet's exchange counters' increments for this tick."""
        cfg = self.cfg
        c64 = candidate.to(torch.int64)
        if not self.fleet:
            return candidate & (torch.cumsum(c64, -1)
                                <= cfg["core_capacity"]), {}
        r, e = cfg["num_regions"], cfg["edges_per_region"]
        nc = cfg["num_core"]
        nw = candidate.shape[-1]
        # region-local slots, edge-major: the first fog_budget survive
        q = torch.cumsum(c64.reshape(r, e * nw), -1).reshape(r, e, nw) - 1
        survive = candidate.reshape(r, e, nw) & (q < cfg["fog_budget"])
        per_region = survive.reshape(r, -1).sum(-1)
        roff = torch.cumsum(per_region, 0) - per_region
        # global slots, region-major: the first core_budget get the core;
        # slot g is served by core rank g % num_core (region 0's columns)
        g = roff[:, None, None] + q
        processed = survive & (g < cfg["core_budget"])
        sent = survive.sum(-1).reshape(-1)
        received = [0] * (r * e)
        core_done = [0] * (r * e)
        for col in range(nc):
            on = g % nc == col
            received[col] = int((survive & on).sum())
            core_done[col] = int((processed & on).sum())
        extra = {
            "escalations_sent": sent.tolist(),
            "fog_shed": (candidate.sum(-1) - sent).tolist(),
            "core_received": received,
            "core_processed": core_done,
            # rows late only against a straggler-exclusion reference:
            # the configuration excludes no shard
            "late_excluded": [0] * (r * e),
            "fleet_core_overflow": max(0, int(per_region.sum())
                                       - cfg["core_budget"]),
        }
        return processed.reshape(r * e, nw), extra
