"""The one generator of stream traffic: a pool of ticks made on the
device from the seed in set-up, then cycled.

A traffic file (``perfbench/traffic/<name>.json``) gives the mix:

- ``pool_ticks``: ticks in the pool (the feed repeats its rows after
  that many ticks, with new stamps);
- ``hot_run``, ``hot_feature``, ``hot_shift``: the pool's ticks
  alternate in runs of ``hot_run`` between cold (features N(0, 1)) and
  hot (``hot_feature`` shifted by ``hot_shift``), cold first;
- ``redeliver_share``: the share of a tick's rows that are exact
  re-sends of the previous tick's fresh rows, stamps and all, at
  positions drawn from the seed (a source that redelivers, as MQTT QoS 1
  or a Kafka consumer after a rebalance does);
- ``nan_rows``: fresh rows a tick with a NaN in one field (a sensor
  dropout), at positions and fields drawn from the seed.

The loop is closed: one micro-batch is offered a shard at every tick.

The configuration gives the sizes: ``micro_batch`` rows a shard a tick,
``features`` columns, and the shards.  Stamps are the row-index stamps
of the stream benchmark: row ``j`` of tick ``t`` is stamped ``t *
micro_batch + j`` as float32, a re-sent row keeps its first stamp.
A row's identity is the whole number ``t * micro_batch + j`` of its
first sending, which the feed knows exactly (``ids``): a re-delivery is
told from a fresh row by it, not by the row's contents.

Inside the measured window a tick costs one add (the stamps) and a view
of the pool; everything else is made in set-up, in a few large calls of
a ``torch.Generator`` on the device.  The same seed gives the same feed,
and the reference is handed the very tensors the program is.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Sampler:
    """Which ticks are checked: one in ``one_in`` on average, drawn from
    the seed, and always tick 0."""

    def __init__(self, seed: int, one_in: int):
        self.key, self.one_in = sub_seed(seed, 7), one_in

    def __call__(self, t: int) -> bool:
        if t == 0:
            return True
        x = (self.key ^ (t * 0x9E3779B97F4A7C15)) & (2 ** 64 - 1)
        x ^= x >> 31
        x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
        x ^= x >> 29
        return x % self.one_in == 0


class Feed:
    """The pool of one cell's traffic for ``shards`` (global shard ids):
    ``items [S, P, B, D]`` float32 and ``rel [S, P, B]`` float32 stamp
    offsets within the tick.  Each shard's rows come from its own
    generator, so a rank that holds some shards of a fleet makes the same
    rows for them as one card that holds them all."""

    def __init__(self, traffic: dict, cfg: dict, shards, seed: int, device):
        b, p = cfg["micro_batch"], traffic["pool_ticks"]
        self.b, self.p = b, p
        shards = list(shards)
        self.items = self.rel = None
        for i, s in enumerate(shards):
            items, rel = _shard_pool(traffic, cfg, sub_seed(seed, 100 + s),
                                     device)
            if len(shards) == 1:
                self.items, self.rel = items[None], rel[None]
                break
            if self.items is None:
                self.items = items.new_empty((len(shards),) + items.shape)
                self.rel = rel.new_empty((len(shards),) + rel.shape)
            self.items[i], self.rel[i] = items, rel
            del items, rel
        self._ts = torch.empty((len(shards), b), dtype=torch.float32,
                               device=device)

    def tick(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Tick ``t``'s offer: ``items [S, B, D]`` (a view of the pool)
        and ``ts [S, B]`` (a buffer this call rewrites: use it before the
        next call)."""
        k = t % self.p
        torch.add(self.rel[:, k], float(t * self.b), out=self._ts)
        return self.items[:, k], self._ts

    def stamps(self, t: int) -> torch.Tensor:
        """Tick ``t``'s stamps as a new tensor (for the reference)."""
        return self.rel[:, t % self.p] + float(t * self.b)

    def ids(self, t: int) -> torch.Tensor:
        """Tick ``t``'s row identities ``[S, B]`` int64: the exact
        ordinal of each row's first sending (a re-send carries its
        original's), for the reference."""
        return self.rel[:, t % self.p].to(torch.int64) + t * self.b


def _shard_pool(traffic: dict, cfg: dict, seed: int, device):
    """One shard's ``[P, B, D]`` rows and ``[P, B]`` stamp offsets."""
    b, d, p = cfg["micro_batch"], cfg["features"], traffic["pool_ticks"]
    gen = torch.Generator(device).manual_seed(seed)
    items = torch.randn((p, b, d), generator=gen, device=device)
    hot = torch.tensor([(k // traffic["hot_run"]) % 2 == 1
                        for k in range(p)], device=device)
    items[hot, :, traffic["hot_feature"]] += traffic["hot_shift"]
    n_dup = round(traffic["redeliver_share"] * b)
    n_nan = traffic["nan_rows"]
    rel = torch.arange(b, dtype=torch.float32, device=device) \
        .expand(p, b).clone()
    if not (n_dup or n_nan):
        return items, rel
    # a permutation a tick: its first n_dup positions are re-sends, the
    # next n_nan fresh rows carry a NaN
    perm = torch.argsort(torch.rand((p, b), generator=gen, device=device),
                         -1)
    ki = torch.arange(p, device=device)[:, None]
    nan_pos = perm[:, n_dup:n_dup + n_nan]
    field = torch.randint(0, d, nan_pos.shape, generator=gen, device=device)
    items[ki, nan_pos, field] = float("nan")
    if n_dup:
        # each re-send copies a fresh row of the previous tick (one of its
        # positions past n_dup), stamp and all
        pick = torch.argsort(torch.rand((p, b - n_dup), generator=gen,
                                        device=device), -1)[:, :n_dup]
        src = torch.gather(torch.roll(perm, 1, dims=0)[:, n_dup:], -1, pick)
        dup_pos = perm[:, :n_dup]
        items[ki, dup_pos] = items[(ki - 1) % p, src]
        rel[ki, dup_pos] = src.to(torch.float32) - b
    return items, rel
