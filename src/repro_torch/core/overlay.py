"""Location-aware quadtree overlay (paper §IV-A).

Port of ``repro.core.overlay``, which is numpy throughout: a copy, with
:meth:`Overlay.routing_table` computing its cells through the port's
``sfc.index_to_rank`` on a CPU tensor.  The table it returns is numpy;
the caller moves it to the device.

The paper organizes Rendezvous Points (RPs) geographically in a point
quadtree; every split spawns four P2P rings, each with a master elected
per region, keep-alive based failure detection, and >= n replicas per
region.

Each RP has a position on a 2-D grid, which *is* the geography: the
quadtree recursively splits the grid until each leaf ("ring") holds at
most ``capacity`` RPs.  Masters are elected deterministically (lowest
surviving rank — in a fail-stop world this has the same guarantees as
Hirschberg–Sinclair with zero messages).  The tree is a pure host-side
structure, cheap to rebuild after any membership change, and it
compiles down to a flat *routing table* (SFC cell -> owner rank) that
lives on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import sfc


@dataclasses.dataclass
class QuadNode:
    x0: int
    y0: int
    size: int                      # square side, power of two
    depth: int
    members: np.ndarray            # ranks of live RPs inside this box
    children: list["QuadNode"] | None = None   # NW, NE, SW, SE order

    @property
    def is_leaf(self) -> bool:
        return self.children is None

    @property
    def master(self) -> int:
        return int(self.members.min()) if self.members.size else -1


@dataclasses.dataclass
class Overlay:
    """Quadtree over RP grid positions + derived device routing table."""
    root: QuadNode
    coords: np.ndarray             # [num_ranks, 2] grid position per rank
    alive: np.ndarray              # [num_ranks] bool
    order: int                     # SFC order of the identifier space
    capacity: int
    replication: int

    # ---------------- construction ----------------

    @staticmethod
    def build(coords: np.ndarray, *, order: int = sfc.DEFAULT_ORDER,
              capacity: int = 4, replication: int = 2,
              alive: np.ndarray | None = None) -> "Overlay":
        coords = np.asarray(coords, np.int64)
        n = len(coords)
        alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
        side = 1
        hi = int(coords.max()) + 1 if n else 1
        while side < hi:
            side *= 2
        live_ranks = np.nonzero(alive)[0]
        root = QuadNode(0, 0, side, 0, live_ranks)
        ov = Overlay(root, coords, alive, order, capacity, replication)
        ov._split(root)
        return ov

    @staticmethod
    def from_mesh_shape(rows: int, cols: int, **kw) -> "Overlay":
        """Place rank r at grid (r // cols, r % cols) of a rows x cols grid."""
        rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
        coords = np.stack([rr.ravel(), cc.ravel()], axis=1)
        return Overlay.build(coords, **kw)

    def _split(self, node: QuadNode) -> None:
        if node.members.size <= self.capacity or node.size <= 1:
            return
        h = node.size // 2
        node.children = []
        for dy in (0, h):
            for dx in (0, h):
                box = (node.x0 + dx, node.y0 + dy, h)
                m = node.members
                c = self.coords[m]
                inside = ((c[:, 0] >= box[0]) & (c[:, 0] < box[0] + h)
                          & (c[:, 1] >= box[1]) & (c[:, 1] < box[1] + h))
                child = QuadNode(box[0], box[1], h, node.depth + 1, m[inside])
                node.children.append(child)
                self._split(child)

    # ---------------- queries ----------------

    def leaves(self) -> Iterator[QuadNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.is_leaf:
                yield n
            else:
                stack.extend(n.children)

    def locate(self, x: int, y: int) -> QuadNode:
        """Leaf region containing grid point (x, y)."""
        node = self.root
        while not node.is_leaf:
            h = node.size // 2
            ix = int(x >= node.x0 + h)
            iy = int(y >= node.y0 + h)
            node = node.children[iy * 2 + ix]
        return node

    def region_of(self, rank: int) -> QuadNode:
        x, y = self.coords[rank]
        return self.locate(int(x), int(y))

    def master_of(self, rank: int) -> int:
        return self.region_of(rank).master

    def replicas_of(self, rank: int) -> np.ndarray:
        """Replica set: the k lowest-rank live members of rank's region,
        walking up the tree if the leaf is too small (paper: each region
        must contain >= n RPs for replication)."""
        node = self.region_of(rank)
        # walk up until we have enough members
        path = self._path_to(node)
        for n in reversed(path):
            if n.members.size >= self.replication:
                ms = np.sort(n.members)
                sel = ms[ms != rank][: self.replication - 1]
                return np.concatenate([[rank], sel]).astype(np.int64)
        return np.array([rank], np.int64)

    def _path_to(self, target: QuadNode) -> list[QuadNode]:
        path = []
        node = self.root
        while True:
            path.append(node)
            if node is target or node.is_leaf:
                return path
            h = node.size // 2
            ix = int(target.x0 >= node.x0 + h)
            iy = int(target.y0 >= node.y0 + h)
            node = node.children[iy * 2 + ix]

    # ---------------- membership changes (fail-stop / elastic) ----------------

    def on_failure(self, rank: int) -> "Overlay":
        """RP failure: rebuild tree without it; masters re-elected
        deterministically.  Data it owned survives on its region replicas."""
        alive = self.alive.copy()
        alive[rank] = False
        return Overlay.build(self.coords, order=self.order, capacity=self.capacity,
                             replication=self.replication, alive=alive)

    def on_join(self, rank: int) -> "Overlay":
        alive = self.alive.copy()
        alive[rank] = True
        return Overlay.build(self.coords, order=self.order, capacity=self.capacity,
                             replication=self.replication, alive=alive)

    # ---------------- device routing table ----------------

    def routing_table(self, granularity: int = 8) -> np.ndarray:
        """Flat SFC-cell -> owner-rank table, [4^granularity] int32.

        The curve index space (2*order bits) is cut into 4^granularity
        equal cells; each cell is owned by the live RP whose own SFC
        position is the partition owner — dead RPs' cells fall back to
        their lowest-rank region replica (paper: region replication).
        This is the structure the data plane gathers from; it replaces
        the paper's multi-hop P2P lookup with one table lookup.
        """
        n_cells = 4 ** granularity
        n_ranks = len(self.coords)
        cell_rank = sfc.index_to_rank(torch.from_numpy(
            np.arange(n_cells, dtype=np.int64).astype(np.uint32).view(np.int32)),
            n_ranks, granularity)
        table = cell_rank.numpy().astype(np.int32)
        if not self.alive.all():
            remap = np.arange(n_ranks, dtype=np.int32)
            for r in np.nonzero(~self.alive)[0]:
                reps = self.replicas_of_dead(int(r))
                remap[r] = reps[0] if reps.size else -1
            table = remap[table]
        return table

    def replicas_of_dead(self, rank: int) -> np.ndarray:
        """Live members of the region the dead rank belonged to."""
        x, y = self.coords[rank]
        node = self.locate(int(x), int(y))
        path = self._path_to(node)
        for n in reversed(path):
            if n.members.size:
                return np.sort(n.members)[: self.replication]
        return np.array([], np.int64)
