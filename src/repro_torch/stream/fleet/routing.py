"""Tiered route plans for the hierarchical edge -> fog -> cloud fleet.

Port of ``repro.stream.fleet.routing``.  The escalation exchange has
two hops:

  hop 1 (within a region, the ``edge`` dim)
      every shard's fog-budget *survivors* go to the region's fog
      columns (edge columns ``0..num_core-1``);
  hop 2 (across regions, the ``region`` dim)
      each fog column forwards its compacted survivor batch to region 0
      (the cloud region holding the core ranks) in a buffer of
      ``[R, cross_capacity, row]`` -- ``cross_capacity`` derives from
      the *fog budget*, not from the fleet width.

Slot discipline: candidates get deterministic *region-local* slots
(edge-major), the first ``region_budget`` survive (the fog budget),
survivors get *global* slots (region-major), and the first
``core_budget`` global slots get core compute.

The slot arithmetic here works on torch tensors and broadcasts over
leading dims: a region dim, or a receiving column dim.
"""
from __future__ import annotations

import dataclasses

import torch


def region_survivor_counts(counts: torch.Tensor,
                           budget: torch.Tensor) -> torch.Tensor:
    """Per-edge survivor counts under a region escalation (fog) budget.

    ``counts``: ``[..., E]`` candidates per edge shard, in edge-major
    region-local slot order (edge e's candidate k holds region slot
    ``offset_e + k``).  ``budget``: the region's fog budget, broadcast
    against ``counts``' leading dims (``[..., 1]`` for one a region).  A
    candidate survives iff its region slot is ``< budget``, so survivors
    are a prefix of the region slot order: edge e keeps ``clip(budget -
    offset_e, 0, counts_e)``.  ``0 <= out <= counts`` and ``sum(out) ==
    min(sum(counts), max(budget, 0))``."""
    offsets = counts.cumsum(-1) - counts          # exclusive prefix
    return torch.minimum(torch.clamp(budget - offsets, min=0), counts)


def fog_recv_occupancy(surv_counts: torch.Tensor, col, region_offset,
                       num_core: int, capacity: int) -> torch.Tensor:
    """Receive-side occupancy of a fog column's hop-1 buffer.

    Survivors route by *global* slot (``g = region_offset + q``, ``q``
    the region-local slot) to fog column ``g % num_core``, so the first
    region-local slot landing on column ``col`` from edge ``e`` is
    ``(col - region_offset - offset_e) mod num_core`` past ``offset_e``.

    ``surv_counts``: ``[..., E]`` per-edge fog-budget survivor counts;
    ``col``: the receiving edge index and ``region_offset``: its
    region's exclusive prefix of survivor totals, both broadcast against
    ``surv_counts`` (a scalar each, or every column at once as ``col
    [E, 1]`` against ``surv_counts [R, 1, E]`` and ``region_offset
    [R, 1, 1]``).  Returns ``[..., E, capacity]`` bool occupancy (every
    cell is under the fog budget by construction)."""
    offsets = surv_counts.cumsum(-1) - surv_counts
    first = (col - region_offset - offsets) % num_core
    sent = torch.clamp(-(-(surv_counts - first) // num_core), min=0)
    k = torch.arange(capacity, dtype=surv_counts.dtype,
                     device=surv_counts.device)
    on_fog = torch.as_tensor(col, device=surv_counts.device) < num_core
    return (k < sent[..., None]) & on_fog[..., None]


@dataclasses.dataclass(frozen=True)
class TieredExchange:
    """Static geometry of the two-hop escalation exchange.

    ``edge_capacity`` is hop 1's per-(src, dest) slot count
    (``ceil(windows_per_step / num_core)``); ``cross_capacity`` is hop
    2's per-(region, region) slot count (``ceil(fog slots /
    num_core)``), sized by the budget, not the fleet width.
    """
    num_regions: int
    edges_per_region: int
    num_core: int
    edge_capacity: int
    cross_capacity: int

    def intra_region_bytes(self, record_width: int,
                           itemsize: int = 4) -> int:
        """One direction of hop 1, fleet-wide: every shard exchanges an
        ``[E, edge_capacity, row]`` buffer within its region."""
        e = self.edges_per_region
        return (self.num_regions * e * e * self.edge_capacity
                * record_width * itemsize)

    def cross_region_bytes(self, record_width: int,
                           itemsize: int = 4) -> int:
        """One direction of hop 2, fleet-wide: each region's
        ``num_core`` fog columns exchange an ``[R, cross_capacity,
        row]`` buffer across regions; independent of the region width."""
        r = self.num_regions
        return (r * self.num_core * r * self.cross_capacity
                * record_width * itemsize)

    def flat_exchange_bytes(self, record_width: int,
                            itemsize: int = 4) -> int:
        """What one fleet-wide exchange moves for the same topology:
        every shard exchanges an ``[R*E, edge_capacity, row]`` buffer."""
        s = self.num_regions * self.edges_per_region
        return s * s * self.edge_capacity * record_width * itemsize


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Where one rank's shards sit when the fleet's ``R x E`` shards
    (region-major) are laid over a ``(rank_regions, rank_edges)`` mesh of
    ranks (``("region", "edge")``, row-major: rank ``row * rank_edges +
    col``).  Each rank holds ``S / N`` consecutive shards: ``regions``
    whole regions' ``edges`` columns.  Either a rank's shards lie in one
    region (``rank_regions == R``, ``rank_edges`` divides ``E``) or a
    region's shards fill whole ranks (``rank_edges == 1``,
    ``rank_regions`` divides ``R``); :func:`rank_layout` raises on any
    other mesh."""
    num_regions: int
    edges_per_region: int
    rank_regions: int
    rank_edges: int
    row: int            # this rank's coordinate on the region dim
    col: int            # ... and on the edge dim

    @property
    def regions(self) -> int:
        """Regions a rank holds (part of one, or whole ones)."""
        return self.num_regions // self.rank_regions

    @property
    def edges(self) -> int:
        """Edge columns of each of its regions a rank holds."""
        return self.edges_per_region // self.rank_edges

    @property
    def shards(self) -> int:
        """Shards a rank holds, ``S / N``."""
        return self.regions * self.edges

    @property
    def first_region(self) -> int:
        return self.row * self.regions

    @property
    def first_col(self) -> int:
        return self.col * self.edges

    @property
    def first_shard(self) -> int:
        """The global index of this rank's first shard (region-major)."""
        return (self.row * self.rank_edges + self.col) * self.shards


def rank_layout(num_regions: int, edges_per_region: int, rank_regions: int,
                rank_edges: int, row: int = 0, col: int = 0) -> RankLayout:
    """The layout of ``num_regions x edges_per_region`` shards over a
    ``(rank_regions, rank_edges)`` mesh of ranks, seen from rank
    ``(row, col)``; raises when the ranks cannot hold the shards as
    whole runs (see :class:`RankLayout`)."""
    rr, ee = num_regions, edges_per_region
    n = rank_regions * rank_edges
    one_region = rank_regions == rr and ee % rank_edges == 0
    whole_regions = rank_edges == 1 and rr % rank_regions == 0
    if not (one_region or whole_regions):
        raise ValueError(
            f"a ({rank_regions}, {rank_edges}) mesh of {n} ranks cannot hold "
            f"{rr} regions of {ee} shards: a rank's shards must lie in one "
            "region, or a region's shards fill whole ranks")
    if not (0 <= row < rank_regions and 0 <= col < rank_edges):
        raise ValueError(f"rank ({row}, {col}) is off a ({rank_regions}, "
                         f"{rank_edges}) mesh")
    return RankLayout(rr, ee, rank_regions, rank_edges, row, col)


def rank_mesh_shape(num_regions: int, edges_per_region: int,
                    ranks: int) -> tuple[int, int]:
    """The ``(region, edge)`` mesh shape that lays the shards over
    ``ranks`` ranks: ``(R, N / R)`` when each region spans ``N / R``
    ranks, else ``(N, 1)`` when each rank holds ``R / N`` whole regions;
    raises when neither holds."""
    rr, ee = num_regions, edges_per_region
    if ranks % rr == 0 and ee % (ranks // rr) == 0:
        shape = (rr, ranks // rr)
    elif rr % ranks == 0:
        shape = (ranks, 1)
    else:
        raise ValueError(f"{ranks} ranks cannot hold {rr} regions of {ee} "
                         "shards: a rank's shards must lie in one region, "
                         "or a region's shards fill whole ranks")
    rank_layout(rr, ee, *shape)
    return shape
