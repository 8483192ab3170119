"""The port's ``core.overlay`` and the AR half of ``core.routing``
(``route_local``, ``rank_of_message``) against the JAX package, bit
for bit, and the RP-failure arc of ``tests/test_system.py`` replayed
on the port."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import profiles as JP
from repro.core import routing as JR
from repro.core import sfc as JS
from repro.core.overlay import Overlay as JOverlay
from repro_torch.core import routing as TR
from repro_torch.core import store as TS
from repro_torch.core.overlay import Overlay as TOverlay
from repro_torch.kernels import checks
from repro_torch.kernels.hilbert import hilbert_xy2d
from repro_torch.testing import assert_bitwise


def _regions(ov):
    return sorted((n.x0, n.y0, n.size, n.depth, n.master,
                   tuple(sorted(n.members.tolist()))) for n in ov.leaves())


def _same_overlay(jo, to, granularities=(2, 4, 6)):
    assert _regions(jo) == _regions(to)
    n = len(jo.coords)
    for r in range(n):
        np.testing.assert_array_equal(to.replicas_of(r), jo.replicas_of(r))
        assert to.master_of(r) == jo.master_of(r)
    for g in granularities:
        t, j = to.routing_table(g), jo.routing_table(g)
        assert t.dtype == j.dtype == np.int32
        np.testing.assert_array_equal(t, j, err_msg=f"routing table g{g}")


@pytest.mark.parametrize("rows,cols,capacity,replication", [
    (4, 4, 2, 2), (16, 16, 4, 2), (3, 5, 1, 3)])
def test_overlay_equals_jax(rows, cols, capacity, replication):
    kw = dict(capacity=capacity, replication=replication)
    jo = JOverlay.from_mesh_shape(rows, cols, **kw)
    to = TOverlay.from_mesh_shape(rows, cols, **kw)
    _same_overlay(jo, to)
    # membership changes: failures (routing falls back to replicas), a join
    for dead in (0, rows * cols - 1, (rows * cols) // 2):
        jo, to = jo.on_failure(dead), to.on_failure(dead)
        _same_overlay(jo, to)
        for r in np.nonzero(~to.alive)[0]:
            np.testing.assert_array_equal(to.replicas_of_dead(int(r)),
                                          jo.replicas_of_dead(int(r)))
    jo, to = jo.on_join(0), to.on_join(0)
    _same_overlay(jo, to)


@pytest.mark.parametrize("granularity,num_ranks,capacity", [
    (4, 16, 8), (6, 16, 64), (8, 256, 4)])
def test_route_local_and_rank_of_message_equal_jax(granularity, num_ranks,
                                                   capacity):
    rng = np.random.default_rng(granularity)
    side = int(np.sqrt(num_ranks))
    table = JOverlay.from_mesh_shape(side, side, capacity=4) \
        .routing_table(granularity)
    profs = checks.random_profiles(rng, 700, wildcard=0.05)
    payload = rng.standard_normal((700, 5)).astype(np.float32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    ranks = TR.rank_of_message(torch.from_numpy(profs), tt)
    assert_bitwise(ranks, JR.rank_of_message(jnp.asarray(profs), jt),
                   "rank_of_message")
    idx = JS.profile_index(jnp.asarray(profs))
    jsend, jplan = JR.route_local(jnp.asarray(payload), idx, jt, num_ranks,
                                  capacity)
    tsend, tplan = TR.route_local(torch.from_numpy(payload),
                                  torch.from_numpy(np.array(idx)), tt,
                                  num_ranks, capacity)
    assert_bitwise(tsend, jsend, "send buffer")
    for f in JR.DispatchPlan._fields:
        assert_bitwise(getattr(tplan, f), getattr(jplan, f), f"plan {f}")
    assert_bitwise(tplan.dest, ranks, "route_local dest == rank_of_message")
    if capacity < 700 // num_ranks:
        assert int(tplan.overflow.sum()) > 0      # the capacity binds
    assert int(tplan.counts.sum() + tplan.overflow.sum()) == 700


def test_rp_failure_data_survives_on_the_port():
    """``tests/test_system.py``'s arc: store to the owner and its region
    replicas; kill the owner; the routing table fails over to a replica
    that holds the data."""
    ov = TOverlay.from_mesh_shape(4, 4, capacity=2, replication=2)
    key = torch.from_numpy(JP.profile("Drone", "LiDAR"))
    table = torch.from_numpy(ov.routing_table(granularity=4))
    before = hilbert_xy2d.launches
    rank = int(TR.rank_of_message(key[None], table)[0])
    assert hilbert_xy2d.launches == before        # plain loop on the CPU
    replicas = ov.replicas_of(rank)
    assert len(replicas) >= 2
    shards = {int(r): TS.init_store(8, 2, device="cpu") for r in replicas}
    for r in shards:
        shards[r] = TS.store(shards[r], key[None], torch.ones((1, 2)) * 42.0)
    ov2 = ov.on_failure(rank)
    table2 = torch.from_numpy(ov2.routing_table(granularity=4))
    new_rank = int(TR.rank_of_message(key[None], table2)[0])
    assert new_rank != rank
    assert new_rank in shards, (rank, replicas, new_rank)
    val, found = TS.query_exact(shards[new_rank], key)
    assert bool(found) and float(val[0]) == 42.0
    # the same ranks as the reference's arc
    jov = JOverlay.from_mesh_shape(4, 4, capacity=2, replication=2)
    jrank = int(JR.rank_of_message(jnp.asarray(key.numpy())[None],
                                   jnp.asarray(jov.routing_table(4)))[0])
    jnew = int(JR.rank_of_message(
        jnp.asarray(key.numpy())[None],
        jnp.asarray(jov.on_failure(jrank).routing_table(4)))[0])
    assert (rank, new_rank) == (jrank, jnew)
