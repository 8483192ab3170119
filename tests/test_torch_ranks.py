"""The port across ranks: ``launch.mesh.spawn`` and ``make_host_mesh``
over N processes, and the AR route step and the cross-pod all-reduce in
their per-rank forms (``route_and_deliver(..., group=)``,
``cross_pod_allreduce(..., group=)``), on the CPU: one process a rank,
gloo over a ``FileStore``, one intra-op thread each.

The route step and the all-reduce run on 8 ranks as a ``(2, 4)``
``("pod", "data")`` mesh with ``tests/test_multidevice.py``'s inputs and
seeds, held bitwise against the reference under ``shard_map`` on a
``(2, 4)`` mesh of 8 forced host devices (one subprocess), and against
the port's own stacked one-card forms.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import routing as TR
from repro_torch.core.overlay import Overlay
from repro_torch.launch import mesh as M
from repro_torch.runtime import compression as TC
from repro_torch.testing import assert_bitwise

SRC = Path(__file__).resolve().parents[1] / "src"
N_LOCAL, D, CAP, RANKS = 32, 4, 16, 8


def _inputs():
    """``test_multidevice``'s inputs, drawn in its order from seed 0: the
    routing table of a 2 x 4 overlay at granularity 4, 8 x 32 payloads
    and curve ids, and the 8 x 16 gradient."""
    table = Overlay.from_mesh_shape(2, 4, capacity=2).routing_table(
        granularity=4)
    rng = np.random.default_rng(0)
    payload = rng.standard_normal((RANKS * N_LOCAL, D)).astype(np.float32)
    idx = rng.integers(0, 2**32, RANKS * N_LOCAL, dtype=np.uint32) \
        .astype(np.int32)
    w = rng.standard_normal(RANKS * 16).astype(np.float32)
    return table, payload, idx, w


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.core import routing
    from repro.core.overlay import Overlay
    from repro.runtime.compression import cross_pod_allreduce, init_errors

    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    ov = Overlay.from_mesh_shape(2, 4, capacity=2)
    table = jnp.asarray(ov.routing_table(granularity=4))
    N_LOCAL, D, CAP = 32, 4, 16
    rng = np.random.default_rng(0)
    payload = jnp.asarray(rng.standard_normal((8 * N_LOCAL, D)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 2**32, 8 * N_LOCAL, dtype=np.uint32)
                      .astype(np.int32))
    spec = P(("pod", "data"))

    def route(payload, idx):
        return routing.route_and_deliver(payload, idx, table,
                                         ("pod", "data"), 8, CAP)

    recv, counts = jax.jit(shard_map(route, mesh=mesh, in_specs=(spec, spec),
                                     out_specs=(spec, spec)))(payload, idx)
    g_local = {"w": jnp.asarray(rng.standard_normal(8 * 16), jnp.float32)}

    def sync(g):
        return cross_pod_allreduce(g, init_errors(g), axis_name="pod")

    synced, errs = jax.jit(shard_map(
        sync, mesh=mesh, in_specs=({"w": spec},),
        out_specs=({"w": spec}, {"w": spec})))(g_local)
    np.savez(sys.argv[1], recv=np.asarray(recv), counts=np.asarray(counts),
             synced=np.asarray(synced["w"]), errs=np.asarray(errs["w"]))
""")


def _rank_route_and_sync(rank: int, device) -> dict:
    """One rank of the ``(2, 4)`` ``("pod", "data")`` mesh: its 32
    messages routed over all 8 ranks, its 16 gradient values reduced
    over its pod group."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    table, payload, idx, w = _inputs()
    rows = slice(rank * N_LOCAL, (rank + 1) * N_LOCAL)
    recv, counts = TR.route_and_deliver(
        torch.from_numpy(payload[rows]), torch.from_numpy(idx[rows]),
        torch.from_numpy(table), RANKS, CAP, group=dist.group.WORLD)
    g = {"w": torch.from_numpy(w[rank * 16:(rank + 1) * 16])}
    synced, errs = TC.cross_pod_allreduce(g, TC.init_errors(g),
                                          group=mesh.get_group("pod"))
    return {"recv": recv.numpy(), "counts": counts.numpy(),
            "synced": synced["w"].numpy(), "errs": errs["w"].numpy(),
            "coords": (mesh.get_local_rank("pod"),
                       mesh.get_local_rank("data")),
            "sent": M.COLLECTIVES.sent_bytes}


@pytest.fixture(scope="module")
def ranks8():
    """The 8 ranks' results, in rank order."""
    return M.spawn(_rank_route_and_sync, RANKS, "cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's route step and all-reduce under ``shard_map`` on
    8 forced host devices, as global arrays."""
    tmp = tmp_path_factory.mktemp("ranks_ref")
    (tmp / "ref.py").write_text(_REFERENCE)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(tmp / "ref.py"),
                        str(tmp / "ref.npz")], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("key", ["recv", "counts", "synced", "errs"])
def test_ranks_equal_the_reference_under_shard_map(ranks8, reference, key):
    """Each rank's received buffer and counts, synced gradient and new
    errors equal its block of the reference's global outputs, bitwise."""
    got = np.concatenate([r[key] for r in ranks8])
    assert_bitwise(got, reference[key], key)


def test_route_over_ranks_is_the_stacked_form(ranks8):
    """The per-rank route step equals the stacked one-card form on the
    8 ranks' batches at once, and every kept message arrived at the rank
    the table names."""
    table, payload, idx, _ = _inputs()
    t = torch.from_numpy(table)
    recv, counts = TR.route_and_deliver(
        torch.from_numpy(payload).reshape(RANKS, N_LOCAL, D),
        torch.from_numpy(idx).reshape(RANKS, N_LOCAL), t, RANKS, CAP)
    for r, res in enumerate(ranks8):
        assert_bitwise(res["recv"], recv[r].numpy(), f"rank {r} recv")
        assert_bitwise(res["counts"], counts[r].numpy(), f"rank {r} counts")
    owner = TR._owner(torch.from_numpy(idx), t).numpy().reshape(RANKS, -1)
    for r, res in enumerate(ranks8):
        for src in range(RANKS):
            n = res["counts"][src]
            mine = payload.reshape(RANKS, N_LOCAL, D)[src][owner[src] == r]
            assert_bitwise(res["recv"][src, :n], mine[:n], f"{src}->{r}")
    assert 0 < sum(int(r["counts"].sum()) for r in ranks8) <= RANKS * N_LOCAL


def test_allreduce_over_ranks_is_the_dim0_form(ranks8):
    """Each pod group's synced mean and errors equal the dim-0 form on
    its two pods' rows, bitwise; the mesh is the reference's ``(2, 4)``
    in rank order."""
    _, _, _, w = _inputs()
    grid = w.reshape(2, 4, 16)
    assert [r["coords"] for r in ranks8] == [(p, d) for p in range(2)
                                             for d in range(4)]
    for d in range(4):
        g = {"w": torch.from_numpy(grid[:, d])}
        synced, errs = TC.cross_pod_allreduce(g, TC.init_errors(g))
        for p in range(2):
            res = ranks8[p * 4 + d]
            assert_bitwise(res["synced"], synced["w"][p].numpy(), f"{p},{d}")
            assert_bitwise(res["errs"], errs["w"][p].numpy(), f"{p},{d}")


def test_collective_bytes_are_counted(ranks8):
    """What each rank sent: the route step's two all-to-alls (7 of 8
    chunks of the ``[8, 16, 4]`` float32 buffer and of the ``[8, 1]``
    counts) and the all-reduce's two over a pod pair (the amax and the
    16 sums, once to the peer); the all-reduce ``spawn`` makes to prove
    the group works is not counted."""
    want = (8 * CAP * D * 4 * 7 // 8 + 8 * 4 * 7 // 8 + 4 + 16 * 4)
    assert {r["sent"] for r in ranks8} == {want}


def _host_meshes(rank: int, device) -> dict:
    flat = M.make_host_mesh(device="cpu")
    wide = M.make_host_mesh(model=2, device="cpu")
    try:
        M.make_host_mesh(model=3, device="cpu")
        odd = "no error"
    except ValueError as e:
        odd = str(e)
    return {"flat": (flat.mesh_dim_names, tuple(flat.mesh.shape)),
            "wide": (wide.mesh_dim_names, tuple(wide.mesh.shape)),
            "same": M.make_host_mesh(device="cpu") is flat, "odd": odd,
            "world": dist.get_world_size(), "backend": dist.get_backend()}


def test_host_mesh_spans_the_ranks():
    """Over 4 ranks the host mesh is ``(4, 1)`` ``("data", "model")``,
    ``(2, 2)`` with ``model=2``, made once a process; a width that does
    not divide the ranks raises, as the reference's assert."""
    for res in M.spawn(_host_meshes, 4, "cpu"):
        assert res["flat"] == (("data", "model"), (4, 1))
        assert res["wide"] == (("data", "model"), (2, 2))
        assert res["same"] and res["world"] == 4
        assert res["backend"] == "gloo"
        assert "does not divide 4 rank(s)" in res["odd"]


def _card_rank(rank: int, device) -> str:
    return str(device)


def test_a_rank_without_its_card_raises():
    """A card run on a machine with fewer cards than ranks fails in the
    rank that has none: it never goes on on the CPU."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("this machine has a card for each of 2 ranks")
    with pytest.raises(Exception, match="has no card of its own"):
        M.spawn(_card_rank, 2, "cuda")
    with pytest.raises(RuntimeError, match="has no card of its own"):
        M.rank_device(torch.cuda.device_count(), "cuda")


def test_rank_device_on_the_cpu():
    assert M.rank_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        M.rank_device(0, "meta")


def test_spawn_returns_rank_order_and_raises_a_rank_error():
    out = M.spawn(_card_rank, 3, "cpu")
    assert out == ["cpu"] * 3
    with pytest.raises(ValueError, match=">= 1 rank"):
        M.spawn(_card_rank, 0, "cpu")
