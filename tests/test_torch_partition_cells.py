"""The port's dry-run collectives (``launch.probe.decompose`` over
``launch.partition``) against the reference's, cell by cell, on the CPU.

Cells: yi_6b, mixtral_8x7b, rwkv6_7b and recurrentgemma_2b at their
smoke configs; train, prefill and decode at 8 sequences of 64 tokens;
a ``(2, 4)`` ``("data", "model")`` mesh.  A module-scoped subprocess
runs the reference's own ``probe._lower_cost`` and ``probe_cfg``
decomposition live on 8 forced host devices, with the three small
shapes added to its ``SHAPES`` at run time and a mesh built with Auto
axes (``jax.make_mesh`` without ``axis_types`` gives Explicit axes on
jax 0.9, which the reference's ``shardctx.constrain`` refuses).  The
JAX package is not edited.  Two things differ from the reference's own
run, both said here:

* its module's collectives are read with the port's
  ``hlo.collective_stats``, which counts every element of a
  tuple-shaped collective: the reference's scan counts XLA's combined
  all-reduces by their last element (and misses those of more than five
  elements), most of a training step's gradient reductions;
* both sides compute in float32: XLA on the CPU computes bfloat16
  products in float32, which the port, counting what the card would
  move, would count at 2 bytes.

The port's whole-program collective bytes must be within 25% of the
reference's in each of the 12 cells; a failure prints both per-kind
breakdowns."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import probe
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import AbstractMesh

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("yi_6b", "mixtral_8x7b", "rwkv6_7b", "recurrentgemma_2b")
SHAPES = {"train": "cell_train", "prefill": "cell_prefill",
          "decode": "cell_decode"}
BATCH, SEQ = 8, 64
TOLERANCE = 0.25

_REF = textwrap.dedent('''
    import dataclasses, json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import registry
    from repro.launch import probe
    from repro_torch.launch import hlo
    probe.hlo_mod.collective_stats = hlo.collective_stats
    ARCHS, SHAPES, B, S = %(args)s
    for kind, name in SHAPES.items():
        registry.SHAPES[name] = {"seq_len": S, "global_batch": B,
                                 "kind": kind}
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(registry.smoke_config(arch),
                                  compute_dtype=jnp.float32)
        counts = probe.kind_counts(cfg)
        for kind, name in SHAPES.items():
            def cost(k):
                return probe._lower_cost(probe.probe_cfg(cfg, k, S), name,
                                         mesh, sequence_shard=True)
            p0 = cost(None)
            total = p0["collective_bytes"]
            kinds = {k: dict(v) for k, v in p0["collectives"].items()}
            for k, n in counts.items():
                pk = cost(k)
                total += (pk["collective_bytes"] - p0["collective_bytes"]) * n
                for c in set(pk["collectives"]) | set(p0["collectives"]):
                    a = pk["collectives"].get(c, {"count": 0, "bytes": 0})
                    b = p0["collectives"].get(c, {"count": 0, "bytes": 0})
                    d = kinds.setdefault(c, {"count": 0, "bytes": 0})
                    for f in ("count", "bytes"):
                        d[f] += (a[f] - b[f]) * n
            out[f"{arch}/{kind}"] = {"total": total, "kinds": kinds}
    print(json.dumps(out))
''') % {"args": (ARCHS, SHAPES, BATCH, SEQ)}


def reference_cells() -> dict:
    """``{"arch/kind": {"total": whole-program bytes, "kinds": {kind:
    {"count", "bytes"}} per device}}`` from the reference's probes."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    return reference_cells()


def port_cell(arch: str, kind: str) -> dict:
    """The port's decomposed collectives of one cell, as
    :func:`reference` gives the reference's."""
    cfg = dataclasses.replace(smoke_config(arch),
                              compute_dtype=torch.float32)
    mesh = AbstractMesh((2, 4), ("data", "model"))

    def cost(c, **kw):
        args = {"train": (SP.train_batch_spec(c, BATCH, SEQ),),
                "prefill": (SP.prefill_batch_spec(c, BATCH, SEQ),),
                "decode": SP.decode_specs(c, BATCH, SEQ)}[kind]
        return probe._lower_cost(c, kind, args, mesh, sequence_shard=True,
                                 **kw)

    _, _, total = probe.decompose(cfg, SEQ, cost)
    return {"total": total["collective_bytes"],
            "kinds": total["collectives"]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_cell_within_a_quarter_of_the_reference(reference, arch, kind):
    want = reference[f"{arch}/{kind}"]
    got = port_cell(arch, kind)
    assert want["total"] > 0 and got["total"] > 0
    ratio = got["total"] / want["total"]
    assert abs(ratio - 1.0) <= TOLERANCE, (
        f"{arch} {kind}: port {got['total']:.0f} B, reference "
        f"{want['total']:.0f} B (ratio {ratio:.3f}); per device by kind: "
        f"port {got['kinds']}, reference {want['kinds']}")


if __name__ == "__main__":      # the table the records cite
    ref = reference_cells()
    for arch in ARCHS:
        for kind in SHAPES:
            want = ref[f"{arch}/{kind}"]["total"]
            got = port_cell(arch, kind)["total"]
            print(f"{arch} {kind}: port {got:.0f} B, reference {want:.0f} "
                  f"B, ratio {got / want:.3f}")
