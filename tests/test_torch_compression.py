"""The port's gradient compression (``repro_torch.runtime.compression``)
against ``repro.runtime.compression``, bitwise, on the CPU: int8
quantization (half-to-even ties included), the tree helpers and the
error feedback carried over steps, and the cross-pod all-reduce.

The reference's all-reduce runs under ``shard_map`` over a ``pod`` axis
of 4; XLA fixes the device count when JAX starts, so a subprocess runs
it on 4 forced host devices and writes an ``.npz``.  The port takes the
pod axis as the leading tensor dim."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.runtime import compression as JC
from repro_torch.runtime import compression as C
from repro_torch.testing import assert_bitwise

SRC = Path(__file__).resolve().parents[1] / "src"
PODS, N = 4, 96


def _grads(seed, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or {"w": (6, 8), "b": (5,)}
    return {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-4, 2, s))
            .astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("case", ["ties", "random", "zeros", "bf16"])
def test_quantize_matches_jax(case):
    """Values on exact halves of the scale round half to even, as
    ``jnp.round``; an all-zero tensor takes scale 1."""
    if case == "ties":
        g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, -3.5, 126.5],
                     np.float32)
    elif case == "zeros":
        g = np.zeros(7, np.float32)
    else:
        g = _grads(1)["w"]
    jg = jnp.asarray(g, jnp.bfloat16 if case == "bf16" else jnp.float32)
    tg = torch.from_numpy(g).to(torch.bfloat16 if case == "bf16"
                                else torch.float32)
    want, got = JC.quantize(jg), C.quantize(tg)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert_bitwise(got.q, np.asarray(want.q), "q")
    assert_bitwise(got.scale, np.asarray(want.scale), "scale")
    assert_bitwise(C.dequantize(got), np.asarray(JC.dequantize(want)),
                   "dequantize")
    if case == "ties":
        assert got.q.tolist() == [127, 0, 2, 2, 0, -2, -4, 126]


def test_compress_tree_and_error_feedback_match_jax():
    """Three steps of compress -> carry the residual, on a nested tree:
    payloads, scales, errors and the decompressed tree bitwise."""
    shapes = {"a": {"w": (4, 3), "b": (3,)}, "c": (7,)}

    def nest(flat, like):
        return {k: nest(flat, v) if isinstance(v, dict) else flat.pop(0)
                for k, v in like.items()}

    jerr = terr = None
    for step in range(3):
        rng = np.random.default_rng(step)
        flat = [(rng.standard_normal(s) * 1e-3).astype(np.float32)
                for s in ((4, 3), (3,), (7,))]
        g = nest(list(flat), shapes)
        jg = {"a": {k: jnp.asarray(v) for k, v in g["a"].items()},
              "c": jnp.asarray(g["c"])}
        tg = {"a": {k: torch.from_numpy(v) for k, v in g["a"].items()},
              "c": torch.from_numpy(g["c"])}
        if terr is None:
            jerr, terr = JC.init_errors(jg), C.init_errors(tg)
        jcomp, jerr = JC.compress_tree(jg, jerr)
        tcomp, terr = C.compress_tree(tg, terr)
        for path in (("a", "w"), ("a", "b"), ("c",)):
            jc, tc, je, te = jcomp, tcomp, jerr, terr
            for k in path:
                jc, tc, je, te = jc[k], tc[k], je[k], te[k]
            assert_bitwise(tc.q, np.asarray(jc.q), f"{path} q")
            assert_bitwise(tc.scale, np.asarray(jc.scale), f"{path} scale")
            assert_bitwise(te, np.asarray(je), f"{path} error")
        jd, td = JC.decompress_tree(jcomp), C.decompress_tree(tcomp)
        assert_bitwise(td["c"], np.asarray(jd["c"]), "decompressed")


def test_error_feedback_accumulates():
    """The reference's case: tiny values vanish in int8, and the residual
    is carried, not lost."""
    g = {"w": torch.tensor([1e-4, 2e-4, 1.0])}
    comp, errs = C.compress_tree(g, C.init_errors(g))
    assert float(errs["w"][0].abs()) > 0
    np.testing.assert_allclose((C.dequantize(comp["w"]) + errs["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6)


_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    from repro.runtime.compression import cross_pod_allreduce, init_errors

    pods, n = int(sys.argv[2]), int(sys.argv[3])
    mesh = jax.make_mesh((pods,), ("pod",))
    rng = np.random.default_rng(0)
    scales = 10.0 ** rng.integers(-3, 2, pods * n)
    grads = [{"w": (rng.standard_normal(pods * n) * scales)
              .astype(np.float32),
              "b": rng.standard_normal(pods * 4).astype(np.float32)}
             for _ in range(3)]
    spec = {"w": P("pod"), "b": P("pod")}
    sync = jax.jit(shard_map(
        lambda g, e: cross_pod_allreduce(g, e, axis_name="pod"), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec)))
    errs = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), grads[0])
    out = {}
    for step, g in enumerate(grads):
        synced, errs = sync(g, errs)
        for k in g:
            out[f"g{step}_{k}"] = g[k]
            out[f"synced{step}_{k}"] = np.asarray(synced[k])
            out[f"errs{step}_{k}"] = np.asarray(errs[k])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_allreduce(tmp_path_factory):
    out = tmp_path_factory.mktemp("allreduce") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(out), str(PODS),
                        str(N)], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(out))


def test_cross_pod_allreduce_matches_shard_map(jax_allreduce):
    """Three steps over a pod dim of 4, the errors carried: every pod's
    synced mean and error bitwise the reference's under ``shard_map``."""
    ref = jax_allreduce
    errs = None
    for step in range(3):
        g = {k: torch.from_numpy(ref[f"g{step}_{k}"]).reshape(PODS, -1)
             for k in ("w", "b")}
        if errs is None:
            errs = C.init_errors(g)
        synced, errs = C.cross_pod_allreduce(g, errs)
        for k in g:
            assert synced[k].shape == (PODS, g[k].shape[1])
            assert_bitwise(synced[k].reshape(-1), ref[f"synced{step}_{k}"],
                           f"step {step} {k} synced")
            assert_bitwise(errs[k].reshape(-1), ref[f"errs{step}_{k}"],
                           f"step {step} {k} errors")
    w = ref["g0_w"].reshape(PODS, N)
    got = ref["synced0_w"].reshape(PODS, N)
    assert np.abs(got - w.mean(0)).max() <= np.abs(w).max() / 127 + 1e-5
