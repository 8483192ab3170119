"""The PyTorch twin of the disaster-recovery example
(``examples/disaster_recovery_torch.py``) against the reference
example, on the CPU, from the reference's weights.

A subprocess runs ``disaster_recovery.py`` (``JAX_PLATFORMS=cpu``,
120 s), recomputes each frame's edge features through the example's
own jitted pipeline and dumps them with both models' weights; the twin
runs through ``main(device="cpu", params=...)``, the weights read
through ``convert``.  Two cases:

* ``float32``: both sides' smoke configs computing in float32 (the
  example's ``smoke_config`` patched on both sides): every frame's
  damage score and variance within 1e-5 relative, and each frame's
  decision (escalated, stored, dropped) equal, except where its score
  lies within 1e-5 relative of the 3.19 threshold;
* ``bfloat16``: the example as shipped.  The two frameworks round
  bfloat16 matmuls at different points, so the scores agree to 4
  bfloat16 ulps (1.5625e-2 relative; ``tests/test_torch_rwkv.py`` holds
  the layers to the same), and a decision may differ only where the
  score lies within that of the threshold.  The quality rule reads the
  frames' variance alone: the drops are equal in both cases.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import disaster_recovery_torch as E  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


THRESHOLD = 3.19
#: relative tolerance of a score: float32, and 4 bfloat16 ulps
REL = {"float32": 1e-5, "bfloat16": 4 * 2.0 ** -8}

_REFERENCE = """
import contextlib, dataclasses, io, json, runpy, sys
import jax, jax.numpy as jnp, numpy as np
if sys.argv[3] == "float32":
    import repro.configs.registry as R
    smoke = R.smoke_config
    R.smoke_config = lambda a: dataclasses.replace(
        smoke(a), compute_dtype=jnp.float32)
with contextlib.redirect_stdout(io.StringIO()):
    g = runpy.run_path(sys.argv[1])
feats = [np.asarray(g["run"](jnp.asarray(g["frames"][i:i + g["BATCH"]]))
                    .stage_features[0], np.float32)
         for i in range(0, g["N_FRAMES"], g["BATCH"])]
out = {"features": np.concatenate(feats)}
def flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, prefix + "/" + k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, prefix + "/" + str(i))
    else:
        out[prefix] = np.asarray(tree)
flat(jax.device_get(g["edge_params"]), "edge")
flat(jax.device_get(g["core_params"]), "core")
np.savez(sys.argv[2], **out)
print(json.dumps({k: g[k] for k in ("escalated", "stored", "dropped")}))
"""


def reference_env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def tree_from_npz(z, prefix: str):
    """The ``{prefix}/a/0/b`` keys of ``z`` as the nested dicts and lists
    of the reference's parameter tree."""
    root: dict = {}
    for key in z.files:
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = root
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]

    def fix(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()}
    return fix(root)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_disaster_recovery_equals_the_reference(tmp_path, monkeypatch,
                                                compute):
    dump = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(ROOT / "examples" / "disaster_recovery.py"),
                        str(dump), compute], env=reference_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.splitlines()[-1])
    z = np.load(dump)
    if compute == "float32":
        for name in ("edge_cfg", "core_cfg"):
            cfg = getattr(E, name)
            monkeypatch.setattr(E, name, dataclasses.replace(
                cfg, compute_dtype=torch.float32))
    got = E.main(device="cpu", params=(tree_from_npz(z, "edge"),
                                       tree_from_npz(z, "core")))
    ref = z["features"]
    rel = REL[compute]
    np.testing.assert_allclose(got["features"], ref, rtol=rel, atol=0)
    assert got["dropped"] == want["dropped"]
    near = np.abs(ref[:, 0] - THRESHOLD) <= rel * np.abs(ref[:, 0])
    want_esc = (ref[:, 0] >= THRESHOLD) & (ref[:, 1] < 7000.0)
    got_esc = np.asarray(got["decisions"]) == "escalated"
    assert np.array_equal(got_esc[~near], want_esc[~near])
    assert abs(got["escalated"] - want["escalated"]) <= int(near.sum())
    assert got["escalated"] + got["stored"] + got["dropped"] == \
        want["escalated"] + want["stored"] + want["dropped"] == 64
    if compute == "float32":
        assert not near.any()
        assert {k: got[k] for k in want} == want
