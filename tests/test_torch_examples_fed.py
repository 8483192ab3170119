"""The PyTorch twin of the federated streaming-training example
(``examples/federated_stream_train_torch.py``) against the reference
example, on the CPU, from the reference's weights.

A subprocess runs ``federated_stream_train.py`` (``JAX_PLATFORMS=cpu``,
120 s) and dumps the initial weights (the example's own
``init_params`` call) and its losses; the twin runs through
``main(device="cpu", params=...)``.  The admission counts and the
number of train steps are equal; the losses agree within 1e-5 relative
with both sides computing in float32 (the example's ``smoke_config``
patched on both sides), and within 4 bfloat16 ulps (1.5625e-2
relative) as shipped, where the two frameworks round bfloat16 matmuls
at different points.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_examples_dr import ROOT, reference_env, tree_from_npz

sys.path.insert(0, str(ROOT / "examples"))

import federated_stream_train_torch as E  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its tensors are small,
    and the suite's parallel workers would otherwise oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = {"float32": 1e-5, "bfloat16": 4 * 2.0 ** -8}

_REFERENCE = """
import contextlib, dataclasses, io, json, runpy, sys
import jax, jax.numpy as jnp, numpy as np
if sys.argv[3] == "float32":
    import repro.configs.registry as R
    smoke = R.smoke_config
    R.smoke_config = lambda a: dataclasses.replace(
        smoke(a), compute_dtype=jnp.float32)
from repro.configs.registry import smoke_config
from repro.models import transformer as T
out = {}
def flat(tree, prefix):
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(v, prefix + "/" + k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(v, prefix + "/" + str(i))
    else:
        out[prefix] = np.asarray(tree)
flat(jax.device_get(T.init_params(smoke_config("mixtral_8x7b"),
                                  jax.random.PRNGKey(0))), "params")
with contextlib.redirect_stdout(io.StringIO()):
    g = runpy.run_path(sys.argv[1])
np.savez(sys.argv[2], **out)
print(json.dumps({k: g[k] for k in ("admitted", "rejected", "losses")}))
"""


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_federated_training_equals_the_reference(tmp_path, monkeypatch,
                                                 compute):
    dump = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _REFERENCE,
                        str(ROOT / "examples" / "federated_stream_train.py"),
                        str(dump), compute], env=reference_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.splitlines()[-1])
    if compute == "float32":
        monkeypatch.setattr(E, "cfg", dataclasses.replace(
            E.cfg, compute_dtype=torch.float32))
    got = E.main(device="cpu",
                 params=tree_from_npz(np.load(dump), "params"))
    assert (got["admitted"], got["rejected"]) == \
        (want["admitted"], want["rejected"]) == (85, 35)
    assert len(got["losses"]) == len(want["losses"]) == 10
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=REL[compute], atol=0)
    assert got["losses"][-1] < got["losses"][0]
