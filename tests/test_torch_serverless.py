"""The port's ``core.serverless.FunctionRegistry`` against the JAX
package: the registry lifecycle of ``tests/test_core.py``, with every
``find`` hit list equal to the reference's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import profiles as JP
from repro.core import serverless as J
from repro_torch.core import serverless as T
from repro_torch.kernels import checks


def _names(entries):
    return [e.name for e in entries]


def _both():
    return J.FunctionRegistry(), T.FunctionRegistry(device="cpu")


def test_registry_lifecycle_equals_jax():
    jr, tr = _both()
    for reg in (jr, tr):
        reg.store_function("f1", JP.profile("topo", "edge"), lambda x: x + 1)
        reg.store_function("f2", JP.profile("topo", "core"), lambda x: x * 2)
    interest = JP.ProfileBuilder().add_single("topo").build()
    hits = tr.start_function(interest)
    assert _names(e for e, _ in hits) == _names(
        e for e, _ in jr.start_function(interest))
    assert {e.name for e, _ in hits} == {"f1", "f2"}
    assert tr.statistics() == jr.statistics()
    assert tr.statistics()["running"] == 2
    edge = JP.profile("topo", "edge")
    assert tr.stop_function(edge) == jr.stop_function(edge) == 1
    assert tr.statistics() == jr.statistics()
    assert tr.statistics()["running"] == 1
    fn = dict((e.name, f) for e, f in hits)["f2"]
    assert float(fn(torch.tensor(3.0))) == 6.0


def test_find_equals_jax_on_random_profiles():
    rng = np.random.default_rng(11)
    jr, tr = _both()
    for i, p in enumerate(checks.random_profiles(rng, 64, wildcard=0.05)):
        jr.store_function(f"fn{i:02d}", p, abs)
        tr.store_function(f"fn{i:02d}", p, abs)
    interests = [*checks.random_profiles(rng, 24, max_slots=2, wildcard=0.1),
                 JP.ProfileBuilder().add_single("attr1").build(),
                 np.zeros(128, np.int32)]
    total = 0
    for q in interests:
        got = _names(tr.find(q))
        assert got == _names(jr.find(q))
        total += len(got)
    assert total > 0
    # a store after a find rebuilds the table
    tr.store_function("late", JP.profile("attr1"), abs)
    jr.store_function("late", JP.profile("attr1"), abs)
    q = JP.ProfileBuilder().add_single("attr1").build()
    assert _names(tr.find(q)) == _names(jr.find(q))
    assert "late" in _names(tr.find(q))


def test_cache_keys_like_the_reference():
    tr = T.FunctionRegistry(device="cpu")
    tr.store_function("f", JP.profile("t"), lambda x: x * 2)
    spec = torch.empty((4,), dtype=torch.float32, device="meta")
    tr.start_function(JP.profile("t"), spec)
    tr.start_function(JP.profile("t"), spec)
    assert tr.statistics()["aot_cached"] == 1
    tr.start_function(JP.profile("t"), torch.empty((8,), device="meta"))
    assert tr.statistics()["aot_cached"] == 2
    jr = J.FunctionRegistry()
    jr.store_function("f", JP.profile("t"), lambda x: x * 2)
    for shape in ((4,), (4,), (8,)):
        jr.start_function(JP.profile("t"),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    assert tr.statistics() == jr.statistics()


def test_empty_registry_finds_nothing():
    assert T.FunctionRegistry(device="cpu").find(JP.profile("x")) == []
