"""The whole AR data-plane slice, port (on the CPU) against the JAX
package, bit for bit: the composition ``chip_smoke.py`` drives on the
card, at a small size.  One RP of a 4 x 4 overlay (routing table at
granularity 6) posts 512 messages a step for 3 steps: Hilbert index,
owner rank, bucketing, store of what this RP receives into a 1,024-row
shard, the notify match against 64 standing interests, 4 associative
queries and one function-registry lookup.  Every output of every step
is compared, and the shard after each step."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import profiles as JP
from repro.core import routing as JR
from repro.core import serverless as JSV
from repro.core import sfc as JS
from repro.core import store as JST
from repro.core.overlay import Overlay as JOverlay
from repro.kernels.armatch import armatch as j_armatch
from repro_torch import convert
from repro_torch.core import routing as TR
from repro_torch.core import serverless as TSV
from repro_torch.core import sfc as TS
from repro_torch.core import store as TST
from repro_torch.core.overlay import Overlay as TOverlay
from repro_torch.kernels import checks
from repro_torch.kernels.armatch import armatch
from repro_torch.testing import assert_bitwise

GRID, GRANULARITY = 4, 6
N, SHARD, INTERESTS, QUERIES, STEPS = 512, 1024, 64, 4, 3
CAPACITY, VALUE_DIM, RESULTS, FUNCTIONS = 40, 8, 16, 64


def _step_j(shard, keys, payload, table, interests, queries, reg, fn_q, me):
    idx = JS.profile_index(keys)
    ranks = JR.rank_of_message(keys, table)
    send, plan = JR.route_local(payload, idx, table, GRID * GRID, CAPACITY)
    mine = (plan.dest == me) & plan.keep
    shard = JST.store(shard, keys, payload, mask=mine)
    notify = j_armatch(keys, interests, interpret=True)
    answers = [JST.query_match(shard, q, RESULTS) for q in queries]
    found = [e.name for e in reg.find(fn_q)]
    return shard, (idx, ranks, send, plan, mine, notify, answers, found)


def _step_t(shard, keys, payload, table, interests, queries, reg, fn_q, me):
    idx = TS.profile_index(keys)
    ranks = TR.rank_of_message(keys, table)
    send, plan = TR.route_local(payload, idx, table, GRID * GRID, CAPACITY)
    mine = (plan.dest == me) & plan.keep
    shard = TST.store(shard, keys, payload, mask=mine)
    notify = armatch(keys, interests)
    answers = [TST.query_match(shard, q, RESULTS) for q in queries]
    found = [e.name for e in reg.find(fn_q)]
    return shard, (idx, ranks, send, plan, mine, notify, answers, found)


def _registry(mod, **kw):
    reg = mod.FunctionRegistry(**kw)
    for i in range(FUNCTIONS):
        reg.store_function(f"fn{i:02d}", JP.profile(
            f"fn{i:02d}", "edge" if i % 2 else "core"), abs)
    return reg


def _feed(step):
    rng = np.random.default_rng(100 + step)
    return (rng.permutation(N),
            rng.standard_normal((N, VALUE_DIM)).astype(np.float32))


def test_ar_slice_equals_jax_over_three_steps():
    rng = np.random.default_rng(7)
    pool = checks.random_profiles(rng, N)
    interests = checks.random_profiles(rng, INTERESTS, max_slots=3)
    queries = checks.random_profiles(rng, QUERIES, kinds=(0, 1, 2, 4, 5),
                                     max_slots=1)
    fn_q = JP.ProfileBuilder().add_single("fn0*").build()
    jtable = JOverlay.from_mesh_shape(GRID, GRID, capacity=2) \
        .routing_table(GRANULARITY)
    ttable = TOverlay.from_mesh_shape(GRID, GRID, capacity=2) \
        .routing_table(GRANULARITY)
    np.testing.assert_array_equal(ttable, jtable)
    jside = (jnp.asarray(jtable), jnp.asarray(interests),
             [jnp.asarray(q) for q in queries], _registry(JSV), fn_q)
    tside = (torch.from_numpy(ttable), torch.from_numpy(interests),
             [torch.from_numpy(q) for q in queries],
             _registry(TSV, device="cpu"), fn_q)

    # the shard, pre-filled to capacity; this RP owns most of step 0
    jst = JST.init_store(SHARD, VALUE_DIM)
    for i in range(SHARD // N):
        perm, payload = _feed(1000 + i)
        jst = JST.store(jst, jnp.asarray(pool[perm]), jnp.asarray(payload))
    tst = convert.store_from_numpy(jst, device="cpu")
    owners = np.asarray(JR.rank_of_message(jnp.asarray(pool[_feed(0)[0]]),
                                           jside[0]))
    me = int(np.bincount(owners, minlength=GRID * GRID).argmax())

    names = ("idx", "ranks", "send", "plan", "mine", "notify")
    for step in range(STEPS):
        perm, payload = _feed(step)
        keys = pool[perm]
        jst, jout = _step_j(jst, jnp.asarray(keys), jnp.asarray(payload),
                            *jside, me)
        tst, tout = _step_t(tst, torch.from_numpy(keys),
                            torch.from_numpy(payload), *tside, me)
        for name, t, j in zip(names, tout, jout):
            if name == "plan":
                for f, a, b in zip(j._fields, t, j):
                    assert_bitwise(a, b, f"step {step} plan {f}")
            else:
                assert_bitwise(t, j, f"step {step} {name}")
        for q, (ta, ja) in enumerate(zip(tout[6], jout[6])):
            for name, a, b in zip(("values", "hits", "n_hits"), ta, ja):
                assert_bitwise(a, b, f"step {step} query {q} {name}")
            assert int(ta[2]) > 0, f"step {step}: query {q} found nothing"
        assert tout[7] == jout[7] and len(tout[7]) == 10
        got = convert.store_to_numpy(tst)
        for f in JST.ShardStore._fields:
            assert_bitwise(got[f], np.asarray(getattr(jst, f)),
                           f"step {step} shard {f}")
        notify = tout[5]
        assert 0 < int(notify.sum()) < notify.numel()
        plan = tout[3]
        assert int(plan.counts.sum() + plan.overflow.sum()) == N
        assert int(plan.overflow[me]) > 0          # the capacity binds here
