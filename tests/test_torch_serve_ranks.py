"""Serving split by rank (``launch.serve.run`` on a host mesh of 2 gloo
ranks, one process a rank through ``launch.mesh.spawn``), on the CPU.

Yi-6B's smoke config, 8 requests over 2 ranks (4 a rank), 6 prompt ids
teacher-forced and 5 generated.  Rank 1 starts from other weights than
rank 0's, which the broadcast must replace.  Each rank's rows are held
bitwise against one process serving the same rows from rank 0's weights
(the ids, the final logits, caches and lengths): a rank's step is the
one-process step at the rank's batch.  A batch the ranks do not divide
(5 requests) replicates: each rank's run equals one process serving all
of it.

The MoE configs (Mixtral-8x7B's and Kimi-K2's smoke configs, float32
compute) serve 32 requests over the 2 ranks, whose first 4 prompt ids
are the same for every request (a shared system prompt): while the
requests agree, every token picks the same experts, so the capacity of
the 32 tokens drops choices that a rank's plan of its own 16 would keep.
The test asserts that the one-process run's plans differ from the
per-rank plans, then holds the ranks to one process serving all 32
(each MoE layer plans over the global decode step): the ids equal, the
final logits and each rank's cache rows within ``MOE_TOL`` (1e-5) of
the largest magnitude (each rank's GEMMs take 16 rows, not 32), the
lengths equal.  5 MoE requests replicate: each rank plans on its own,
sends nothing while it serves, and equals one process serving all 5
bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.testing import assert_bitwise

RANKS = 2
REQUESTS, PROMPT, TOKENS = 8, 6, 5
ODD = 5
MOE_ARCHS = ("mixtral_8x7b", "kimi_k2_1t_a32b")
#: the MoE requests, and the prompt ids they all share
MOE_REQUESTS, SHARED = 32, 4
MOE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, as each rank runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return smoke_config("yi_6b")


def _model(seed: int):
    return T.init_params(_cfg(), seed=seed, device="cpu")


def _record(res) -> dict:
    """What a serve run hands back, on the host."""
    return dict(tokens=res.tokens, rows=(res.rows.start, res.rows.stop),
                logits=res.logits.clone(), lengths=res.lengths.clone(),
                caches=[{k: v.clone() for k, v in c.items()}
                        for c in res.caches],
                aot_cached=res.aot_cached, launches=res.launches,
                steps=len(res.secs), finite=res.finite)


def _moe_cfg(arch: str):
    return dataclasses.replace(smoke_config(arch),
                               compute_dtype=torch.float32)


def _moe_model(arch: str, seed: int):
    return T.init_params(_moe_cfg(arch), seed=seed, device="cpu")


def _moe_prompts(arch: str, requests: int) -> np.ndarray:
    """Seeded prompts whose first :data:`SHARED` ids every request
    shares."""
    prompts = serve.prompts_for(_moe_cfg(arch), requests, PROMPT)
    prompts[:, :SHARED] = prompts[0, :SHARED]
    return prompts


def _moe_serve(arch: str, requests: int, model, mesh=None) -> dict:
    """An MoE serve run, the bytes this rank sent in it, and those of
    the parameters' broadcast (what rank 0 sends a peer before the
    first step)."""
    sent = M.COLLECTIVES.sent_bytes
    res = serve.run(_moe_cfg(arch), requests, PROMPT, TOKENS, device="cpu",
                    model=model, mesh=mesh,
                    prompts=_moe_prompts(arch, requests))
    return dict(_record(res), sent=M.COLLECTIVES.sent_bytes - sent,
                weights=sum(p.numel() * p.element_size()
                            for p in model.parameters()))


def _broadcast(part: dict, case: dict) -> int:
    """The bytes a rank sends in the parameters' broadcast."""
    return case["weights"] * (RANKS - 1) if part["rank"] == 0 else 0


def _rank_serve(rank: int, device) -> dict:
    mesh = M.make_host_mesh(device="cpu")
    seed = 0 if rank == 0 else 7
    out = {"rank": rank,
           "split": _record(serve.run(_cfg(), REQUESTS, PROMPT, TOKENS,
                                      device="cpu", model=_model(seed),
                                      mesh=mesh)),
           "odd": _record(serve.run(_cfg(), ODD, PROMPT, TOKENS,
                                    device="cpu", model=_model(seed),
                                    mesh=mesh))}
    for arch in MOE_ARCHS:
        out["moe", arch] = _moe_serve(arch, MOE_REQUESTS,
                                      _moe_model(arch, seed), mesh)
    out["moe_odd"] = _moe_serve(MOE_ARCHS[0], ODD,
                                _moe_model(MOE_ARCHS[0], 0), mesh)
    return out


@pytest.fixture(scope="module")
def ranked():
    return M.spawn(_rank_serve, RANKS, "cpu")


@pytest.fixture(scope="module")
def one():
    """One process serving each rank's rows, and the odd batch whole,
    from rank 0's weights."""
    model = _model(0)
    prompts = serve.prompts_for(_cfg(), REQUESTS, PROMPT)
    per = REQUESTS // RANKS
    rows = [_record(serve.run(_cfg(), per, PROMPT, TOKENS, device="cpu",
                              model=model,
                              prompts=prompts[r * per:(r + 1) * per]))
            for r in range(RANKS)]
    return {"rows": rows, "odd": _record(serve.run(
        _cfg(), ODD, PROMPT, TOKENS, device="cpu", model=model))}


def _differing_plans(arch: str, ids: list) -> int:
    """Of the recorded MoE calls' expert ids (each ``[32 * k]``), those
    whose plan of the 32 tokens keeps other choices than the plans each
    rank would make of its own 16."""
    cfg = _moe_cfg(arch).moe
    n = 0
    for dest in ids:
        per = dest.numel() // RANKS
        glob = moe.dispatch_plan(dest[None], cfg.num_experts, moe.capacity(
            cfg, MOE_REQUESTS)).keep[0]
        local = torch.cat([moe.dispatch_plan(
            dest[r * per:(r + 1) * per][None], cfg.num_experts,
            moe.capacity(cfg, MOE_REQUESTS // RANKS)).keep[0]
            for r in range(RANKS)])
        n += not torch.equal(glob, local)
    return n


@pytest.fixture(scope="module")
def one_moe():
    """One process serving all 32 MoE requests, and the 5 of the odd
    case, from rank 0's weights; the count of MoE calls whose global
    plan differs from the per-rank plans (every call's expert ids read
    by a forward hook: on the CPU every step runs in Python)."""
    out = {}
    for arch in MOE_ARCHS:
        model, ids = _moe_model(arch, 0), []

        def hook(mod, args, result):
            h = args[0].reshape(1, -1, args[0].shape[-1])
            ids.append(moe.route(h, mod.p["router"], mod.cfg.top_k)[2]
                       .reshape(-1))
        hooks = [layer.moe.register_forward_hook(hook)
                 for layer in model.layers
                 if getattr(layer, "moe", None) is not None]
        out[arch] = _moe_serve(arch, MOE_REQUESTS, model)
        for h in hooks:
            h.remove()
        out[arch]["differing"] = _differing_plans(arch, ids)
    out["odd"] = _moe_serve(MOE_ARCHS[0], ODD, _moe_model(MOE_ARCHS[0], 0))
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(got: dict, want: dict, what: str) -> None:
    assert_bitwise(_bits(got["logits"]), _bits(want["logits"]),
                   f"{what} logits")
    assert_bitwise(got["lengths"], want["lengths"], f"{what} lengths")
    for i, (a, b) in enumerate(zip(got["caches"], want["caches"])):
        for k in b:
            assert_bitwise(_bits(a[k]), _bits(b[k]),
                           f"{what} layer {i} cache {k}")


@pytest.mark.parametrize("rank", range(RANKS))
def test_each_rank_serves_its_rows_as_one_process(ranked, one, rank):
    """Rank r serves rows [4r, 4r + 4): its ids, final logits, caches and
    lengths are bitwise one process's on those rows."""
    got, want = ranked[rank]["split"], one["rows"][rank]
    per = REQUESTS // RANKS
    assert got["rows"] == (rank * per, (rank + 1) * per)
    np.testing.assert_array_equal(got["tokens"][rank * per:(rank + 1) * per],
                                  want["tokens"])
    _same(got, want, f"rank {rank}")
    assert got["logits"].shape[0] == per and got["finite"]


def test_every_rank_holds_all_ids(ranked, one):
    """One all-gather at the end gives every rank the [8, tokens] ids, the
    ranks' rows in rank order."""
    want = np.concatenate([r["tokens"] for r in one["rows"]])
    for part in ranked:
        assert part["split"]["tokens"].shape == (REQUESTS, TOKENS)
        np.testing.assert_array_equal(part["split"]["tokens"], want)


def test_each_rank_resolves_one_captured_step(ranked):
    """Every rank resolves the decode step through its own registry: one
    cached step, run every step of the loop."""
    for part in ranked:
        for case in ("split", "odd"):
            assert part[case]["aot_cached"] == 1
            assert part[case]["steps"] == PROMPT + TOKENS


def test_a_batch_the_ranks_do_not_divide_replicates(ranked, one):
    """5 requests over 2 ranks: every rank serves all 5, each equal to one
    process serving them."""
    for rank, part in enumerate(ranked):
        got = part["odd"]
        assert got["rows"] == (0, ODD)
        np.testing.assert_array_equal(got["tokens"], one["odd"]["tokens"])
        _same(got, one["odd"], f"rank {rank} odd")


def _near(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= MOE_TOL, f"{what}: {err:.3e} of the largest > {MOE_TOL}"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_over_ranks_equals_one_process(ranked, one_moe, arch):
    """32 MoE requests over 2 ranks, on data whose global plan differs
    from the per-rank plans: every rank's gathered ids are one process's
    serving all 32, and its final logits and cache rows are that run's
    rows, within :data:`MOE_TOL`."""
    want = one_moe[arch]
    assert want["differing"] > 0
    per = MOE_REQUESTS // RANKS
    for rank, part in enumerate(ranked):
        got = part["moe", arch]
        rows = slice(rank * per, (rank + 1) * per)
        assert got["rows"] == (rows.start, rows.stop)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        _near(got["logits"], want["logits"][rows], f"rank {rank} logits")
        assert_bitwise(got["lengths"], want["lengths"][rows], "lengths")
        for i, (a, b) in enumerate(zip(got["caches"], want["caches"])):
            for k in b:
                _near(a[k], b[k][rows], f"rank {rank} layer {i} cache {k}")
        # the MoE layers' all-gathers, beyond the weights' broadcast
        assert got["sent"] > _broadcast(part, got) and got["finite"]


def test_moe_requests_the_ranks_do_not_divide_plan_locally(ranked, one_moe):
    """5 MoE requests over 2 ranks: every rank serves all 5 and plans on
    its own -- it sends nothing but the weights' broadcast -- bitwise one
    process's run."""
    want = one_moe["odd"]
    for rank, part in enumerate(ranked):
        got = part["moe_odd"]
        assert got["rows"] == (0, ODD)
        assert got["sent"] == _broadcast(part, got)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        _same(got, want, f"rank {rank} odd MoE")
