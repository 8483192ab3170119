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
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.testing import assert_bitwise

RANKS = 2
REQUESTS, PROMPT, TOKENS = 8, 6, 5
ODD = 5


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


def _rank_serve(rank: int, device) -> dict:
    mesh = M.make_host_mesh(device="cpu")
    seed = 0 if rank == 0 else 7
    return {"split": _record(serve.run(_cfg(), REQUESTS, PROMPT, TOKENS,
                                       device="cpu", model=_model(seed),
                                       mesh=mesh)),
            "odd": _record(serve.run(_cfg(), ODD, PROMPT, TOKENS,
                                     device="cpu", model=_model(seed),
                                     mesh=mesh))}


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
