"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped, the rest of a run driven on the
CPU, once for each fault a cell can have: a tick that returns its state
unchanged, half of the block left out (the means taken over the rest),
an answer altered where it is produced, and across ranks the exchange
between cards left out."""
from __future__ import annotations

import contextlib
import time

import pytest

from perfbench.conftest import ROOT, SEED, cell, run_small, shrink
from perfbench.pb.cli import verdict


@contextlib.contextmanager
def state_unchanged():
    from repro_torch.stream.executor import StreamExecutor
    from repro_torch.stream.fleet.executor import FleetExecutor
    saved = StreamExecutor._tick, FleetExecutor._tick

    def wrap(orig):
        def tick(self, state, *args):
            out, _, hist, lineage = orig(self, state, *args)
            return out, state, hist, lineage
        return tick
    StreamExecutor._tick, FleetExecutor._tick = (wrap(f) for f in saved)
    try:
        yield
    finally:
        StreamExecutor._tick, FleetExecutor._tick = saved


def _window_kernel(change):
    @contextlib.contextmanager
    def patch():
        from repro_torch.stream import executor as X
        orig = X.fused_tick

        def broken(seq, seq_valid, *args, **kw):
            return change(orig, seq, seq_valid, *args, **kw)
        X.fused_tick = broken
        try:
            yield
        finally:
            X.fused_tick = orig
    return patch


def _half(orig, seq, seq_valid, *args, **kw):
    valid = seq_valid.clone()
    valid[seq.shape[0] // 2:] = False
    return orig(seq, valid, *args, **kw)


def _altered(orig, seq, seq_valid, *args, **kw):
    agg, *rest = orig(seq, seq_valid, *args, **kw)
    agg = agg.clone()
    agg[3, 2] += 1e-3
    return (agg, *rest)


half_block = _window_kernel(_half)
answer_altered = _window_kernel(_altered)


@contextlib.contextmanager
def exchange_left_out():
    """Every collective of the fleet's federation returns this rank's own
    buffer, as if nothing crossed between cards."""
    from repro_torch.launch import mesh as M
    from repro_torch.stream.fleet import federation as F
    saved = F.M
    F.M = type("NoExchange", (), {
        "all_to_all": staticmethod(lambda x, group: x.clone()),
        "all_gather": staticmethod(lambda x, group: M.all_gather(x, group)),
        "all_reduce": staticmethod(M.all_reduce),
        "broadcast": staticmethod(M.broadcast)})
    try:
        yield
    finally:
        F.M = saved


def _correct(run: dict, name: str) -> bool:
    ok, _ = verdict(run["numbers"], cell(name)["config"]["limits"])
    return ok


@pytest.mark.parametrize("fault", [state_unchanged, half_block,
                                   answer_altered])
@pytest.mark.parametrize("name", ["gateway.redeliver", "fleet_8x2.hotcold"])
def test_fault_reads_incorrect(name, fault):
    run = run_small(cell(name), patch=fault)
    assert not _correct(run, name), run["numbers"]


def test_sound_run_reads_correct():
    for name in ("gateway.redeliver", "fleet_8x2.hotcold"):
        assert _correct(run_small(cell(name)), name)


def _ranks(patch):
    from perfbench.pb import ranks
    return ranks.measure(ROOT, "fleet_8x2.hotcold", 4, SEED, 0.5, False,
                         time.perf_counter(), device="cpu", resize=shrink,
                         patch=patch)


def test_ranks_sound_and_exchange_left_out():
    """The fleet over four gloo ranks: the sound run reads correct, the
    one whose exchange between ranks is left out does not."""
    assert _correct(_ranks(None), "fleet_8x2.hotcold")
    assert not _correct(_ranks(exchange_left_out), "fleet_8x2.hotcold")
