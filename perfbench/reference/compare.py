"""The comparison that decides ``correct``.

The program's answers of the checked ticks (a sample drawn from the
seed, tick 0 among them) and its counters are held against the plain
reference (``stream.py``), which follows every tick of the same feed:

- ``window_mismatches``: elements of the checked ticks' aggregates,
  features, window counts, consequences and escalation flags, and of
  the outputs of windows the core did not process, that differ from the
  reference by a single bit.  Exact: limit 0;
- ``counter_mismatches``: counters that differ: each checked tick's
  increments of the window and exchange counters, and at the end the
  admission counters (offered, accepted, rejected, deduped, dequeued,
  late), the per-field contract counts and the fleet watermark, the
  program's int32 counters modulo 2^32.  Exact: limit 0;
- ``core_gap``: the widest gap between a core-processed output and the
  reference's float64 core, relative to the largest entry of its row;
  its limit lies between the program's readings and the TF32
  control's (``PERF.md``);
- ``ticks_checked``: at least one tick was compared.
"""
from __future__ import annotations

import torch

from perfbench.reference import stream as RS

#: the stream outputs compared bit for bit
EXACT = ("aggregates", "features", "window_count", "consequence",
         "escalated")
#: counters compared by their increments on a checked tick (the fleet's
#: exchange counters where the program keeps them)
TICK_COUNTERS = RS.WINDOW_COUNTERS + (
    "escalations_sent", "fog_shed", "core_received", "core_processed",
    "late_excluded", "fleet_core_overflow")


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int64)


def _wrap(v) -> int:
    return int(v) % (1 << 32)


def _differ(a, b) -> int:
    """Entries of two counter values (ints, or lists of them, nested)
    that differ modulo 2^32."""
    if isinstance(a, list) or isinstance(b, list):
        if not (isinstance(a, list) and isinstance(b, list)):
            return 1
        return sum(_differ(x, y) for x, y in zip(a, b)) \
            + abs(len(a) - len(b))
    return int(_wrap(a) != _wrap(b))


def compare(ticks: dict, final: dict, ref_ticks: dict, ref_final: dict,
            shards: slice, control: dict | None = None) -> dict:
    """``ticks``: ``{t: {"out", "before", "after"}}``, the program's
    host outputs of each checked tick and its counters after the tick
    before and after it; ``final``: its counters at the end; the
    reference's ``run`` and ``counters`` for the same ticks; ``shards``:
    the program's rows among the reference's.  ``control``: ``{t: core
    rows}`` put in the program's place (the precision control).
    Returns the compared numbers."""
    win = cnt = 0
    gap = 0.0
    for t, got in ticks.items():
        inc, ref = ref_ticks[t]
        out = got["out"]
        for k in EXACT:
            a, b = _bits(out[k]), _bits(ref[k][shards])
            win += int((a != b).sum()) if a.shape == b.shape else a.numel()
        proc = ref["processed"][shards].cpu()
        record = ref["record"][shards].cpu()
        prog = out["outputs"]
        if prog.shape != record.shape:
            win += prog.numel()
            continue
        keep = ~proc
        win += int((_bits(prog[keep]) != _bits(record[keep])).sum())
        # the core rows: ref["core"] holds every shard's, in row order
        lo = int(ref["processed"][:shards.start].sum())
        n = int(proc.sum())
        want = ref["core"][lo:lo + n].cpu().to(torch.float64)
        core = prog[proc].to(torch.float64) if control is None \
            else control[t][lo:lo + n].cpu().to(torch.float64)
        if n:
            # each row's gap against its own largest entry: the core's
            # map contracts, so its outputs are small
            scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
            gap = max(gap, float(((core - want).abs() / scale).max()))
        for k in TICK_COUNTERS:
            if k not in inc or k not in got["after"]:
                continue
            after, before = got["after"][k], got["before"][k]
            if isinstance(after, list):
                delta = [x - y for x, y in zip(after, before)]
                want_k = inc[k][shards]
            else:
                delta, want_k = after - before, inc[k]
            cnt += _differ(delta, want_k)
    for k, v in ref_final.items():
        if k == "watermark":
            a = torch.tensor(final[k], dtype=torch.float32)
            b = torch.tensor(v, dtype=torch.float32)
            cnt += int(not torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)))
        else:
            cnt += _differ(final[k], v[shards])
    return dict(window_mismatches=win, counter_mismatches=cnt,
                core_gap=gap, ticks_checked=len(ticks))


def final_diffs(final: dict, ref_final: dict, shards: slice) -> dict:
    """The final counters that differ: ``{name: [program, reference]}``
    (reported beside the compared numbers)."""
    out = {}
    for k, v in ref_final.items():
        want = v if k == "watermark" else v[shards]
        if k == "watermark" and float(final[k]) != float(v) \
                or k != "watermark" and _differ(final[k], want):
            out[k] = [final[k], want]
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` float32 rounded to TF32 (10 mantissa bits, to nearest, ties
    to even), as the tensor cores read a float32 operand."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def core_tf32(record: torch.Tensor, p: torch.Tensor, layers: int
              ) -> torch.Tensor:
    """The control: the reference's core in the precision below the
    configuration's (float32 with TF32 off): TF32 operands, float32
    accumulation."""
    h = record.to(torch.float32)
    p32 = tf32(p.to(torch.float32))
    for _ in range(layers):
        h = torch.tanh(tf32(h) @ p32)
    return h


def control_numbers(cfg: dict, done: dict, p: torch.Tensor,
                    hardware: bool = False) -> dict:
    """The compared numbers of the control: the reference put in the
    program's place (``done``: its ``Stream.run`` of the checked ticks),
    its core in TF32: emulated (``core_tf32``), or with ``hardware`` the
    card's own TF32 matmuls (float32 operands, ``allow_tf32``)."""
    ticks, control = {}, {}
    for t, (inc, out) in done.items():
        prog = {k: out[k] for k in EXACT}
        prog["outputs"] = out["record"].clone()
        ticks[t] = {"out": prog, "before": {}, "after": {}}
        rec = out["record"][out["processed"]]
        if hardware:
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control[t] = RS.core(rec.float(), p.float(),
                                     cfg["core_layers"])
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
        else:
            control[t] = core_tf32(rec, p, cfg["core_layers"])
    shards = slice(0, next(iter(done.values()))[1]["record"].shape[0])
    return compare(ticks, {}, done, {}, shards, control=control)
