"""HLO text analysis: collective bytes and roofline terms.

Port of ``repro.launch.hlo``, pure Python with no XLA behind it.  The
port writes no HLO: its dry run counts work with
``obs.costmodel.analyze`` and collectives with ``launch.partition``,
whose events :func:`stats_from_events` reads; :func:`collective_stats`
reads HLO text another tool wrote.

Collective *operand* bytes per op kind (what actually crosses links):
  all-reduce / all-to-all / collective-permute: result size
  all-gather:      result / group_size   (each rank contributes a slice)
  reduce-scatter:  result * group_size   (each rank offers the full input)
A static text scan counts a while-loop body once, whatever its trip
count.

One difference from the reference's scan: a synchronous collective
whose result is a tuple (XLA's combiners merge independent all-reduces
into one; an all-to-all may carry one operand a peer) counts every
element of the tuple, where the reference counts only the last (its rule
for an async ``-start`` tuple, whose last element is the result) and
misses a tuple of more than five elements altogether (the
``/*index=5*/`` comment XLA writes inside it stops its pattern).
"""
from __future__ import annotations

import re

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INDEX_RE = re.compile(r"/\*index=\d+\*/")
_OP_RE = re.compile(
    r"=\s+(\([^=]*?\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_GROUPS_NEW_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_OLD_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _result_bytes(result_str: str, start: bool = True) -> int:
    shapes = _SHAPE_RE.findall(result_str)
    if not shapes:
        return 0
    if start and result_str.startswith("("):    # async-start: last = result
        shapes = shapes[-1:]
    return sum(_shape_bytes(dt, dims) for dt, dims in shapes)


def _group_size(line: str, default: int = 1) -> int:
    m = _GROUPS_NEW_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_OLD_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def collective_stats(hlo_text: str) -> dict:
    """Sum operand bytes of every collective op (static text scan).

    Returns {op_kind: {"count", "bytes"}, "total_bytes": int}."""
    events = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(_INDEX_RE.sub("", line))
        if not m:
            continue
        events.append((m.group(2), _result_bytes(m.group(1), bool(m.group(3))),
                       _group_size(line)))
    return stats_from_events(events)


def operand_bytes(kind: str, result_bytes: int, group: int) -> int:
    """A collective's operand bytes from its result's (the module's
    convention)."""
    if kind == "all-gather":
        return result_bytes // max(group, 1)
    if kind == "reduce-scatter":
        return result_bytes * group
    return result_bytes


def stats_from_events(events) -> dict:
    """:func:`collective_stats`'s dict from ``(kind, result bytes, group
    size)`` events, one a collective op."""
    stats: dict = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for kind, rb, gs in events:
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += operand_bytes(kind, rb, gs)
    stats["total_bytes"] = sum(v["bytes"] for v in stats.values()
                               if isinstance(v, dict))
    return stats


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int, *, peak_flops: float, hbm_bw: float,
                   ici_bw: float) -> dict:
    """The three roofline times (seconds) + the dominant term.

    flops / hbm_bytes are whole-program (all chips) from cost_analysis;
    collective_bytes are whole-program operand bytes from the HLO."""
    t_compute = flops / (n_chips * peak_flops)
    t_memory = hbm_bytes / (n_chips * hbm_bw)
    t_collective = collective_bytes / (n_chips * ici_bw)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom.replace("_s", "")
    terms["bound_s"] = terms[dom]
    return terms
