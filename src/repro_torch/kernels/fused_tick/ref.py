"""Plain PyTorch version of the ``fused_tick`` kernel.

The one-framing path of ``repro.kernels.fused_tick.ops`` (its jnp
oracle) plus ``rule_sweep``: one ``[NW, W, 1 + D]`` framing of the
block, the four masked reductions in the kernel's left-to-right order,
the rule table applied lowest precedence first.  The CPU path of
``ops.fused_tick`` runs it; ``chip_smoke.py`` holds the kernel against
it on the card.
"""
from __future__ import annotations

import torch

F32_MIN = torch.finfo(torch.float32).min
F32_MAX = torch.finfo(torch.float32).max

#: rule comparison ops the table may carry.  A python float on the
#: right is compared in float32, as JAX compares a weak-typed value.
CMP = {
    ">=": lambda f, v: f >= v,
    ">":  lambda f, v: f > v,
    "<=": lambda f, v: f <= v,
    "<":  lambda f, v: f < v,
    "==": lambda f, v: f == v,
}


def rule_sweep(s, mx, mn, c, table, min_count: int) -> torch.Tensor:
    """Conflict-set resolution on accumulator tensors, elementwise:
    per-window sum, max/min (already 0 when empty) and valid count ->
    float32 consequence codes."""
    cf = torch.clamp(c, min=1.0)
    feats = (s / cf, mx, mn, s, c)       # F_MEAN..F_COUNT column order
    cons = torch.zeros_like(s)           # C_NONE
    for fi, op, value, code in table:    # lowest precedence first
        cons = torch.where(CMP[op](feats[fi], value), float(code), cons)
    return torch.where(c >= min_count, cons, 0.0)


def fused_tick_ref(seq: torch.Tensor, seq_valid: torch.Tensor, window: int,
                   stride: int, table, min_count: int = 1,
                   meta_cols: int = 2):
    """Fused window + features + rules, complete windows only.  Returns
    (agg [NW, D], wcount [NW] int32, feats [NW, 5], w_birth [NW],
    cons [NW] int32) -- the ``ops.fused_tick`` contract."""
    # imported here: stream.windows imports the kernels package
    from repro_torch.stream.windows import _frame, _seq_combine
    d = seq.shape[1] - meta_cols
    sc = meta_cols - 1                          # signal column within x
    x = seq[:, 1:].to(torch.float32)            # [wall | features]
    vals, mask = _frame(x, seq_valid.to(torch.bool), window, stride,
                        partial=False)
    m = mask[:, :, None]
    s = _seq_combine(torch.where(m, vals, 0.0), torch.add)
    mx = _seq_combine(torch.where(m, vals, F32_MIN), torch.maximum)
    mn = _seq_combine(torch.where(m, vals, F32_MAX), torch.minimum)
    count = mask.sum(1, dtype=torch.int32).to(torch.float32)
    nonempty = (count > 0)[:, None]
    mx = torch.where(nonempty, mx, 0.0)
    mn = torch.where(nonempty, mn, 0.0)
    cf = torch.clamp(count, min=1.0)
    agg = s[:, sc:sc + d] / cf[:, None]
    feats = torch.stack([s[:, sc] / cf, mx[:, sc], mn[:, sc], s[:, sc],
                         count], dim=1)
    cons = rule_sweep(s[:, sc], mx[:, sc], mn[:, sc], count, table,
                      min_count)
    return (agg, count.to(torch.int32), feats, mn[:, 0],
            cons.to(torch.int32))
