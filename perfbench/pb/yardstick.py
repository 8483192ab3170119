"""The yardstick: the H100's peaks and what each kernel's function must
do, frozen here so that no change to the program moves it.

``fused_tick`` is a copy of ``repro_torch.kernels.cost.fused_tick`` as
it stood when the benchmark was defined (``src/repro_torch/kernels/
cost.py``): bytes count each input read once and each output written
once; operations count the work the function needs, not the
instructions a kernel compiles to.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 outside the
#: tensor cores (the window kernel's adds and compares run there)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def fused_tick(t: int, cols: int, d: int, nw: int, window: int
               ) -> tuple[int, int]:
    """The fused tick over a ``[t, 1 + cols]`` float32 row block and its
    ``[t]`` bool mask: ``cols`` columns read (the ingest stamp and the
    ``d`` features), the mask, and ``[nw, d]`` aggregates, ``[nw, 5]``
    features and three ``[nw]`` outputs written; a window takes four
    operations a row a column (sum, max, min and the mask's select)."""
    return 4 * t * cols + t + 4 * nw * (d + 5 + 3), nw * cols * window * 4


def fused_tick_bound_s(cfg: dict) -> float:
    """The least time one call of the window kernel can take at a
    configuration's tick: the larger of its bytes over the bandwidth and
    its operations over the float32 peak."""
    carry = cfg["window"] - cfg["stride"]
    t = cfg["micro_batch"] + carry
    nw = (t - cfg["window"]) // cfg["stride"] + 1
    nbytes, ops = fused_tick(t, 1 + cfg["features"], cfg["features"], nw,
                             cfg["window"])
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)
