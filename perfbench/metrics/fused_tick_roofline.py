"""The window kernel's share of its roofline, in percent: the frozen
``fused_tick`` bytes and operations of the configuration's tick at the
H100's bandwidth or float32 peak, whichever bound is larger, over the
mean device time of the kernel's calls in the traced graphed ticks."""
import numpy as np

from perfbench.pb import yardstick

KERNEL = "fused_tick_kernel"


def read(run: dict, cell: dict):
    g = run.get("graphed")
    if not g:
        return None
    durs = [d for name, ds in g["kernels"].items()
            if name.startswith(KERNEL) for d in ds]
    if not durs:
        return None
    return 100.0 * yardstick.fused_tick_bound_s(cell["config"]) \
        / float(np.mean(durs))
