"""The 99th percentile of the window's ticks, each from the call of the
program's step to the return of the synchronize after it (host clock)."""
import numpy as np


def read(run: dict, cell: dict):
    return float(np.percentile(run["tick_s"], 99)) * 1e3
