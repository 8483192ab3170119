"""The 99th percentile over the window's ticks of the host time from
the call of the program's step to its return, before the synchronize
(host clock): the compile-once step's replay and copies."""
import numpy as np


def read(run: dict, cell: dict):
    return float(np.percentile(run["host_s"], 99)) * 1e3
