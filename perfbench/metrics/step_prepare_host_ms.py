"""The 99th percentile over the program's traced graphed ticks of the
host time a tick around the graph's launch: the executor's
``fleet.prepare`` (the operands moved and made) and the compile-once
step's ``step.copy_in`` and ``step.copy_out`` (``pb/progtrace.py``)."""
import numpy as np

from perfbench.pb.progtrace import per_tick


def read(run: dict, cell: dict):
    s = per_tick(run, ("fleet.prepare", "stream.prepare", "step.copy_in",
                       "step.copy_out"))
    return None if s is None else float(np.percentile(s, 99)) * 1e3
