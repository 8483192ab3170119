"""The 99th percentile over the program's traced graphed ticks of the
host time of ``step.launch``: the compile-once step's
``graph.replay()`` (``pb/progtrace.py``)."""
import numpy as np

from perfbench.pb.progtrace import per_tick


def read(run: dict, cell: dict):
    s = per_tick(run, ("step.launch",))
    return None if s is None else float(np.percentile(s, 99)) * 1e3
