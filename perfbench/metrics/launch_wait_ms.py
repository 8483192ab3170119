"""The median over the program's traced graphed ticks of how long the
device waits for the graph after the host asks for it: the first mark
of the captured body (``step.graph``'s start, mapped onto the host's
clock by the tracer's calibration) minus the host start of
``step.launch`` (``pb/progtrace.py``).  The calibration's half-width is
the reading's error (``program.calibration``)."""
import numpy as np


def read(run: dict, cell: dict):
    prog = run.get("program")
    if not prog or "step.launch" not in prog["host_start"]:
        return None
    asked = np.asarray(prog["host_start"]["step.launch"])
    started = np.asarray(prog["graph_host_s"])[:, 0]
    if asked.size != started.size or not asked.size:
        return None
    return float(np.median(started - asked)) * 1e3
