"""Device milliseconds a graphed fleet tick under the program's fleet
spans: the fleet watermark, the two-hop exchange with the core stage,
and the commit (``obs:fleet_watermark``, ``obs:exchange_core``,
``obs:core_commit``), the median over the program's traced ticks
(``pb/progtrace.py``: device marks captured in the tick's graph).  The
graphed twin of ``fleet_exchange_device_ms``: wall time between marks,
so the graph's gaps between the stages' kernels count too."""
import numpy as np

from perfbench.pb.progtrace import stage_ns


def read(run: dict, cell: dict):
    ns = stage_ns(run, ("obs:fleet_watermark", "obs:exchange_core",
                        "obs:core_commit"))
    return None if ns is None else float(np.median(ns)) * 1e-6
