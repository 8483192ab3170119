"""Device milliseconds a fleet tick under the program's fleet spans:
the fleet watermark, the two-hop exchange with the core stage, and the
commit (``obs:fleet_watermark``, ``obs:exchange_core``,
``obs:core_commit``), from eager ticks traced with the program's
tracer on (rank 0's across ranks)."""
from perfbench.pb.devtrace import stage_ms


def read(run: dict, cell: dict):
    return stage_ms(run, ("obs:fleet_watermark", "obs:exchange_core",
                          "obs:core_commit"))
