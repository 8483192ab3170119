"""Fleet-wide observability: tracing, events, latency lineage, SLOs,
cost accounting, exporters (port of ``repro.obs``).

* ``obs.trace`` -- host span tracer (Chrome-trace export) whose spans
  are also ``torch.profiler`` ranges; ``DEVICE_STAGES`` names the
  tick's stages.
* ``obs.events`` -- the control plane's typed JSONL event log.
* ``obs.latency`` -- bucketed latency histograms and the event-time
  lineage banks, updated on the device inside the tick.
* ``obs.slo`` -- declared latency/drop targets with multi-window
  burn-rate evaluation over the lineage banks.
* ``obs.costmodel`` -- FLOPs and bytes of one tick a stage, counted as
  it runs, and the roofline against declared peaks.
* ``obs.export`` -- stable-schema metrics snapshots and the
  ``BENCH_<suite>.json`` writer.
"""
from repro_torch.obs.costmodel import (  # noqa: F401
    analyze,
    roofline,
    stage_table,
)
from repro_torch.obs.events import EVENT_KINDS, EventLog  # noqa: F401
from repro_torch.obs.export import (  # noqa: F401
    BENCH_SCHEMA_VERSION,
    bench_payload,
    metrics_snapshot,
    parse_derived,
    write_bench,
)
from repro_torch.obs.latency import (  # noqa: F401
    DEFAULT_EDGES,
    LINEAGE_STAGES,
    histogram_init,
    histogram_merge,
    histogram_percentiles,
    histogram_update,
    histogram_update_batch,
    lineage_init,
    lineage_percentiles,
    lineage_update,
)
from repro_torch.obs.slo import SLO, SloEvaluator, SloStatus  # noqa: F401
from repro_torch.obs.trace import DEVICE_STAGES, NULL_TRACER, Tracer  # noqa: F401
