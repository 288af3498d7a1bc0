"""Observability (counterpart of `bigdl_tpu.observability`).

- `spans`: nested host-side spans (each also a
  `torch.profiler.record_function`), `TraceContext` identity, Chrome /
  Perfetto export, several tracers merged into one file.
- `telemetry`: per-step run records (loss, lr, throughput, step time,
  grad/param norms, host RSS, device memory) fanned out to sinks (JSONL,
  in memory, a summary writer), with the reference's per-record-type
  contract (`RECORD_SCHEMAS`, `validate_record`).
- `health`: the NaN/Inf guard (warn / skip / raise), the straggler and
  throughput-regression monitors.
- `flight`: the crash flight recorder, dumped on `run_abort`,
  `fault_injected` and a NaN-guard raise.
- `costs`: the FLOP count of one call, the peak-FLOPs registry and MFU.
- `compilation`: `CompiledFunction`, one cost count on the meta device
  and one `compile` record a call signature, with its first-use time;
  the loops' steps and the engines' forwards run behind it.
- `export`: `PrometheusTextSink` and the stdlib `MetricsServer`
  (`GET /metrics`).
- `slo`: `SLO`, `SloEngine`, `default_slos` and `DEFAULT_WINDOWS`,
  multi-window burn-rate alerting over the record stream.

Both `LocalOptimizer` and `DistriOptimizer` take them through
`set_telemetry` / `set_tracer` / `set_health_monitors`; the serving
engines through `telemetry=` and `tracer=`.

Not ported (`ROADMAP.md` queue 1 item 9): `executable_costs` and
`jaxpr_flops` (they read a JAX executable or jaxpr; `count_flops` counts
instead).
"""

from bigdl_tpu_torch.observability.costs import (PEAK_BF16_FLOPS,
                                                 count_flops,
                                                 default_device_kind, mfu,
                                                 peak_flops)
from bigdl_tpu_torch.observability.compilation import CompiledFunction
from bigdl_tpu_torch.observability.export import (MetricsServer,
                                                  PrometheusTextSink)
from bigdl_tpu_torch.observability.flight import FlightRecorder
from bigdl_tpu_torch.observability.health import (HealthMonitor, NanGuard,
                                                  StragglerDetector,
                                                  ThroughputMonitor,
                                                  TrainingHealthError)
from bigdl_tpu_torch.observability.slo import (DEFAULT_WINDOWS, SLO,
                                              SloEngine, default_slos)
from bigdl_tpu_torch.observability.spans import (SpanTracer, TraceContext,
                                                 export_merged, merge_traces)
from bigdl_tpu_torch.observability.telemetry import (CompositeSink,
                                                     InMemorySink, JsonlSink,
                                                     RECORD_SCHEMAS,
                                                     SummarySink, Telemetry,
                                                     TelemetrySink,
                                                     device_memory_stats,
                                                     host_rss_mb,
                                                     sanitize_nonfinite,
                                                     validate_record)

__all__ = [
    "SpanTracer", "TraceContext", "merge_traces", "export_merged",
    "Telemetry", "TelemetrySink", "JsonlSink", "InMemorySink",
    "SummarySink", "CompositeSink", "host_rss_mb", "device_memory_stats",
    "RECORD_SCHEMAS", "validate_record", "sanitize_nonfinite",
    "HealthMonitor", "NanGuard", "StragglerDetector", "ThroughputMonitor",
    "TrainingHealthError", "FlightRecorder",
    "PEAK_BF16_FLOPS", "count_flops", "default_device_kind", "mfu",
    "peak_flops", "CompiledFunction", "PrometheusTextSink", "MetricsServer",
    "SLO", "SloEngine", "default_slos", "DEFAULT_WINDOWS",
]
