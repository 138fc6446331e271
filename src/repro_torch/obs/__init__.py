"""Observability for the render pipeline: span tracing, a process-wide
metrics registry, and exporters.

    trace    — `Tracer` (nested host-side spans around the plan stages and
               the serving engine's dispatches; NoopTracer default = free
               when disabled), `use_tracer`, `current`
    metrics  — `MetricsRegistry` (counters/gauges/histograms with label
               sets, Prometheus text exposition), `get_registry`
    export   — JSONL span logs, Chrome trace-event JSON for Perfetto,
               metrics file dump, `torch_profiler_trace` (a device
               profile written as a Chrome trace)
"""
from repro_torch.obs.trace import (NoopTracer, Span, Tracer, current,
                                   set_tracer, use_tracer)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, get_registry)
from repro_torch.obs.export import (chrome_trace, prometheus_text,
                                    read_jsonl, span_records,
                                    torch_profiler_trace,
                                    write_chrome_trace, write_jsonl,
                                    write_metrics)

__all__ = [
    "Span", "Tracer", "NoopTracer", "current", "set_tracer", "use_tracer",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "get_registry",
    "span_records", "write_jsonl", "read_jsonl", "chrome_trace",
    "write_chrome_trace", "prometheus_text", "write_metrics",
    "torch_profiler_trace",
]
