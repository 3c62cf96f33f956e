"""``repro_torch.obs`` — span tracer, stall attribution and metrics registry.

A copy of the reference package's framework-free ``obs`` modules (see
docs/observability.md for the user guide): the engine records the same
spans, stall buckets and instrument names, so traces and reports of the
two packages read alike.  The device-profiler session hook has no
counterpart yet.
"""
from .export import (TraceValidationError, chrome_trace,
                     trace_summary_table, validate_chrome_trace,
                     write_chrome_trace)
from .metrics import (NULL_REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, NullRegistry, get_registry,
                      use_registry)
from .stall import STAGES, PassStall, PipelineStallReport, StallClock
from .trace import NULL_TRACER, NullTracer, Tracer, get_tracer, use_tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "get_registry", "use_registry",
    "NullTracer", "NULL_TRACER", "Tracer", "get_tracer", "use_tracer",
    "STAGES", "PassStall", "PipelineStallReport", "StallClock",
    "TraceValidationError", "chrome_trace", "trace_summary_table",
    "validate_chrome_trace", "write_chrome_trace",
]
