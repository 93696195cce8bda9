"""repro_torch.obs — unified tracing, precision timelines, and profiling hooks.

Standalone by design: this package imports nothing from repro_torch.serve /
repro_torch.adapt / repro_torch.spec, so every serving component can hold a
tracer without import cycles."""
from repro_torch.obs.export import (
    span_violations,
    to_chrome,
    to_prometheus,
    validate_chrome,
    write_chrome,
)
from repro_torch.obs.profile import PhaseProfiler, PhaseStats
from repro_torch.obs.timeline import format_timeline, precision_timeline
from repro_torch.obs.tracer import (
    NULL_TRACER,
    Event,
    NullTracer,
    TraceConfig,
    Tracer,
)

__all__ = [
    "NULL_TRACER",
    "Event",
    "NullTracer",
    "PhaseProfiler",
    "PhaseStats",
    "TraceConfig",
    "Tracer",
    "format_timeline",
    "precision_timeline",
    "span_violations",
    "to_chrome",
    "to_prometheus",
    "validate_chrome",
    "write_chrome",
]
