"""repro_torch.obs — tracing hooks of the serving stack.

Only what the scheduler, controller and engine reference is ported:
``Tracer`` / ``NULL_TRACER`` / ``TraceConfig`` / ``Event``.  The exporters
and the phase profiler wait for the observability slice."""
from repro_torch.obs.tracer import (  # noqa: F401
    NULL_TRACER,
    Event,
    NullTracer,
    TraceConfig,
    Tracer,
)
