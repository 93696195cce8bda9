"""repro_torch.serve — continuous-batching serving subsystem.

    scheduler.py  admission + slot lifecycle (WAITING/PREFILL/DECODE/
                  PREEMPTED/DONE): priority + earliest-deadline-first with
                  aging and preemption, or pure FIFO (policy="fifo")
    tenancy.py    Tenant / RequestClass — priority, entitlement share,
                  per-tenant accuracy budget, step-unit deadlines
    engine.py     masked decode step over the fixed slot array + streaming
                  API; preemption parks/resumes exact state rows
    config.py     ServeConfig — the frozen grouped construction surface
    paged.py      KVLayout protocol with DenseLayout (per-slot ring)
    metrics.py    tok/s, TTFT, latency, slot occupancy, plan-cache hits,
                  per-tenant SLO attainment / fairness

``ServeEngine(model, params, config=ServeConfig(...))`` is the documented
construction path.  ``AdaptConfig(slo=...)`` closes the runtime-precision
loop (repro_torch.adapt).  Speculation, paged layouts, per-tenant adaptation
and trace export are not ported yet and raise NotImplementedError.
"""
from repro_torch.serve.config import (  # noqa: F401
    AdaptConfig,
    CacheConfig,
    SchedulingConfig,
    ServeConfig,
)
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.metrics import ServeMetrics  # noqa: F401
from repro_torch.serve.paged import DenseLayout, KVLayout, make_layout  # noqa: F401
from repro_torch.serve.scheduler import Request, Scheduler, ragged_requests  # noqa: F401
from repro_torch.serve.tenancy import (  # noqa: F401
    RequestClass,
    Tenant,
    class_requests,
)
