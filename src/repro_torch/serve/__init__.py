"""repro_torch.serve — continuous-batching serving subsystem.

    scheduler.py  admission + slot lifecycle (WAITING/PREFILL/DECODE/
                  PREEMPTED/DONE): priority + earliest-deadline-first with
                  aging and preemption, or pure FIFO (policy="fifo")
    tenancy.py    Tenant / RequestClass — priority, entitlement share,
                  per-tenant accuracy budget, step-unit deadlines
    engine.py     masked decode step over the fixed slot array + streaming
                  API; preemption parks/resumes exact state rows
    config.py     ServeConfig — the frozen grouped construction surface
    paged.py      KVLayout protocol: DenseLayout (per-slot ring) and
                  PagedLayout (page pools, prefix sharing with copy-on-
                  write, page-pressure parking, precision-tiered pages)
    metrics.py    tok/s, TTFT, latency, slot occupancy, plan-cache hits,
                  per-tenant SLO attainment / fairness

``ServeEngine(model, params, config=ServeConfig(...))`` is the documented
construction path.  ``AdaptConfig(slo=...)`` closes the runtime-precision
loop (repro_torch.adapt); ``spec=SpecConfig(...)`` decodes self-speculatively
(repro_torch.spec); ``cache=CacheConfig(layout="paged")`` serves from page
pools; ``tenants=`` with ``slo=`` gives each tenant its own mode table and
controller; ``trace=TraceConfig(...)`` records events (repro_torch.obs).
"""
from repro_torch.serve.config import (  # noqa: F401
    AdaptConfig,
    CacheConfig,
    SchedulingConfig,
    ServeConfig,
)
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.metrics import ServeMetrics  # noqa: F401
from repro_torch.serve.paged import (  # noqa: F401
    DenseLayout,
    KVLayout,
    PagedLayout,
    PagePool,
    make_layout,
)
from repro_torch.serve.scheduler import Request, Scheduler, ragged_requests  # noqa: F401
from repro_torch.serve.tenancy import (  # noqa: F401
    RequestClass,
    Tenant,
    class_requests,
)
