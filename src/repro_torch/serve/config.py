"""ServeConfig: the grouped, frozen construction surface of ServeEngine.

``ServeEngine.__init__`` had grown to ~17 flat kwargs spanning four
subsystems.  This module groups them:

    ServeConfig(batch_slots, max_len,
                scheduling=SchedulingConfig(...),   # repro_torch.serve.scheduler
                adapt=AdaptConfig(...),             # repro_torch.adapt
                spec=SpecConfig(...),               # repro_torch.spec
                cache=CacheConfig(...))             # repro_torch.serve.paged

``ServeEngine(model, params, config=cfg)`` is the documented construction
path; the legacy flat kwargs remain as a deprecation shim that calls
:meth:`ServeConfig.from_kwargs`, and ``launch/serve.py`` builds its config
via :meth:`ServeConfig.from_flags`.  Everything is frozen: a config is a
value, shareable across engines and safe to put in test parametrizations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.adapt.pages import PageTierPolicy


@dataclasses.dataclass(frozen=True)
class SchedulingConfig:
    """Admission / preemption policy (repro_torch.serve.scheduler)."""

    tenants: Sequence | None = None
    classes: Sequence | None = None
    policy: str = "priority"
    preempt: bool = True
    aging_steps: int = 8
    min_quantum: int = 2

    def __post_init__(self):
        if self.policy not in ("priority", "fifo"):
            raise ValueError(f"unknown scheduling policy {self.policy!r}")


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Closed-loop runtime precision adaptation (repro_torch.adapt).  ``slo=None``
    disables the loop entirely; ``adapt=False`` keeps probes + timeline but
    never shifts (the monitored static baseline)."""

    slo: Any = None  # repro_torch.adapt.SLO | None
    adapt_every: int = 4
    adapt: bool = True
    controller: Any = None

    def __post_init__(self):
        if self.adapt_every < 1:
            raise ValueError("adapt_every must be >= 1")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV-cache layout selection (repro_torch.serve.paged).

    ``layout="dense"`` is today's per-slot ring cache, bit-identical to the
    pre-paged engine.  ``layout="paged"`` switches every KV group to the
    page-table pool: ``page_size`` tokens per page; ``pool_pages`` sizes the
    pool of the largest-capacity group (other groups scale proportionally;
    None = memory-equivalent to dense at ``batch_slots`` slots);
    ``tier_policy`` turns on precision-tiered pages (bf16 caches only);
    ``prefix_sharing`` shares read-only prompt-prefix pages between requests
    with copy-on-write forks.
    """

    layout: str = "dense"
    page_size: int = 16
    pool_pages: int | None = None
    tier_policy: PageTierPolicy | None = None
    prefix_sharing: bool = True

    def __post_init__(self):
        if self.layout not in ("dense", "paged"):
            raise ValueError(f"unknown cache layout {self.layout!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.pool_pages is not None and self.pool_pages < 1:
            raise ValueError("pool_pages must be >= 1")
        if self.tier_policy is not None and self.layout != "paged":
            raise ValueError("tier_policy requires layout='paged'")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything ServeEngine needs beyond (model, params)."""

    batch_slots: int
    max_len: int
    greedy: bool = True
    accuracy: float | None = None
    plan_backend: str | None = None
    prefill_tokens: int | None = None
    decode_accuracy_scale: float | None = None
    tune_table: Any = None
    scheduling: SchedulingConfig = dataclasses.field(
        default_factory=SchedulingConfig)
    adapt: AdaptConfig = dataclasses.field(default_factory=AdaptConfig)
    spec: Any = None  # repro_torch.spec.SpecConfig | None
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    #: repro_torch.obs.TraceConfig | True | None — None keeps the engine on the
    #: no-op NULL_TRACER; True means default knobs
    trace: Any = None

    def __post_init__(self):
        if self.batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if self.max_len < 1:
            raise ValueError("max_len must be >= 1")

    @classmethod
    def from_kwargs(cls, batch_slots: int, max_len: int, *,
                    greedy: bool = True, accuracy: float | None = None,
                    plan_backend: str | None = None,
                    prefill_tokens: int | None = None,
                    decode_accuracy_scale: float | None = None,
                    tune_table=None, slo=None, adapt_every: int = 4,
                    adapt: bool = True, controller=None, speculate=None,
                    tenants=None, classes=None,
                    scheduler_policy: str = "priority", preempt: bool = True,
                    aging_steps: int = 8, min_quantum: int = 2,
                    cache: CacheConfig | None = None,
                    trace=None) -> "ServeConfig":
        """The deprecation shim: the flat pre-ServeConfig kwarg surface of
        ``ServeEngine.__init__``, regrouped.  Legacy call sites keep working
        through this mapping (the full pre-redesign test suite passes
        against it)."""
        return cls(
            batch_slots=batch_slots, max_len=max_len, greedy=greedy,
            accuracy=accuracy, plan_backend=plan_backend,
            prefill_tokens=prefill_tokens,
            decode_accuracy_scale=decode_accuracy_scale,
            tune_table=tune_table,
            scheduling=SchedulingConfig(
                tenants=tenants, classes=classes, policy=scheduler_policy,
                preempt=preempt, aging_steps=aging_steps,
                min_quantum=min_quantum),
            adapt=AdaptConfig(slo=slo, adapt_every=adapt_every, adapt=adapt,
                              controller=controller),
            spec=speculate,
            cache=cache or CacheConfig(),
            trace=trace,
        )

    @classmethod
    def from_flags(cls, args, *, tenants=None, classes=None) -> "ServeConfig":
        """Build a config from the ``repro_torch.launch.serve`` argparse namespace
        (tenants/classes are constructed by the launcher for
        ``--multi-tenant`` and passed through)."""
        slo = None
        if args.adapt:
            from repro_torch.adapt import SLO

            slo = SLO(max_err=args.slo_err, target_ms=args.slo_ms or None)
        speculate = None
        if args.speculate:
            from repro_torch.spec import SpecConfig

            speculate = SpecConfig(k=args.draft_k,
                                   draft_shift=args.draft_shift)
        tier = None
        if getattr(args, "tier_levels", ""):
            levels = tuple(int(b) for b in args.tier_levels.split(","))
            tier = PageTierPolicy(
                levels=levels, cold_after=args.tier_cold_after,
                every=args.tier_every, budget=args.tier_budget or None)
        cache = CacheConfig(
            layout="paged" if getattr(args, "paged", False) else "dense",
            page_size=getattr(args, "page_size", 16),
            pool_pages=getattr(args, "pool_pages", 0) or None,
            tier_policy=tier,
            prefix_sharing=not getattr(args, "no_prefix_sharing", False),
        )
        trace = None
        if getattr(args, "trace", False) or getattr(args, "trace_out", ""):
            from repro_torch.obs import TraceConfig

            trace = TraceConfig(out=getattr(args, "trace_out", "") or None)
        slots = args.slots or max(args.requests, 1)
        return cls(
            batch_slots=slots,
            max_len=args.prompt_len + args.max_new + 8,
            accuracy=args.accuracy,
            prefill_tokens=max(args.prompt_len // 2, 1),
            tune_table=args.tune_table or None,
            plan_backend=getattr(args, "plan_backend", None),
            scheduling=SchedulingConfig(tenants=tenants, classes=classes,
                                        policy=args.scheduler_policy),
            adapt=AdaptConfig(slo=slo, adapt_every=args.adapt_every),
            spec=speculate,
            cache=cache,
            trace=trace,
        )
