"""Tenant / request-class abstractions for multi-tenant serving.

A real deployment never sees one architecture with one SLO: chat traffic
wants tight tail latency, batch jobs want throughput, audio-length prompts
want neither to starve.  This module is the vocabulary the scheduler,
engine, metrics and the tenant sweep share:

  * :class:`Tenant` — who is asking: admission priority (lower = more
    urgent), a token-rate entitlement ``share`` for fairness reporting, and
    an optional per-tenant ``accuracy`` budget that seeds that tenant's own
    ``repro_torch.adapt`` controller (one tenant's hot workload must not drag
    another tenant's mode table — DESIGN.md section Multi-tenant
    scheduling).
  * :class:`RequestClass` — what is being asked: a deadline ``slo_steps``
    measured in *engine steps* (machine-independent, the unit the EDF
    scheduler and the attainment gate both use), an optional wall-clock
    ``slo_ms`` for reporting, and the prompt/decode shape profile the
    workload generators draw from (chat: short/short, batch: long decodes,
    audio: long prompts).

Deadlines deliberately live on the class and priorities on the tenant: two
tenants can run the same "chat" class at different priorities, and one
tenant can mix classes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One request stream's identity: priority, entitlement, error budget.

    ``priority``: admission urgency, lower is more urgent (0 = front of the
    line).  ``share``: relative decode-slot entitlement weight used by the
    fairness report (``ServeMetrics.tenant_summary``) — it does not gate
    admission, it defines what "fair" means when measuring.  ``accuracy``:
    optional per-tenant relative-error budget; with ``ServeEngine(slo=...)``
    it becomes that tenant's own SLO ``max_err``, giving the tenant a
    private mode table + hysteresis controller.
    """

    name: str
    priority: int = 1
    share: float = 1.0
    accuracy: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant needs a non-empty name")
        if self.share <= 0:
            raise ValueError(f"tenant {self.name}: share must be positive")
        if self.accuracy is not None and self.accuracy <= 0:
            raise ValueError(f"tenant {self.name}: accuracy must be positive")


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One traffic shape: deadline + prompt/decode profile.

    ``slo_steps``: complete within this many *engine steps* of submission
    (None = no deadline).  Steps, not seconds: the scheduler's EDF term and
    the CI attainment gate must not depend on host speed.  ``slo_ms`` is
    the wall-clock target reported alongside (p50/p99), never scheduled on.
    ``prompt_len``/``max_new`` are the generator profile for this class —
    the scheduler itself only reads ``slo_steps``.
    """

    name: str
    slo_steps: int | None = None
    slo_ms: float | None = None
    prompt_len: int = 8
    max_new: int = 8

    def __post_init__(self):
        if not self.name:
            raise ValueError("request class needs a non-empty name")
        if self.slo_steps is not None and self.slo_steps < 1:
            raise ValueError(f"class {self.name}: slo_steps must be >= 1")
        if self.prompt_len < 1 or self.max_new < 0:
            raise ValueError(f"class {self.name}: bad shape profile")


DEFAULT_TENANT = Tenant("default", priority=1, share=1.0)
DEFAULT_CLASS = RequestClass("default")


def _normalize(items, default, kind) -> dict:
    """dict | iterable | None -> name-keyed registry always containing
    ``default`` (single-tenant callers never have to mention tenancy)."""
    reg = {default.name: default}
    if items is None:
        return reg
    if isinstance(items, dict):
        items = items.values()
    for it in items:
        if not isinstance(it, type(default)):
            raise TypeError(f"expected {type(default).__name__} for {kind}, "
                            f"got {type(it).__name__}")
        reg[it.name] = it
    return reg


def normalize_tenants(tenants) -> dict[str, Tenant]:
    return _normalize(tenants, DEFAULT_TENANT, "tenants")


def normalize_classes(classes) -> dict[str, RequestClass]:
    return _normalize(classes, DEFAULT_CLASS, "classes")


def class_requests(rc: RequestClass, tenant: Tenant, n: int, vocab: int,
                   rng: np.random.Generator, rid_base: int = 0) -> list:
    """n ragged requests drawn from one class's shape profile: prompt
    lengths U[prompt_len/2 .. prompt_len], budgets U[max_new/2 .. max_new],
    tagged with the tenant and class names (the sweep's workload unit)."""
    from repro_torch.serve.scheduler import Request

    return [
        Request(
            prompt=rng.integers(0, vocab, int(rng.integers(
                max(rc.prompt_len // 2, 1), rc.prompt_len + 1))).astype(np.int32),
            max_new=int(rng.integers(max(rc.max_new // 2, 1), rc.max_new + 1)),
            rid=rid_base + i,
            tenant=tenant.name,
            rclass=rc.name,
        )
        for i in range(n)
    ]
