"""Request admission and slot lifecycle for continuous batching.

The scheduler owns everything *per-request* and nothing *per-array*:
requests are submitted into an admission queue, admitted into free slots of
the fixed slot array as capacity opens up, and walk the lifecycle

    WAITING -> PREFILL -> DECODE -> (PREEMPTED -> DECODE)* -> DONE

Admission order (``policy="priority"``, the default) is a total order over
the waiting queue by the key

    (effective priority, deadline step, submission seq)

where effective priority = ``tenant.priority - age // aging_steps`` (aging:
a waiting request gains one priority rung every ``aging_steps`` scheduler
ticks, so no request starves behind an endless stream of more-urgent
arrivals — the effective priority falls without bound until it wins), the
deadline is ``submit_step + class.slo_steps`` (earliest-deadline-first
within a priority level), and ``seq`` is the submission counter — the
stable tie-break that pins equal-priority equal-arrival requests to
submission order.  ``policy="fifo"`` ignores tenancy entirely (key =
``(seq,)``): the pure-FIFO baseline the tenant sweep compares against.

Preemption (``preempt=True`` with the priority policy): when a waiter's
*base* priority is strictly more urgent than a running ticket's base
priority, the scheduler names a victim (the worst-key active ticket that
has run at least ``min_quantum`` tokens since its last admission — the
quantum bounds thrash).  Base-vs-base deliberately: aging drives admission
order only, so equal-priority traffic never preempts itself (the default
single-tenant config stays exactly FIFO) and a victim can never preempt
its own preemptor back.  The *engine* owns the victim's device state: it
parks the slot's state row, then calls :meth:`Scheduler.preempt`, which
requeues the ticket through the same budget-clamp bookkeeping every
admission uses — ``Ticket.remaining`` already measures decode budget left,
so a resumed ticket simply continues its burst accounting where it stopped.
Aging restarts at preemption (``queued_step`` resets): the victim re-earns
its way back instead of instantly reclaiming the slot it just lost.

Slot capacity is the only resource: a slot frees the moment its request
finishes or is preempted.  The decode budget is clamped against the
KV-cache capacity at submit time (eviction on ``max_len``): a request whose
prompt plus budget would overflow the cache is truncated to the tokens that
fit, never silently over-decoded.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np

from repro_torch.obs import NULL_TRACER
from repro_torch.serve.tenancy import (RequestClass, Tenant, normalize_classes,
                                 normalize_tenants)

# lifecycle states
WAITING = "WAITING"
PREFILL = "PREFILL"
DECODE = "DECODE"
PREEMPTED = "PREEMPTED"
DONE = "DONE"


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    rid: int = 0
    tenant: str = "default"
    rclass: str = "default"


@dataclasses.dataclass
class Ticket:
    """Per-request scheduler record (request + lifecycle + emitted tokens)."""

    rid: int
    prompt: np.ndarray
    max_new: int
    budget: int  # max_new clamped to cache capacity (eviction on max_len)
    tenant: str = "default"
    rclass: str = "default"
    priority: int = 1  # tenant priority at submit (lower = more urgent)
    deadline: float = math.inf  # absolute step: submit_step + slo_steps
    seq: int = 0  # submission counter — the stable tie-break
    submit_step: int = 0
    queued_step: int = 0  # aging reference; resets on preemption
    tokens_at_admit: int = 0  # quantum reference for preemption eligibility
    preemptions: int = 0
    state: str = WAITING
    slot: int = -1
    tokens: list[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def remaining(self) -> int:
        """Decode budget left — the clamp for multi-token (speculative)
        emission bursts: a burst never emits past the budget mid-round.
        Preemption rides on the same account: a resumed ticket keeps its
        emitted tokens, so ``remaining`` already measures what is left."""
        return max(self.budget - len(self.tokens), 0)


def ragged_requests(n: int, vocab: int, prompt_len: int, max_new: int,
                    rng: np.random.Generator) -> list[Request]:
    """Ragged serving workload shared by the launcher and the serve sweep:
    prompt lengths U[prompt_len/4 .. prompt_len], decode budgets
    U[max_new/2 .. max_new], rids 0..n-1."""
    return [
        Request(
            prompt=rng.integers(0, vocab, int(rng.integers(
                max(prompt_len // 4, 1), prompt_len + 1))).astype(np.int32),
            max_new=int(rng.integers(max(max_new // 2, 1), max_new + 1)),
            rid=i,
        )
        for i in range(n)
    ]


class Scheduler:
    #: trace sink (repro_torch.obs) — the engine swaps in its live tracer; the
    #: class default keeps a standalone Scheduler emit-free at no cost
    tracer = NULL_TRACER

    def __init__(self, slots: int, max_len: int, *,
                 tenants=None, classes=None, policy: str = "priority",
                 aging_steps: int = 8, preempt: bool = True,
                 min_quantum: int = 2):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if policy not in ("priority", "fifo"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        if aging_steps < 0:
            raise ValueError("aging_steps must be >= 0 (0 disables aging)")
        if min_quantum < 1:
            raise ValueError("min_quantum must be >= 1")
        self.slots = slots
        self.max_len = max_len
        self.tenants: dict[str, Tenant] = normalize_tenants(tenants)
        self.classes: dict[str, RequestClass] = normalize_classes(classes)
        self.policy = policy
        self.aging_steps = aging_steps
        self.preempt_enabled = bool(preempt) and policy == "priority"
        self.min_quantum = min_quantum
        self.clock = 0  # engine steps; advanced by tick()
        self.queue: list[Ticket] = []  # waiting + preempted, sorted at admit
        self.free: collections.deque[int] = collections.deque(range(slots))
        self.tickets: dict[int, Ticket] = {}  # all rids ever submitted
        self.by_slot: dict[int, Ticket] = {}  # occupied slots only
        self.completed: list[int] = []  # rids in completion order
        self.preemptions = 0  # total preempt() calls
        self.max_wait_steps = 0  # worst queue wait seen at any admission
        self._seq = 0

    # -- admission -----------------------------------------------------------

    def tick(self) -> None:
        """Advance the step clock (the engine calls this once per step).
        Aging and deadlines are measured in these ticks — engine steps, not
        wall clock — so scheduling decisions and the attainment gate are
        machine-independent."""
        self.clock += 1

    def submit(self, req: Request) -> int:
        """Enqueue a request (WAITING).  The decode budget is
        ``min(max_new, max_len - len(prompt) + 1)``: prefill writes the
        prompt, each decode step past the first token writes one cache row,
        so this is exactly what fits without overflowing the slot's cache."""
        n = len(req.prompt)
        if n < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if n > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {n} exceeds max_len "
                f"{self.max_len}"
            )
        if req.rid in self.tickets:
            # rids are the keys of every per-request record (tickets,
            # metrics, drain() output): reuse would silently overwrite the
            # earlier request's history
            raise ValueError(f"rid {req.rid} already submitted")
        tenant = self.tenants.get(req.tenant)
        if tenant is None:
            raise ValueError(
                f"request {req.rid}: unknown tenant {req.tenant!r} "
                f"(declared: {sorted(self.tenants)})")
        rc = self.classes.get(req.rclass)
        if rc is None:
            raise ValueError(
                f"request {req.rid}: unknown request class {req.rclass!r} "
                f"(declared: {sorted(self.classes)})")
        budget = max(min(req.max_new, self.max_len - n + 1), 0)
        t = Ticket(
            rid=req.rid, prompt=np.asarray(req.prompt, np.int32),
            max_new=req.max_new, budget=budget,
            tenant=tenant.name, rclass=rc.name, priority=tenant.priority,
            deadline=(self.clock + rc.slo_steps if rc.slo_steps is not None
                      else math.inf),
            seq=self._seq, submit_step=self.clock, queued_step=self.clock,
        )
        self._seq += 1
        self.tickets[req.rid] = t
        self.queue.append(t)
        return req.rid

    def eff_priority(self, t: Ticket) -> int:
        """Priority after aging: one rung more urgent per ``aging_steps``
        ticks waited — falls without bound, so any waiter eventually
        out-ranks any fresh arrival (the no-starvation lever)."""
        if not self.aging_steps:
            return t.priority
        return t.priority - (self.clock - t.queued_step) // self.aging_steps

    def admission_key(self, t: Ticket):
        """Total order over the waiting queue.  The trailing ``seq`` makes
        every comparison deterministic: equal-priority, equal-deadline
        (hence equal-arrival) requests admit in submission order."""
        if self.policy == "fifo":
            return (t.seq,)
        return (self.eff_priority(t), t.deadline, t.seq)

    def admit(self, can_admit=None) -> list[tuple[int, Ticket]]:
        """Move waiting requests into free slots in admission-key order
        until either runs out.  Fresh tickets transition WAITING -> PREFILL;
        preempted tickets re-admit as DECODE (the engine restores their
        parked state row instead of prefilling).  Zero-budget tickets
        (nothing fits the cache) complete immediately without a slot and
        are returned as ``(-1, ticket)`` so the caller can route the
        completion event (the engine's metrics must agree with
        ``completed`` — completing them silently here undercounted
        ``ServeMetrics.summary()['completed']``).

        ``can_admit(ticket) -> bool`` is the engine's capacity gate beyond
        free slots (the paged layout's free-page check).  A refused ticket
        stays queued in place and the scan continues: a smaller request
        further back may still fit — slot order is a *preference* under
        memory pressure, not a barrier — while the refused ticket keeps its
        admission-key rank for the next step."""
        out: list[tuple[int, Ticket]] = []
        keep = []
        for t in self.queue:
            if t.budget == 0:
                # nothing fits: complete immediately — needs no slot, so it
                # must not wait behind slot contention either
                self.complete(t.rid)
                out.append((-1, t))
            else:
                keep.append(t)
        keep.sort(key=self.admission_key)
        self.queue[:] = keep
        i = 0
        while i < len(self.queue) and self.free:
            t = self.queue[i]
            if can_admit is not None and not can_admit(t):
                if self.tracer.enabled:
                    # the layout refused capacity: this ticket waits in rank
                    # while the scan continues — admissions behind it are
                    # legal reorderings the replay harness must not call
                    # FIFO violations
                    self.tracer.emit("admit_defer", rid=t.rid,
                                     cause="layout_refusal")
                    self.tracer.inc("admit_defers")
                i += 1
                continue
            self.queue.pop(i)
            slot = self.free.popleft()
            t.slot = slot
            t.state = DECODE if t.tokens else PREFILL
            t.tokens_at_admit = len(t.tokens)
            self.max_wait_steps = max(self.max_wait_steps,
                                      self.clock - t.queued_step)
            self.by_slot[slot] = t
            out.append((slot, t))
        return out

    # -- preemption ----------------------------------------------------------

    def plan_preemptions(self) -> list[Ticket]:
        """Victims to evict this step so more-urgent waiters can run.

        For each waiter (best admission key first) that no free slot can
        serve, pick the worst active ticket — largest (base priority,
        deadline, seq) — whose *base* priority is strictly less urgent than
        the waiter's *base* priority and which has emitted at least
        ``min_quantum`` tokens since its last admission.  Base-vs-base,
        never aged: preemption exists for genuinely-more-urgent arrivals,
        while an aged equal-or-lower-priority waiter gets the next natural
        slot turnover instead (budgets are finite, so turnover is bounded —
        aging still guarantees no starvation through admission order
        alone).  A victim can therefore never preempt its preemptor back
        (its base priority is strictly worse), and the quantum guarantees
        every admission makes progress — together they bound thrash.

        The caller (engine) must park each victim's state row and then call
        :meth:`preempt` — this method only *names* victims, it mutates
        nothing."""
        if not (self.preempt_enabled and self.queue):
            return []
        victims: list[Ticket] = []
        taken: set[int] = set()
        free_virtual = len(self.free)
        for w in sorted((t for t in self.queue if t.budget > 0),
                        key=self.admission_key):
            if free_virtual > 0:
                free_virtual -= 1
                continue
            cands = [
                t for t in self.by_slot.values()
                if t.state == DECODE and t.rid not in taken
                and t.priority > w.priority
                and len(t.tokens) - t.tokens_at_admit >= self.min_quantum
            ]
            if not cands:
                continue
            v = max(cands, key=lambda t: (t.priority, t.deadline, t.seq))
            victims.append(v)
            taken.add(v.rid)
            if self.tracer.enabled:
                self.tracer.emit("preempt_plan", rid=v.rid, slot=v.slot,
                                 cause="priority", waiter=w.rid)
        return victims

    def page_victim(self) -> Ticket | None:
        """Name the page-pressure eviction victim: the *least* urgent
        running DECODE ticket by (base priority, deadline, seq).  Unlike
        :meth:`plan_preemptions` this ignores ``preempt`` and the quantum —
        memory pressure is a correctness condition (the pool physically
        cannot hold every active row's next tokens), not a fairness policy,
        so some row must park regardless of configuration.  Mutates
        nothing; the engine parks the row and calls :meth:`preempt`."""
        cands = [t for t in self.by_slot.values() if t.state == DECODE]
        if not cands:
            return None
        return max(cands, key=lambda t: (t.priority, t.deadline, t.seq))

    def preempt(self, rid: int) -> None:
        """Evict a running ticket back to the queue (PREEMPTED): the slot
        frees for the next admission, the ticket keeps its emitted tokens
        and budget (``remaining`` keeps counting down across the gap), and
        its aging reference resets to now."""
        t = self.tickets[rid]
        if t.slot < 0 or t.done:
            raise ValueError(f"rid {rid} is not running (state {t.state})")
        self.by_slot.pop(t.slot)
        self.free.append(t.slot)
        t.slot = -1
        t.state = PREEMPTED
        t.queued_step = self.clock
        t.preemptions += 1
        self.preemptions += 1
        self.queue.append(t)

    # -- lifecycle -----------------------------------------------------------

    def start_decode(self, rid: int) -> None:
        self.tickets[rid].state = DECODE

    def complete(self, rid: int) -> None:
        """DONE: release the slot for the next admission."""
        t = self.tickets[rid]
        if t.done:
            return
        t.state = DONE
        self.completed.append(rid)
        if t.slot >= 0:
            self.by_slot.pop(t.slot)
            self.free.append(t.slot)
            t.slot = -1

    # -- queries -------------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.queue or self.by_slot)

    @property
    def n_active(self) -> int:
        return len(self.by_slot)

    @property
    def n_waiting(self) -> int:
        return len(self.queue)
