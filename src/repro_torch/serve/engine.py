"""Masked step engine: true continuous batching over a fixed slot array.

``ServeEngine`` runs the streaming API

    rid = engine.submit(Request(prompt, max_new, rid))   # any time
    events = engine.step()                               # [(rid, token), ...]
    outputs = engine.drain()                             # run to completion

over one decode step.  The slot array is fixed at ``batch_slots``; per-slot
state (KV positions, lengths, decode position) lives in the per-slot
``DecodeState`` layout (``models.lm.init_decode_state(per_slot=True)``), so
slots at *different* sequence depths — and empty slots — share the same
step: finished rows are masked out (their state is frozen by a per-row
select), new requests join mid-flight by scattering a solo-prefilled row
into their slot.

Prefill runs per-request at the prompt's true length (batch=1) — no padded
positions ever enter the KV cache — then the resulting row is written into
the request's slot.

Precision phases: with ``accuracy=...`` the engine plans *two* policies via
``repro_torch.plan.plan_model_policy`` — one for prefill GEMMs
(prompt_tokens x d) and one for decode GEMMs (slots x d) — and runs each
phase under its own policy: the paper's run-time mode switch exercised
inside a single workload.

With ``AdaptConfig(slo=...)`` the decode phase runs with a mutable mode
table bound: every weight GEMM then goes through the mode-map kernel, which
reads its mode as data, so shifting the table builds nothing
(``kernel_build_count`` stays 1).

With ``spec=SpecConfig(...)`` the decode phase runs self-speculative rounds
(repro_torch.spec): the cheap end of the mode ladder drafts ``k`` tokens per
slot through the mode-map kernel, the exact baseline step verifies all
``k+1`` positions, and a rollback-select restores each slot to its accepted
prefix — outputs stay identical to this engine's plain greedy decode.

The steps the reference compiles with ``jax.jit`` — the masked step, the
modal step, the probe and the speculative round — are compiled steps here
(repro_torch.serve.graphs): on the card each is captured once as a CUDA
graph and every later call is ONE replay.  They read and write buffers that
outlive them: static inputs (``_tokens``, ``_active_dev`` and a device view
of each mode table, rewritten between replays) and the static decode state
``self.state``, whose tensors are written in place (``copy_``) and never
rebound.  On the CPU the same steps run eagerly on the same buffers.
Prefill stays eager: its length varies per request.

The host waits for the device only where the reference does: once per
decode step (the produced tokens), once per speculative round (drafts,
verify tokens and acceptance together), once per prefill (the first token),
once per probe (the two residuals).

With ``CacheConfig(layout="paged")`` the state's KV caches are page pools
(repro_torch.serve.paged): before each step the layout maps and
copy-on-write forks the pages the step will write, parking a page-pressure
victim when the pool runs dry; after it, page statistics and, every
``tier_policy.every`` decode steps, an eager tier pass outside the graphs.
A step writes the pools in place, so they are left out of the per-row merge
and the copy-back; the probe's step reads them without writing.

With ``tenants=`` and ``slo=`` each tenant owns a mode table and a
controller; the modal step binds, site by site, the most precise mode
among the tables of tenants with active slots (``_bound_scalars``) —
written into the step's device view, so the captured step and probe serve
every combination of tables — and each tenant's probe is masked to its
own slots.

With ``trace=`` the engine records typed events (repro_torch.obs) and a
``PhaseProfiler`` times prefill, decode and speculative rounds and
watches the capture and build counts for recompiles.  Every emit site is
host code between replays, never inside a captured body.  Each step is a
tree of host spans (``Tracer.span``):

    step > schedule, prefill (> prefill.forward, prefill.scatter,
           prefill.sample), pages, decode.inputs, decode_step or spec_round
           (> decode.replay (> capture), decode.sync), decode.emit, adapt,
           page_tick

and the device time of the model's blocks (repro_torch.obs.device) goes
onto the ``prefill`` and ``decode_step`` / ``spec_round`` events: the
compiled steps are captured inside a recording, so their graphs hold timing
events at every block boundary, and each eager prefill runs inside one.
Those times are read after the step's own sync, in ``decode.emit`` (for the
prefill, once its span has closed).  Tracing off, no recording is opened
and the graphs hold no event node.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.lm import LanguageModel, copy_state_, map_state
from repro_torch.obs import NULL_TRACER, PhaseProfiler, TraceConfig, Tracer
from repro_torch.obs.device import NULL_SPAN, Recording, device_span
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paged import batch_leaves, make_layout, restore_pools, save_pools
from repro_torch.serve.scheduler import Request, Scheduler, Ticket
from repro_torch.serve.tenancy import RequestClass, Tenant

__all__ = ["Request", "RequestClass", "ServeConfig", "ServeEngine", "Tenant"]


def _plan_phase(model: LanguageModel, tokens: int, accuracy: float,
                backend: str | None, tune_table=None):
    """Plan one phase's policy (prefill or decode) for its GEMM M-dim."""
    from repro_torch.core.precision import DF32_MODES
    from repro_torch.device import backend_of
    from repro_torch.plan import plan_model_policy

    base = model.cfg.policy
    policy, plans = plan_model_policy(
        model.cfg, tokens=tokens, accuracy=accuracy,
        backend=backend or backend_of(model.device),
        rounding=base.rounding, tune_table=tune_table,
    )
    if (
        base.impl == "native"
        and policy.impl == "xla"
        and not any(p.mode in DF32_MODES for p in plans.values())
    ):
        # keep the one-matmul execution path when the base policy chose it
        # and the planner has no better limb impl to offer — but never for
        # DF32 modes, where 'xla' IS the limb engine
        policy = policy.with_impl("native")
    return model.with_policy(policy), plans


def row_select(ax: int, new, old, active):
    """Per-row select along a state leaf's batch axis ``ax``: rows where
    ``active`` is False keep ``old`` exactly — the masking invariant of the
    masked steps.  Leaves with no batch axis (``ax < 0``) keep ``new``."""
    if ax < 0:
        return new
    shape = [1] * new.dim()
    shape[ax] = active.shape[0]
    return torch.where(active.reshape(shape), new, old)


class ServeEngine:
    #: decode-phase accuracy tightening: autoregressive decode feeds its
    #: rounding errors back (every generated token conditions the rest),
    #: while prefill errors are one-shot, so the decode phase plans at
    #: ``accuracy * DECODE_ACCURACY_SCALE`` — a budget near a mode boundary
    #: therefore flips the RMPM mode bits between the phases of one workload.
    DECODE_ACCURACY_SCALE = 2.0**-4

    def __init__(self, model: LanguageModel, params,
                 batch_slots: int | None = None, max_len: int | None = None,
                 greedy: bool = True, accuracy: float | None = None,
                 plan_backend: str | None = None,
                 prefill_tokens: int | None = None,
                 decode_accuracy_scale: float | None = None,
                 tune_table=None,
                 slo=None, adapt_every: int = 4, adapt: bool = True,
                 controller=None, speculate=None,
                 tenants=None, classes=None,
                 scheduler_policy: str = "priority",
                 preempt: bool = True, aging_steps: int = 8,
                 min_quantum: int = 2, cache=None,
                 config: ServeConfig | None = None):
        """``config=ServeConfig(...)`` is the documented construction path;
        the flat kwargs remain as a deprecation shim (regrouped through
        ``ServeConfig.from_kwargs``) and must not be mixed with ``config=``.

        The engine runs on ``model.device`` (``build_model`` defaults to the
        GPU and raises when there is none); ``params`` must live there.

        ``slo`` (repro_torch.adapt.SLO) turns on closed-loop runtime
        precision adaptation of the decode phase: the decode modes become a
        mutable ModeTable bound for every masked step; every ``adapt_every``
        decode steps a probe replays the step at the max-mode reference and
        one mode down, and the hysteresis controller shifts the table against
        the SLO.  ``adapt=False`` keeps the probes and mode timeline but
        never shifts.

        ``tenants`` / ``classes`` (repro_torch.serve.tenancy) declare the
        request streams multiplexed onto the slot array: the scheduler admits
        by (aged priority, deadline, seq) instead of FIFO, preempting running
        low-priority work by *parking its exact state row* (gather, requeue,
        scatter back at re-admission — never a re-prefill, so a preempted
        request's token stream stays identical to an uncontended run).
        """
        if config is not None:
            if batch_slots is not None or max_len is not None:
                raise ValueError(
                    "pass either config=ServeConfig(...) or the legacy flat "
                    "kwargs, not both")
            cfg = config
        else:
            if batch_slots is None or max_len is None:
                raise TypeError(
                    "ServeEngine requires batch_slots and max_len (or a "
                    "config=ServeConfig(...))")
            cfg = ServeConfig.from_kwargs(
                batch_slots, max_len, greedy=greedy, accuracy=accuracy,
                plan_backend=plan_backend, prefill_tokens=prefill_tokens,
                decode_accuracy_scale=decode_accuracy_scale,
                tune_table=tune_table, slo=slo, adapt_every=adapt_every,
                adapt=adapt, controller=controller, speculate=speculate,
                tenants=tenants, classes=classes,
                scheduler_policy=scheduler_policy, preempt=preempt,
                aging_steps=aging_steps, min_quantum=min_quantum,
                cache=cache)
        self.config = cfg
        batch_slots, max_len = cfg.batch_slots, cfg.max_len
        accuracy = cfg.accuracy
        sch = cfg.scheduling
        slo = cfg.adapt.slo
        if not cfg.greedy:
            # the masked step and the solo prefill take argmax; pretending
            # to honour a sampling flag would silently return greedy tokens
            raise NotImplementedError(
                "ServeEngine only implements greedy decoding: temperature "
                "sampling is not wired into the masked step / prefill. "
                "Pass greedy=True.")
        self.device = model.device
        # metrics first: its plan-cache snapshot must predate phase planning
        # so plan_cache_delta() counts the plans this engine triggers
        self.metrics = ServeMetrics(batch_slots)
        if cfg.trace:
            self.tracer = Tracer(cfg.trace if isinstance(cfg.trace, TraceConfig)
                                 else None)
        else:
            self.tracer = NULL_TRACER
        self.profiler = PhaseProfiler(self.tracer)
        if accuracy is not None:
            # Per-phase planning: decode GEMMs see M = batch_slots at a
            # tightened budget, prefill GEMMs see M = prompt tokens at the
            # caller's budget.
            scale = (self.DECODE_ACCURACY_SCALE
                     if cfg.decode_accuracy_scale is None
                     else cfg.decode_accuracy_scale)
            self.model_decode, decode_plans = _plan_phase(
                model, batch_slots, accuracy * scale, cfg.plan_backend,
                cfg.tune_table)
            self.model_prefill, prefill_plans = _plan_phase(
                model, cfg.prefill_tokens or max_len, accuracy,
                cfg.plan_backend, cfg.tune_table)
            self.phase_plans = {"prefill": prefill_plans, "decode": decode_plans}
            self.plans = {
                f"{phase}/{op}": p
                for phase, plans in self.phase_plans.items()
                for op, p in plans.items()
            }
        else:
            self.model_decode = self.model_prefill = model
            self.phase_plans = {}
            self.plans = {}
        self.model = self.model_decode
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.greedy = True
        self.scheduler = Scheduler(
            batch_slots, max_len, tenants=sch.tenants, classes=sch.classes,
            policy=sch.policy, preempt=sch.preempt,
            aging_steps=sch.aging_steps, min_quantum=sch.min_quantum)
        self.scheduler.tracer = self.tracer
        self.metrics.set_tenant_shares(
            {name: t.share for name, t in self.scheduler.tenants.items()})
        #: rid -> (parked per-slot state row, cache length) of preempted
        #: requests, scattered back verbatim at re-admission
        self._parked: dict[int, tuple[object, int]] = {}
        #: the KV layout owns the decode state's shape and the per-row
        #: gather/scatter (repro_torch.serve.paged)
        self.layout = make_layout(cfg.cache, self.model_decode,
                                  batch_slots, max_len)
        self.layout.tracer = self.tracer
        #: the static decode state: compiled steps read and write these
        #: tensors in place, so they are never rebound (``_set_state``)
        self.state = self.layout.init()
        # solo-prefill template: one per-slot row, reused for every prefill
        # (decode_step never modifies the state it is given)
        self._solo0 = self.model_prefill.init_decode_state(
            1, max_len, per_slot=True)
        self._axes = self.layout.axes
        # host-side slot mirrors
        self._active = np.zeros((batch_slots,), bool)
        self._last_tok = np.zeros((batch_slots,), np.int32)
        #: tokens currently in each slot's cache
        self._row_len = np.zeros((batch_slots,), np.int64)
        # -- runtime adaptation (repro_torch.adapt) --------------------------
        self.slo = slo
        self._adapt = bool(cfg.adapt.adapt)
        self._last_step_ms: float | None = None
        self._last_step_tokens = 1.0
        if self.phase_plans:
            self._static_decode_label = self.phase_plans["decode"]["mlp_up"].mode.name
        else:
            self._static_decode_label = model.cfg.policy.default.name
        #: per-tenant adaptation (tenants= with slo=): each tenant owns a
        #: private ModeTable + controller; the modal step binds the per-site
        #: max across tenants with active slots (``_bound_scalars``), so a
        #: tenant needing precision always gets at least its own table's
        #: modes — isolation with one captured step
        self.tenant_tables: dict[str, object] = {}
        self.tenant_ctrl: dict[str, object] = {}
        self._per_tenant_adapt = slo is not None and sch.tenants is not None
        if slo is not None:
            from repro_torch.adapt import SLO, HysteresisController, ModeTable

            def make_table():
                if self.phase_plans:
                    return ModeTable.from_plans(self.phase_plans["decode"])
                return ModeTable.from_policy(model.cfg.policy)

            if self._per_tenant_adapt:
                if cfg.adapt.controller is not None:
                    raise ValueError(
                        "controller= is a single shared instance; with "
                        "tenants= each tenant gets its own controller — "
                        "set per-tenant budgets via Tenant.accuracy instead")
                for name, ten in self.scheduler.tenants.items():
                    t_slo = SLO(
                        max_err=(ten.accuracy if ten.accuracy is not None
                                 else slo.max_err),
                        target_ms=slo.target_ms,
                        down_factor=slo.down_factor)
                    self.tenant_tables[name] = make_table()
                    ctrl = HysteresisController(t_slo)
                    ctrl.tracer, ctrl.name = self.tracer, f"adapt/{name}"
                    self.tenant_ctrl[name] = ctrl
                self.mode_table = None
                self.controller = None
            else:
                self.mode_table = make_table()
                self.controller = cfg.adapt.controller or HysteresisController(slo)
                self.controller.tracer = self.tracer
                self.controller.name = "adapt"
            self.adapt_every = max(int(cfg.adapt.adapt_every), 1)
        else:
            self.mode_table = None
            self.controller = None
        # -- self-speculative decoding (repro_torch.spec) --------------------
        self.spec = None
        if cfg.spec is not None:
            self._init_spec(cfg.spec)
        self._init_compiled_steps()

    def _init_spec(self, spec) -> None:
        """Wire the speculative round: the verify table is the engine's live
        adaptive table when ``slo`` is set (so the SLO controller keeps
        owning output quality) or the planner/policy decode modes otherwise;
        the draft table is that table shifted ``draft_shift`` rungs down,
        retuned at run time by the acceptance controller."""
        from repro_torch.adapt import ModeTable
        from repro_torch.spec import AcceptanceController, SpecConfig
        from repro_torch.spec.rollout import build_spec_round

        if not isinstance(spec, SpecConfig):
            raise TypeError(
                f"speculate must be a repro_torch.spec.SpecConfig, got {type(spec)}")
        if self.tenant_tables:
            # the speculative round binds ONE draft/verify table pair per
            # round; per-tenant tables would need per-slot mode binding
            # inside the round — not built, so refuse rather than verify
            # tenant A under tenant B's modes
            raise NotImplementedError(
                "speculate= with per-tenant adaptation (tenants= and slo=) "
                "is not supported: the spec round verifies under one mode "
                "table. Drop slo= (static speculation works with tenants=) "
                "or drop speculate=.")
        self.spec = spec
        if self.mode_table is not None:
            self._spec_table = self.mode_table  # adaptive verify (slo path)
        elif self.phase_plans:
            self._spec_table = ModeTable.from_plans(self.phase_plans["decode"])
        else:
            self._spec_table = ModeTable.from_policy(self.model_decode.cfg.policy)
        ladder = int(self._spec_table.max_mode) - int(self._spec_table.min_mode)
        self._draft_shift = max(1, min(spec.draft_shift, max(ladder, 1)))
        self._accept_ctrl = (
            AcceptanceController(spec, ladder, shift=self._draft_shift)
            if spec.adapt and ladder > 0 else None)
        if self._accept_ctrl is not None:
            self._accept_ctrl.controller.tracer = self.tracer
            self._accept_ctrl.controller.name = "accept"
        self._spec_round = build_spec_round(
            self.model_decode, self._axes, spec.k,
            modal_verify=self.slo is not None)
        self._spec_window = [0, 0]  # (drafted, agreed) since last tick

    def _init_compiled_steps(self) -> None:
        """The static inputs and one compiled step (repro_torch.serve.graphs)
        per step this engine runs: the decode step (plain, or modal when it
        adapts) or the speculative round, and the probe when it adapts."""
        from repro_torch.serve.graphs import CompiledStep

        dev = self.device
        self._tokens = torch.zeros((self.slots, 1), dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros((self.slots,), dtype=torch.bool, device=dev)
        # one memory pool for all of this engine's graphs (replayed one at a
        # time, outputs read before the next replay)
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self._step_graph = self._round_graph = self._probe_graph = None
        common = dict(snapshot=self._snapshot, pool=pool, tracer=self.tracer)
        if self.spec is not None:
            self._draft_modes = self._spec_table.device_view(dev)
            self._verify_modes = (self._spec_table.device_view(dev)
                                  if self.slo is not None else None)
            self._round_graph = CompiledStep(
                self._spec_round_body, dev, name="spec_round", **common)
        elif self.slo is not None:
            self._step_modes = self._site_table.device_view(dev)
            self._step_graph = CompiledStep(
                self._modal_step_body, dev, name="masked_step_modal", **common)
        else:
            self._step_graph = CompiledStep(
                self._plain_step_body, dev, name="masked_step", **common)
        if self.slo is not None:
            self._probe_modes = self._site_table.device_view(dev)
            self._probe_graph = CompiledStep(self._probe_body, dev, name="probe", pool=pool,
                                             tracer=self.tracer)

    def close(self) -> None:
        """Drop the compiled steps' graphs and their memory pool now.  (A
        dropped engine frees them as well, without a cycle collection: the
        steps hold the engine weakly.)  A later step captures again."""
        for g in (self._step_graph, self._round_graph, self._probe_graph):
            if g is not None:
                g.close()

    @property
    def _site_table(self):
        """A table over the adapted sites: the shared one, or under
        per-tenant adaptation any tenant's (every table is made from the
        same plans, so all have the same sites)."""
        if self.mode_table is not None:
            return self.mode_table
        return next(iter(self.tenant_tables.values()))

    @property
    def _ahead(self) -> int:
        """Tokens one compiled step appends to each active row: 1, or the
        speculative round's k + 1."""
        return self.spec.k + 1 if self.spec is not None else 1

    def _snapshot(self):
        """Save what one compiled step overwrites in the static state — the
        per-row leaves (a step's merge and copy-back write them whole) and,
        paged, the pool slots of each row's next ``_ahead`` appends (the
        pools are written in place and too large to clone) — and return the
        function that writes it back."""
        leaves = batch_leaves(self._axes, self.state)
        saved = [x.clone() for x in leaves]
        pools = save_pools(self.state, self._ahead)

        def restore():
            for x, old in zip(leaves, saved):
                x.copy_(old)
            restore_pools(self.state, pools)

        return restore

    # -- the steps -------------------------------------------------------------

    def _merge(self, new_state, state, active):
        return map_state(
            lambda ax, new, old: row_select(ax, new, old, active),
            self._axes, new_state, state)

    def _masked_step(self, params, tokens, state, active):
        """One decode token for every slot; rows where ``active`` is False
        keep their exact prior state (cache, positions, lengths) — finished
        and empty slots are inert, so a freed slot can be re-filled at any
        step without touching the others."""
        logits, new_state = self.model_decode.decode_step(params, tokens, state)
        return self._sample_and_merge(logits, new_state, state, active)

    def _sample_and_merge(self, logits, new_state, state, active):
        """The masked step's tail: each row's greedy token (device span
        ``sample``) and the per-row select of the new state (``state``)."""
        with device_span("state"):
            merged = self._merge(new_state, state, active)
        with device_span("sample"):
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), merged

    def _masked_step_modal(self, params, tokens, state, active, modes):
        """The masked step with the mode table bound: ``modes`` is a dict of
        host ints or of device scalars (a ``DeviceModes`` view), so every
        table mutation between steps changes only the data the kernels read
        — the paper's run-time reconfiguration, with nothing built."""
        from repro_torch.adapt import bind_modes

        with bind_modes(modes):
            logits, new_state = self.model_decode.decode_step(
                params, tokens, state)
        return self._sample_and_merge(logits, new_state, state, active)

    # -- the compiled steps' bodies: static inputs in, static state written --

    def _plain_step_body(self):
        next_tok, merged = self._masked_step(
            self.params, self._tokens, self.state, self._active_dev)
        with device_span("state"):
            copy_state_(self.state, merged)
        return next_tok

    def _modal_step_body(self):
        next_tok, merged = self._masked_step_modal(
            self.params, self._tokens, self.state, self._active_dev,
            self._step_modes.scalars)
        with device_span("state"):
            copy_state_(self.state, merged)
        return next_tok

    def _probe_body(self):
        """One shadow forward at the probe view's modes; the state is read,
        never written (``decode_step`` is out of place, and a paged state's
        pools are read without writing)."""
        from repro_torch.adapt import bind_modes

        with bind_modes(self._probe_modes.scalars):
            logits, _ = self.model_decode.decode_step(
                self.params, self._tokens, self.state, write_pools=False)
        return logits[:, -1]

    def _spec_round_body(self):
        drafts, greedy, n_acc, new_state = self._spec_round(
            self.params, self._tokens, self.state, self._active_dev,
            self._draft_modes.scalars,
            {} if self._verify_modes is None else self._verify_modes.scalars)
        with device_span("state"):
            copy_state_(self.state, new_state)
        # (k, B) drafts, (k+1, B) verify tokens, (B,) acceptance: one read
        return torch.cat([drafts, greedy, n_acc[None]])

    def _set_state(self, new_state) -> None:
        """Make ``new_state`` the engine's state by writing it into the
        static state's tensors (a compiled step holds their addresses)."""
        if new_state is not self.state:
            copy_state_(self.state, new_state)

    # -- streaming API -------------------------------------------------------

    def submit(self, req: Request) -> int:
        """Enqueue a request; it joins a slot on the next ``step()`` with
        free capacity.  Returns the rid."""
        rid = self.scheduler.submit(req)
        t = self.scheduler.tickets[rid]
        rc = self.scheduler.classes[t.rclass]
        self.metrics.on_submit(
            rid, tenant=t.tenant, rclass=t.rclass,
            slo_steps=rc.slo_steps, slo_ms=rc.slo_ms, step=t.submit_step)
        if self.tracer.enabled:
            self.tracer.emit(
                "submit", rid=rid, step=t.submit_step, tenant=t.tenant,
                rclass=t.rclass, prompt_len=len(t.prompt), budget=t.budget)
            self.tracer.inc("submitted")
        return rid

    def step(self) -> list[tuple[int, int]]:
        """One engine step: advance the scheduler clock, park any
        preemption victims (exact state-row gather + requeue), admit
        waiting requests into free slots (fresh: one solo prefill emitting
        the first token; preempted: scatter the parked row back — no new
        token, the request just continues), then run one masked batched
        decode step for every active slot.  Returns this step's
        (rid, token) events in emission order."""
        with self.tracer.span("step"):
            return self._step()

    def _step(self) -> list[tuple[int, int]]:
        events: list[tuple[int, int]] = []
        tr = self.tracer
        with tr.span("schedule"):
            self.scheduler.tick()
            tr.step = self.scheduler.clock
            for victim in self.scheduler.plan_preemptions():
                self._park_slot(victim, cause="priority")
            self.layout.begin_admission()
            admitted = self.scheduler.admit(can_admit=self._can_admit)
        for slot, ticket in admitted:
            if slot < 0:
                # zero-budget admission (nothing fits the cache): the
                # scheduler completed it without a slot
                self.metrics.on_done(ticket.rid, step=self.scheduler.clock)
                if tr.enabled:
                    tr.emit("done", rid=ticket.rid, slot=-1, cause="zero_budget")
                continue
            if ticket.tokens:
                self._resume_slot(slot, ticket)
                continue
            if tr.enabled:
                tr.emit("admit", rid=ticket.rid, slot=slot,
                        tenant=ticket.tenant, rclass=ticket.rclass)
            first = self._prefill_slot(slot, ticket)
            self.metrics.on_first_token(ticket.rid)
            events.append((ticket.rid, first))
            self._emit(ticket, slot, first)
        if self._active.any():
            with tr.span("pages"):
                self._prepare_pages()
        if self._active.any():
            if self.spec is not None:
                events.extend(self._spec_step())
            else:
                events.extend(self._decode_step())
            if (self.slo is not None
                    and self.metrics.decode_steps % self.adapt_every == 0
                    and self._active.any()):
                with tr.span("adapt"):
                    if self._per_tenant_adapt:
                        self._adapt_tick_tenants()
                    else:
                        self._adapt_tick()
            self._page_tick()
        return events

    def _can_admit(self, ticket: Ticket) -> bool:
        """Admission gate handed to the scheduler: the layout says whether
        it can map this ticket's cache content (dense: always — the free
        slot IS the capacity)."""
        if ticket.rid in self._parked:
            return self.layout.can_admit(self._parked[ticket.rid][1])
        return self.layout.can_admit(len(ticket.prompt),
                                     prompt=ticket.prompt)

    def _prepare_pages(self) -> None:
        """Paged allocation-on-append, before the step: every active row gets
        pages covering the tokens this step will write (1 plain decode, k+1
        speculative), private to the row.  When the pool cannot serve a row,
        the scheduler names a page-pressure victim — lowest effective
        priority among running requests — and its exact state parks (the
        same bit-exact preemption path tenancy uses), freeing its pages;
        repeat until the survivors fit.  Dense layouts return no failures
        and this is a no-op."""
        while self._active.any():
            lengths = {int(s): int(self._row_len[s])
                       for s in np.nonzero(self._active)[0]}
            state, failed = self.layout.prepare_step(self.state, lengths, self._ahead)
            self._set_state(state)
            if not failed:
                return
            victim = self.scheduler.page_victim()
            if victim is None or victim.slot is None:
                victim = self.scheduler.by_slot[failed[0]]
            self._park_slot(victim, cause="page_pressure")
            self.metrics.on_page_evict()
            if self.tracer.enabled:
                self.tracer.emit("page_evict", rid=victim.rid,
                                 cause="page_pressure")
                self.tracer.inc("page_evictions")

    def _page_tick(self) -> None:
        """Post-step page accounting: occupancy/sharing stats every step,
        one tier demotion/measurement pass every ``tier_policy.every``
        decode steps (repro_torch.adapt.pages), eager, between replays."""
        stats = self.layout.page_stats()
        if stats is None:
            return
        with self.tracer.span("page_tick"):
            self._page_tick_stats(stats)

    def _page_tick_stats(self, stats) -> None:
        self.metrics.on_page_stats(stats)
        tp = self.config.cache.tier_policy
        if tp is None or self.metrics.decode_steps % tp.every != 0:
            return
        lengths = {int(s): int(self._row_len[s])
                   for s in np.nonzero(self._active)[0]}
        state, tstats = self.layout.tier_tick(
            self.state, lengths, self.metrics.decode_steps)
        self._set_state(state)
        if tstats is not None:
            self.metrics.on_page_tier(self.metrics.decode_steps, tstats)
            if self.tracer.enabled:
                self.tracer.emit(
                    "tier_tick",
                    cause="budget" if tp.budget else "open_loop",
                    keep=tstats.get("keep"), depth=tstats.get("depth"),
                    demoted=tstats.get("demoted"),
                    promoted=tstats.get("promoted"),
                    err=tstats.get("err"))
                self.tracer.inc("tier_demotions", tstats.get("demoted", 0))

    def _park_slot(self, victim: Ticket, cause: str = "priority") -> None:
        """Preempt a running request: gather its exact per-slot state row
        (as a dense batch-1 row, whatever the layout), free the slot — and,
        paged, the row's pages — and requeue the ticket.  Nothing is
        recomputed at resume — ``_resume_slot`` scatters this row back, so
        the token stream continues identically.  ``cause`` stamps the trace
        event ("priority" preemption or "page_pressure" eviction)."""
        slot = victim.slot
        self._parked[victim.rid] = (
            self.layout.gather_row(self.state, slot),
            int(self._row_len[slot]))
        self._set_state(self.layout.free_row(self.state, slot))
        self._active[slot] = False
        self.scheduler.preempt(victim.rid)
        self.metrics.on_preempt(victim.rid)
        if self.tracer.enabled:
            self.tracer.emit("preempt", rid=victim.rid, slot=slot,
                             cause=cause)
            self.tracer.inc("preemptions")

    def _resume_slot(self, slot: int, ticket: Ticket) -> None:
        """Re-admit a preempted request: scatter its parked state row into
        the (possibly different) slot and rearm the host mirrors.  No token
        is emitted and no prefill runs — the next masked step continues
        from ``ticket.tokens[-1]`` exactly as if the gap never happened."""
        row, length = self._parked.pop(ticket.rid)
        self._set_state(self.layout.scatter_row(
            self.state, row, slot, length=length))
        self._row_len[slot] = length
        self._active[slot] = True
        self._last_tok[slot] = ticket.tokens[-1]
        if self.tracer.enabled:
            self.tracer.emit("resume", rid=ticket.rid, slot=slot,
                             cache_len=length)

    def _tenant_active(self) -> dict[str, int]:
        """Active slots per tenant right now — metrics attribution for the
        fairness report (share of decode-slot work actually consumed)."""
        counts: dict[str, int] = {}
        for slot in np.nonzero(self._active)[0]:
            name = self.scheduler.by_slot[int(slot)].tenant
            counts[name] = counts.get(name, 0) + 1
        return counts

    def _bound_scalars(self, tenant_active: dict[str, int]):
        """(modes, label) to bind this step under per-tenant adaptation:
        the per-site *maximum* (most precise) mode across the tables of
        tenants with active slots, as host ints for the step's device view.
        Each tenant therefore always runs at least as precisely as its own
        table demands — its controller can only see errors at or below what
        it asked for — while tables stay isolated (a hot tenant shifting up
        never mutates a cold tenant's table, and costs the cold tenant
        nothing once the hot tenant's slots drain)."""
        names = [n for n in tenant_active if n in self.tenant_tables]
        if not names:  # no active slots: probe-only callers, bind any table
            names = list(self.tenant_tables)
        combined: dict[str, object] = {}
        for n in names:
            for site, m in self.tenant_tables[n].modes().items():
                cur = combined.get(site)
                if cur is None or int(m) > int(cur):
                    combined[site] = m
        label_names = sorted({m.name for m in combined.values()})
        label = (label_names[0] if len(label_names) == 1
                 else "/".join(label_names))
        return {s: int(m) for s, m in combined.items()}, label

    def _device_inputs(self):
        """Write the host slot mirrors into the static inputs and return them
        (``tokens`` (B, 1) int32, ``active`` (B,) bool).  The copies are
        enqueued ahead of the step from pageable memory, which CUDA stages
        before ``copy_`` returns: no sync, and the mirrors may change at
        once."""
        self._tokens.copy_(torch.from_numpy(self._last_tok[:, None]), non_blocking=True)
        self._active_dev.copy_(torch.from_numpy(self._active), non_blocking=True)
        return self._tokens, self._active_dev

    def _decode_step(self) -> list[tuple[int, int]]:
        """One masked batched decode step (the non-speculative path): one
        replay of the plain or the modal compiled step."""
        events: list[tuple[int, int]] = []
        tr = self.tracer
        with tr.span("decode.inputs"):
            self._device_inputs()
            tenant_active = self._tenant_active()
        n_active = int(self._active.sum())
        t0 = time.perf_counter()
        with tr.span("decode_step", n_active=n_active) as sp:
            if self.slo is not None:
                if self._per_tenant_adapt:
                    scalars, label = self._bound_scalars(tenant_active)
                else:
                    scalars, label = self.mode_table.scalars(), self.mode_table.label()
                self._step_modes.write(scalars)  # skipped when nothing changed
            else:
                label = self._static_decode_label
            with tr.span("decode.replay"):
                out = self._step_graph()
            with tr.span("decode.sync"):
                produced = out.cpu().numpy()  # syncs the step
            self._last_step_ms = (time.perf_counter() - t0) * 1e3
        with tr.span("decode.emit"):
            self.metrics.on_decode_step(
                n_active, mode=label, tenant_active=tenant_active)
            if tr.enabled:
                sp.data["mode"] = label
                self._read_device(sp, self._step_graph)
                tr.set_gauge("active_slots", n_active)
                self.profiler.record("decode", self._last_step_ms / 1e3,
                                     tokens=n_active)
                self.profiler.observe_cache("decode_step", self._step_graph.captures)
            for slot in np.nonzero(self._active)[0]:
                ticket = self.scheduler.by_slot[int(slot)]
                tok = int(produced[slot])
                self._row_len[slot] += 1  # this step appended one KV entry
                events.append((ticket.rid, tok))
                self._emit(ticket, int(slot), tok)
        return events

    def _read_device(self, sp, graph) -> None:
        """The device time of the step ``graph`` ran (its sync done) onto
        the step's span ``sp``: ``device_ms`` (the whole replay), and
        ``sites_ms`` / ``sites_n`` per device span; and the counters."""
        device_ms, sites_ms, sites_n = graph.read()
        sp.data.update(device_ms=device_ms, sites_ms=sites_ms, sites_n=sites_n)
        self._count_device(sp.kind, sites_ms, device_ms)

    def _count_device(self, kind: str, sites_ms: dict[str, float],
                      device_ms: float | None = None) -> None:
        """Counters ``device_ms/<kind>`` (the whole step) and
        ``device_ms/<kind>/<span path>``."""
        if device_ms is not None:
            self.tracer.inc(f"device_ms/{kind}", device_ms)
        for path, ms in sites_ms.items():
            self.tracer.inc(f"device_ms/{kind}/{path}", ms)

    def _spec_step(self) -> list[tuple[int, int]]:
        """One speculative round: draft k cheap tokens per slot, verify all
        k+1 positions with the exact baseline step, emit each slot's
        accepted prefix plus the correction token (clamped to its remaining
        decode budget); the round rolls the state back on the device."""
        events: list[tuple[int, int]] = []
        tr = self.tracer
        with tr.span("decode.inputs"):
            active_np = self._active.copy()
            self._device_inputs()
        k = self.spec.k
        t0 = time.perf_counter()
        with tr.span("spec_round") as sp:
            self._draft_modes.write(self._spec_table.scalars_shifted(-self.draft_shift))
            if self._verify_modes is not None:
                self._verify_modes.write(self._spec_table.scalars())
            with tr.span("decode.replay"):
                out = self._round_graph()
            with tr.span("decode.sync"):
                host = out.cpu().numpy()  # the round's one sync
            drafts, greedy, n_acc = host[:k], host[k:2 * k + 1], host[2 * k + 1]
            self._last_step_ms = (time.perf_counter() - t0) * 1e3
        with tr.span("decode.emit"):
            n_active = int(active_np.sum())
            self.metrics.on_decode_step(
                n_active,
                mode=(self.mode_table.label() if self.mode_table is not None
                      else self._static_decode_label),
                tenant_active=self._tenant_active(),
            )
            accepted = agreed = emitted = 0
            for slot in np.nonzero(active_np)[0]:
                ticket = self.scheduler.by_slot[int(slot)]
                j = int(n_acc[slot])
                # the rolled-back cache holds the accepted prefix + correction
                # (budget clamping truncates *emission*, not the cache)
                self._row_len[slot] += j + 1
                # two accounts: metrics credit only drafts that were *emitted*
                # (a budget-truncated tail did no useful work), while the
                # controller sees raw draft/verify *agreement* — truncation
                # says nothing about draft quality and must not read as
                # rejection
                agreed += j
                accepted += min(j, ticket.remaining)
                burst = [int(drafts[i, slot]) for i in range(j)]
                burst.append(int(greedy[j, slot]))  # correction / bonus token
                for tok in burst[:ticket.remaining]:
                    events.append((ticket.rid, tok))
                    self._emit(ticket, int(slot), tok)
                    emitted += 1
            self._last_step_tokens = emitted / n_active if n_active else 1.0
            self.metrics.on_spec_round(
                n_active, drafted=k * n_active, accepted=accepted, emitted=emitted)
            if tr.enabled:
                from repro_torch.spec.rollout import trace_round

                trace_round(tr, sp, k=k, n_active=n_active, agreed=agreed,
                            emitted=emitted)
                self._read_device(sp, self._round_graph)
                tr.set_gauge("active_slots", n_active)
                self.profiler.record("spec", self._last_step_ms / 1e3,
                                     tokens=emitted)
                self.profiler.observe_cache("spec_round", self._round_graph.captures)
        self._spec_window[0] += k * n_active
        self._spec_window[1] += agreed
        if (self._accept_ctrl is not None
                and self.metrics.spec_rounds % self.spec.every == 0):
            self._spec_adapt_tick()
        return events

    def _spec_adapt_tick(self) -> None:
        """Feed the windowed draft/verify disagreement rate to the
        acceptance controller; an applied decision moves ``draft_shift``
        one rung (repro_torch.spec)."""
        drafted, agreed = self._spec_window
        if not drafted:
            return
        self._spec_window = [0, 0]
        before = self._accept_ctrl.shift
        self._accept_ctrl.observe(
            self.metrics.spec_rounds, 1.0 - agreed / drafted)
        if self._accept_ctrl.shift != before:
            self.metrics.on_draft_shift(
                self.metrics.spec_rounds, self._accept_ctrl.shift)
            if self.tracer.enabled:
                self.tracer.emit(
                    "draft_shift", shift=self._accept_ctrl.shift,
                    cause=self._accept_ctrl.controller.last_cause,
                    reject_rate=1.0 - agreed / drafted)
                self.tracer.inc("draft_shifts")

    @property
    def draft_shift(self) -> int:
        """Current rungs between the verify and draft tables (repro_torch.spec)."""
        if self.spec is None:
            raise AttributeError("engine was built without speculate=")
        if self._accept_ctrl is not None:
            return self._accept_ctrl.shift
        return self._draft_shift

    def _probe_fn(self, cur, ref, down, mask=None) -> tuple[float, float]:
        """Shadow-forward error probe: the decode step replayed at the
        current, max-mode-reference and one-mode-down host tables (same
        kernels, different modes; state read, never written) — three
        replays of the compiled probe, its device view rewritten between
        them; every row runs.  Returns (err_current, err_one_down), the
        normalized logit residuals over the rows of the (B,) bool device
        tensor ``mask`` (None: the active rows), read back with one sync."""
        from repro_torch.adapt import logit_residual

        logits = []
        for modes in (cur, ref, down):
            self._probe_modes.write(modes)
            logits.append(self._probe_graph().clone())  # the next replay reuses it
        l_cur, l_ref, l_down = logits
        if mask is None:
            mask = self._active_dev
        errs = torch.stack([logit_residual(l_cur, l_ref, mask),
                            logit_residual(l_down, l_ref, mask)])
        err_cur, err_down = errs.cpu().tolist()
        return err_cur, err_down

    def _adapt_tick(self) -> None:
        """One probe + controller observation; applies the shift when
        adaptation is enabled (monitor-only engines record but hold)."""
        self._device_inputs()
        self._probe_and_shift(self.mode_table, self.controller, self._active_dev)

    def _adapt_tick_tenants(self) -> None:
        """One probe + controller observation *per tenant with active
        slots*, each against that tenant's own table and masked to that
        tenant's slots (the probe's forward runs every row, as the
        reference's does; the mask reaches only the residual, never the
        decode step's ``active``).  Isolation invariant: tenant A's
        residuals never reach tenant B's controller, so a hot workload
        shifting A's table up leaves B's table exactly where B's own
        traffic put it."""
        self._device_inputs()
        for name, table in self.tenant_tables.items():
            mask = np.zeros_like(self._active)
            for slot, t in self.scheduler.by_slot.items():
                if t.tenant == name and self._active[slot]:
                    mask[slot] = True
            if mask.any():
                self._probe_and_shift(table, self.tenant_ctrl[name],
                                      torch.from_numpy(mask).to(self.device), tenant=name)

    def _probe_and_shift(self, table, ctrl, mask, tenant: str | None = None) -> None:
        """Probe ``table``'s modes over the rows of ``mask``, feed ``ctrl``
        and, when adapting, shift the table as it decides."""
        ladder = int(table.max_mode) - int(table.min_mode)
        err_cur, err_down = self._probe_fn(
            table.scalars(),
            table.scalars_shifted(ladder),  # clamps every site to max: ref
            table.scalars_shifted(-1),
            mask,
        )
        err_cur, err_down = float(err_cur), float(err_down)
        self.metrics.on_probe(err_cur)
        step_ms = self._last_step_ms
        if step_ms is not None:
            step_ms /= max(self._last_step_tokens, 1.0)
        decision = ctrl.observe(
            self.metrics.decode_steps, err_cur, err_down,
            step_ms=step_ms,
            can_up=not table.at_max, can_down=not table.at_min)
        if not (self._adapt and decision
                and table.shift_all(decision, tag=self.metrics.decode_steps)):
            return
        self.metrics.on_mode_switch()
        if self.tracer.enabled:
            who = {} if tenant is None else {"tenant": tenant}
            self.tracer.emit(
                "mode_switch", cause=ctrl.last_cause, direction=decision,
                **who, mode=table.label(),
                sites={s: m.name for s, m in table.modes().items()})
            self.tracer.inc("mode_switches")

    def drain(self) -> dict[int, list[int]]:
        """Step until queue and slots are empty; returns rid -> tokens for
        every request completed since construction."""
        while self.scheduler.has_work():
            self.step()
        return {rid: self.scheduler.tickets[rid].tokens
                for rid in self.scheduler.completed}

    # -- internals -----------------------------------------------------------

    def _prefill_slot(self, slot: int, ticket: Ticket) -> int:
        """One solo prefill: the prompt's forward, its row scattered into
        ``slot``, the first token.  Traced, it runs inside a recording of
        its device spans (the model's blocks, ``scatter``, ``sample``),
        read once its span has closed."""
        tr = self.tracer
        with tr.span("prefill", rid=ticket.rid, slot=slot,
                     prompt_len=len(ticket.prompt)) as sp:
            with Recording(self.device) if tr.enabled else NULL_SPAN as rec:
                with tr.span("prefill.forward"):
                    prompt = torch.as_tensor(
                        np.asarray(ticket.prompt, np.int64)[None, :], device=self.device)
                    logits, solo = self.model_prefill.decode_step(
                        self.params, prompt, self._solo0)
                with tr.span("prefill.scatter"), device_span("scatter"):
                    self._set_state(self.layout.scatter_row(
                        self.state, solo, slot, prompt=ticket.prompt))
                self._row_len[slot] = len(ticket.prompt)
                with tr.span("prefill.sample"):
                    with device_span("sample"):
                        first = torch.argmax(logits[0, -1])
                    first = int(first)  # syncs the prefill
        if tr.enabled:
            sites_ms, sites_n = rec.read()
            sp.data.update(sites_ms=sites_ms, sites_n=sites_n)
            self._count_device("prefill", sites_ms)
            self.profiler.record("prefill", sp.data["dur_ms"] / 1e3,
                                 tokens=len(ticket.prompt))
            self.profiler.observe_cache("prefill", self.kernel_build_count)
        return first

    def _emit(self, ticket: Ticket, slot: int, tok: int) -> None:
        ticket.tokens.append(tok)
        self.metrics.on_token(ticket.rid)
        if self.tracer.enabled:
            self.tracer.emit("token", rid=ticket.rid, slot=slot)
            self.tracer.inc("tokens_out")
        if len(ticket.tokens) >= ticket.budget:
            self.scheduler.complete(ticket.rid)
            self.metrics.on_done(ticket.rid, step=self.scheduler.clock)
            if self.tracer.enabled:
                self.tracer.emit("done", rid=ticket.rid, slot=slot,
                                 cause="budget")
                self.tracer.inc("completed")
            self._active[slot] = False
            self._set_state(self.layout.free_row(self.state, slot))
        else:
            self.scheduler.start_decode(ticket.rid)
            self._active[slot] = True
            self._last_tok[slot] = tok

    # -- reporting / compat --------------------------------------------------

    def describe(self) -> dict[str, str]:
        """The consolidated reporting surface: one dict with every
        subsystem's description (plans / adaptation / speculation / tenancy
        / cache — plus tracing/profiling when tracing is on)."""
        out = {
            "plans": self._describe_plans(),
            "adaptation": self._describe_adaptation(),
            "speculation": self._describe_speculation(),
            "tenancy": self._describe_tenancy(),
            "cache": self.layout.describe(),
        }
        if self.tracer.enabled:
            out["trace"] = self.tracer.describe()
            out["profile"] = self.profiler.describe()
        return out

    def format_describe(self) -> str:
        """One coherent engine report block (headers + sections)."""
        return "\n".join(f"-- {key} --\n{body}"
                         for key, body in self.describe().items())

    def describe_plans(self) -> str:
        return self.describe()["plans"]

    def describe_speculation(self) -> str:
        return self.describe()["speculation"]

    def describe_tenancy(self) -> str:
        return self.describe()["tenancy"]

    def describe_adaptation(self) -> str:
        return self.describe()["adaptation"]

    def describe_cache(self) -> str:
        return self.describe()["cache"]

    def _describe_plans(self) -> str:
        if not self.plans:
            return "unplanned (explicit policy)"
        return "\n".join(f"{op}: {p.describe()}" for op, p in self.plans.items())

    @property
    def kernel_build_count(self) -> int:
        """Builds of the CUDA kernel library in this process.  Stays at most
        1 across arbitrary mode-table changes: a mode is data, never a new
        kernel (the port's form of the reference's compile count)."""
        from repro_torch.kernels import build

        return build.BUILD_COUNT

    @property
    def graph_capture_count(self) -> int:
        """CUDA graphs this engine has captured (repro_torch.serve.graphs):
        one per compiled step it has run on the card, 0 on the CPU and
        under ``graphs.eager()``.  Mode-table shifts and draft-shift changes
        rewrite the steps' device views and capture nothing."""
        steps = (self._step_graph, self._round_graph, self._probe_graph)
        return sum(g.captures for g in steps if g is not None)

    @property
    def decode_compile_count(self) -> int:
        """The reference's name for ``kernel_build_count``: there is no
        trace cache behind the port's decode step."""
        return self.kernel_build_count

    @property
    def spec_compile_count(self) -> int | None:
        """The reference's count of compiled speculative-round variants, in
        the port the kernel-library build count (None without
        ``speculate=``): a draft-shift or mode-table change builds nothing."""
        if self.spec is None:
            return None
        return self.kernel_build_count

    def _describe_speculation(self) -> str:
        if self.spec is None:
            return "speculation off (no speculate=)"
        s = self.metrics.summary()
        acc = s["acceptance_rate"]
        vspt = s["verify_steps_per_token"]
        ctrl = ""
        if self._accept_ctrl is not None:
            ctrl = (f" | {self._accept_ctrl.shallower_moves} shallower / "
                    f"{self._accept_ctrl.deeper_moves} deeper moves")
        return (
            f"k={self.spec.k} draft_shift={self.draft_shift} "
            f"(verify {self._spec_table.describe()}) | "
            f"{s['spec_rounds']} rounds | acceptance "
            + (f"{acc:.2f}" if acc is not None else "-")
            + " | verify-steps/token "
            + (f"{vspt:.2f}" if vspt is not None else "-")
            + ctrl
        )

    def _describe_tenancy(self) -> str:
        """Scheduler configuration + per-tenant fairness report."""
        sch = self.scheduler
        head = (
            f"policy={sch.policy} aging_steps={sch.aging_steps} "
            f"preempt={'on' if sch.preempt_enabled else 'off'} "
            f"(min_quantum={sch.min_quantum}) | "
            f"{len(sch.tenants)} tenants x {len(sch.classes)} classes | "
            f"{sch.preemptions} preemptions, max wait {sch.max_wait_steps} "
            f"steps"
        )
        body = self.metrics.format_tenants()
        return head + ("\n" + body if body else "")

    def _describe_adaptation(self) -> str:
        if self.tenant_tables:
            lines = []
            for name in sorted(self.tenant_tables):
                table = self.tenant_tables[name]
                ctrl = self.tenant_ctrl[name]
                lines.append(
                    f"tenant {name}: table {table.describe()} | "
                    f"{table.switches} switches ({ctrl.up_shifts} up / "
                    f"{ctrl.down_shifts} down)")
            return "per-tenant adaptation\n" + "\n".join(lines)
        if self.mode_table is None:
            return "adaptation off (no slo)"
        s = self.metrics.summary()
        occ = " ".join(f"{m}:{f:.2f}" for m, f in s["mode_occupancy"].items())
        timeline = " -> ".join(
            f"@{step}:{label}" for step, label in self.metrics.mode_timeline)
        return (
            f"slo max_err={self.slo.max_err:g}"
            + (f" target_ms={self.slo.target_ms:g}" if self.slo.target_ms else "")
            + f" | table {self.mode_table.describe()} | "
            f"{s['mode_switches']} switches ({self.controller.up_shifts} up / "
            f"{self.controller.down_shifts} down) | occupancy {occ} | "
            f"timeline {timeline}"
        )

    def generate_batch(self, requests: list[Request]) -> dict[int, list[int]]:
        """Offline batch API on top of the streaming engine: submit
        everything, drain, return each request's tokens."""
        rids = [self.submit(r) for r in requests]
        done = self.drain()
        return {rid: done[rid] for rid in rids}
