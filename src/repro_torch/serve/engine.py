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

The host waits for the device only where the reference does: once per
decode step (the produced tokens), once per prefill (the first token), once
per probe (the two residuals).

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
``speculate=``, per-tenant adaptation (``tenants=`` with ``slo=``), paged
cache layouts.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models.lm import LanguageModel, map_state
from repro_torch.obs import NULL_TRACER, TraceConfig, Tracer
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.paged import make_layout
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


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
        if cfg.spec is not None:
            raise _not_ported("speculate= (self-speculative decoding)",
                            "Queue A item 7")
        if slo is not None and sch.tenants is not None:
            raise _not_ported("per-tenant adaptation (tenants= with slo=)",
                            "Queue A item 9, 'Multi-tenant engine paths'")
        self.device = model.device
        # metrics first: its plan-cache snapshot must predate phase planning
        # so plan_cache_delta() counts the plans this engine triggers
        self.metrics = ServeMetrics(batch_slots)
        if cfg.trace:
            self.tracer = Tracer(cfg.trace if isinstance(cfg.trace, TraceConfig)
                                 else None)
        else:
            self.tracer = NULL_TRACER
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
            if cfg.tune_table not in (None, False):
                from repro_torch.plan.planner import _resolve_tune_table

                _resolve_tune_table(cfg.tune_table, "gpu")  # raises: not ported
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
        if slo is not None:
            from repro_torch.adapt import HysteresisController, ModeTable

            if self.phase_plans:
                self.mode_table = ModeTable.from_plans(self.phase_plans["decode"])
            else:
                self.mode_table = ModeTable.from_policy(model.cfg.policy)
            self.controller = cfg.adapt.controller or HysteresisController(slo)
            self.controller.tracer = self.tracer
            self.controller.name = "adapt"
            self.adapt_every = max(int(cfg.adapt.adapt_every), 1)
        else:
            self.mode_table = None
            self.controller = None
        self.spec = None

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
        merged = self._merge(new_state, state, active)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), merged

    def _masked_step_modal(self, params, tokens, state, active, modes):
        """The masked step with the mode table bound: ``modes`` is a dict of
        host ints, so every table mutation between steps changes only the
        data the mode-map kernel reads — the paper's run-time
        reconfiguration, with nothing built."""
        from repro_torch.adapt import bind_modes

        with bind_modes(modes):
            logits, new_state = self.model_decode.decode_step(
                params, tokens, state)
        merged = self._merge(new_state, state, active)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), merged

    def _probe_fn(self, params, tokens, state, active, cur, ref, down):
        """Shadow-forward error probe: the decode step replayed at the
        current, max-mode-reference and one-mode-down tables (same kernels,
        different modes; state discarded).  Returns (err_current,
        err_one_down) as the normalized logit residual over active slots."""
        from repro_torch.adapt import bind_modes, logit_residual

        def fwd(modes):
            with bind_modes(modes):
                logits, _ = self.model_decode.decode_step(params, tokens, state)
            return logits[:, -1]

        l_cur, l_ref, l_down = fwd(cur), fwd(ref), fwd(down)
        return (logit_residual(l_cur, l_ref, active),
                logit_residual(l_down, l_ref, active))

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
        events: list[tuple[int, int]] = []
        self.scheduler.tick()
        self.tracer.step = self.scheduler.clock
        for victim in self.scheduler.plan_preemptions():
            self._park_slot(victim, cause="priority")
        self.layout.begin_admission()
        for slot, ticket in self.scheduler.admit(can_admit=self._can_admit):
            if slot < 0:
                # zero-budget admission (nothing fits the cache): the
                # scheduler completed it without a slot
                self.metrics.on_done(ticket.rid, step=self.scheduler.clock)
                if self.tracer.enabled:
                    self.tracer.emit("done", rid=ticket.rid, slot=-1,
                                     cause="zero_budget")
                continue
            if ticket.tokens:
                self._resume_slot(slot, ticket)
                continue
            if self.tracer.enabled:
                self.tracer.emit("admit", rid=ticket.rid, slot=slot,
                                 tenant=ticket.tenant, rclass=ticket.rclass)
            first = self._prefill_slot(slot, ticket)
            self.metrics.on_first_token(ticket.rid)
            events.append((ticket.rid, first))
            self._emit(ticket, slot, first)
        if self._active.any():
            events.extend(self._decode_step())
            if (self.slo is not None
                    and self.metrics.decode_steps % self.adapt_every == 0
                    and self._active.any()):
                self._adapt_tick()
        return events

    def _can_admit(self, ticket: Ticket) -> bool:
        """Admission gate handed to the scheduler: the layout says whether
        it can map this ticket's cache content (dense: always — the free
        slot IS the capacity)."""
        if ticket.rid in self._parked:
            return self.layout.can_admit(self._parked[ticket.rid][1])
        return self.layout.can_admit(len(ticket.prompt),
                                     prompt=ticket.prompt)

    def _park_slot(self, victim: Ticket, cause: str = "priority") -> None:
        """Preempt a running request: gather its exact per-slot state row
        (as a dense batch-1 row), free the slot and requeue the ticket.
        Nothing is recomputed at resume — ``_resume_slot`` scatters this
        row back, so the token stream continues identically."""
        slot = victim.slot
        self._parked[victim.rid] = (
            self.layout.gather_row(self.state, slot),
            int(self._row_len[slot]))
        self.state = self.layout.free_row(self.state, slot)
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
        self.state = self.layout.scatter_row(
            self.state, row, slot, length=length)
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

    def _device_inputs(self):
        tokens = torch.as_tensor(self._last_tok[:, None].copy(), device=self.device)
        active = torch.as_tensor(self._active.copy(), device=self.device)
        return tokens, active

    def _decode_step(self) -> list[tuple[int, int]]:
        """One masked batched decode step."""
        events: list[tuple[int, int]] = []
        tokens, active = self._device_inputs()
        tenant_active = self._tenant_active()
        t0 = time.perf_counter()
        if self.slo is not None:
            scalars, label = self.mode_table.scalars(), self.mode_table.label()
            next_tok, self.state = self._masked_step_modal(
                self.params, tokens, self.state, active, scalars)
        else:
            label = self._static_decode_label
            next_tok, self.state = self._masked_step(
                self.params, tokens, self.state, active)
        produced = next_tok.cpu().numpy()  # syncs the step
        self._last_step_ms = (time.perf_counter() - t0) * 1e3
        n_active = int(self._active.sum())
        self.metrics.on_decode_step(
            n_active, mode=label, tenant_active=tenant_active)
        if self.tracer.enabled:
            self.tracer.emit("decode_step", dur_ms=self._last_step_ms,
                             n_active=n_active, mode=label)
            self.tracer.set_gauge("active_slots", n_active)
        for slot in np.nonzero(self._active)[0]:
            ticket = self.scheduler.by_slot[int(slot)]
            tok = int(produced[slot])
            self._row_len[slot] += 1  # this step appended one KV entry
            events.append((ticket.rid, tok))
            self._emit(ticket, int(slot), tok)
        return events

    def _adapt_tick(self) -> None:
        """One probe + controller observation; applies the shift when
        adaptation is enabled (monitor-only engines record but hold)."""
        table = self.mode_table
        ladder = int(table.max_mode) - int(table.min_mode)
        tokens, active = self._device_inputs()
        err_cur, err_down = self._probe_fn(
            self.params, tokens, self.state, active,
            table.scalars(),
            table.scalars_shifted(ladder),  # clamps every site to max: ref
            table.scalars_shifted(-1),
        )
        err_cur, err_down = float(err_cur), float(err_down)  # syncs the probe
        self.metrics.on_probe(err_cur)
        step_ms = self._last_step_ms
        if step_ms is not None:
            step_ms /= max(self._last_step_tokens, 1.0)
        decision = self.controller.observe(
            self.metrics.decode_steps, err_cur, err_down,
            step_ms=step_ms,
            can_up=not table.at_max, can_down=not table.at_min)
        if self._adapt and decision:
            if table.shift_all(decision, tag=self.metrics.decode_steps):
                self.metrics.on_mode_switch()
                if self.tracer.enabled:
                    self.tracer.emit(
                        "mode_switch", cause=self.controller.last_cause,
                        direction=decision, mode=table.label(),
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
        t0 = time.perf_counter()
        prompt = torch.as_tensor(np.asarray(ticket.prompt, np.int64)[None, :],
                                 device=self.device)
        logits, solo = self.model_prefill.decode_step(
            self.params, prompt, self._solo0)
        self.state = self.layout.scatter_row(
            self.state, solo, slot, prompt=ticket.prompt)
        self._row_len[slot] = len(ticket.prompt)
        first = int(torch.argmax(logits[0, -1]))  # syncs the prefill
        if self.tracer.enabled:
            dur_s = time.perf_counter() - t0
            self.tracer.emit("prefill", rid=ticket.rid, slot=slot,
                             dur_ms=dur_s * 1e3,
                             prompt_len=len(ticket.prompt))
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
            self.state = self.layout.free_row(self.state, slot)
        else:
            self.scheduler.start_decode(ticket.rid)
            self._active[slot] = True
            self._last_tok[slot] = tok

    # -- reporting / compat --------------------------------------------------

    def describe(self) -> dict[str, str]:
        """The consolidated reporting surface: one dict with every
        subsystem's description (plans / adaptation / tenancy / cache —
        plus tracing when it is on)."""
        out = {
            "plans": self._describe_plans(),
            "adaptation": self._describe_adaptation(),
            "speculation": "speculation off (not ported yet)",
            "tenancy": self._describe_tenancy(),
            "cache": self.layout.describe(),
        }
        if self.tracer.enabled:
            out["trace"] = self.tracer.describe()
        return out

    def format_describe(self) -> str:
        """One coherent engine report block (headers + sections)."""
        return "\n".join(f"-- {key} --\n{body}"
                         for key, body in self.describe().items())

    def describe_plans(self) -> str:
        return self.describe()["plans"]

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
    def decode_compile_count(self) -> int:
        """The reference's name for ``kernel_build_count``: there is no
        trace cache behind the port's decode step."""
        return self.kernel_build_count

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
