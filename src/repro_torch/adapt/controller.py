"""Hysteresis mode controller: observed error + latency headroom -> shifts.

Decision rule (DESIGN.md section Runtime adaptation, invariants i-iv):

  i.   **Up** when the observed error at the current modes exceeds
       ``slo.max_err``.  Accuracy always beats latency: an up-shift is never
       suppressed by a latency target.
  ii.  **Down** only when the *measured would-be* error one mode down
       (``err_down``, from the probe's one-down shadow) sits inside the dead
       band — below ``slo.max_err * down_factor``.  Because the decision is
       based on the measured error of the configuration being entered (not
       the one being left), a down-shift can never immediately violate the
       SLO it just checked: no up/down thrash at a boundary.
  iii. ``down_factor < 1`` strictly — the dead band
       ``[max_err * down_factor, max_err]`` is where the controller holds.
       A latency violation (``step_ms > slo.target_ms``) relaxes the down
       threshold from ``max_err * down_factor`` to ``max_err`` itself: under
       latency pressure the controller trades the accuracy *margin*, never
       the SLO.
  iv.  **Cooldown**: at least ``cooldown`` probe observations between
       shifts, bounding the reconfiguration rate.

The controller is engine-agnostic: ``observe`` takes scalars, returns a
shift in {-1, 0, +1}; the caller applies it to its
:class:`~repro_torch.adapt.runtime_policy.ModeTable`.  The training-loop
precision schedule of the reference waits for the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.obs import NULL_TRACER


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-call-site service-level objective the controller enforces.

    ``max_err``: ceiling on the probe's observed relative error (for serving,
    the normalized logit residual vs the max-mode reference; for training,
    the grad-norm drift).  ``target_ms``: optional per-step latency target —
    overshooting it applies downward pressure within the accuracy SLO.
    """

    max_err: float
    target_ms: float | None = None
    down_factor: float = 0.25

    def __post_init__(self):
        if self.max_err <= 0:
            raise ValueError(f"max_err must be positive, got {self.max_err}")
        if not (0.0 < self.down_factor < 1.0):
            raise ValueError(
                f"down_factor must be in (0, 1) for hysteresis, got "
                f"{self.down_factor}"
            )


@dataclasses.dataclass
class Observation:
    step: Any
    err: float
    err_down: float
    step_ms: float | None
    decision: int


class HysteresisController:
    #: trace sink + instance label (repro_torch.obs) — the engine swaps in its
    #: live tracer and names each controller ("adapt", "adapt/<tenant>",
    #: "accept"); the class defaults keep standalone controllers emit-free
    tracer = NULL_TRACER
    name = "adapt"

    def __init__(self, slo: SLO, cooldown: int = 2):
        self.slo = slo
        self.cooldown = max(int(cooldown), 0)
        self.history: list[Observation] = []
        self._since_shift = self.cooldown  # first observation may act
        #: why the last observation decided what it did — the cause stamp
        #: the engine copies onto mode_switch / draft_shift trace events
        self.last_cause: str | None = None

    @property
    def up_shifts(self) -> int:
        return sum(1 for o in self.history if o.decision > 0)

    @property
    def down_shifts(self) -> int:
        return sum(1 for o in self.history if o.decision < 0)

    def observe(self, step: Any, err: float, err_down: float | None = None,
                step_ms: float | None = None, *, can_up: bool = True,
                can_down: bool = True) -> int:
        """One probe observation -> shift in {-1, 0, +1}.

        ``err``: observed error at the current modes (vs the max-mode
        reference).  ``err_down``: measured would-be error one mode down
        (None -> ``err``, the conservative degenerate form used when no
        down-shadow ran).  ``step_ms``: decode-step wall time for the
        latency term.  ``can_up``/``can_down``: ladder headroom — a clamped
        table cannot shift, so the decision is suppressed rather than
        recorded as a phantom switch.
        """
        if err_down is None:
            err_down = err
        decision = 0
        cause = "hold"
        if self._since_shift < self.cooldown:
            cause = "cooldown"
        else:
            down_limit = self.slo.max_err * self.slo.down_factor
            relaxed = (self.slo.target_ms is not None and step_ms is not None
                       and step_ms > self.slo.target_ms)
            if relaxed:
                # latency pressure: spend accuracy margin, never the SLO (iii)
                down_limit = self.slo.max_err
            if err > self.slo.max_err and can_up:
                decision = +1
                cause = "err_violation"
            elif err_down <= down_limit and can_down:
                decision = -1
                # distinguish "the dead band cleared on its own" from "the
                # latency term spent the margin" — the Why of the trace
                cause = ("latency_pressure"
                         if relaxed and err_down > self.slo.max_err
                         * self.slo.down_factor else "clean_streak")
        self.last_cause = cause
        if self.tracer.enabled:
            self.tracer.emit(
                "adapt_decision", cause=cause, controller=self.name,
                decision=decision, err=float(err), err_down=float(err_down),
                step_ms=step_ms, can_up=can_up, can_down=can_down)
        self.history.append(Observation(step, float(err), float(err_down),
                                        step_ms, decision))
        if decision:
            self._since_shift = 0
        else:
            self._since_shift += 1
        return decision
