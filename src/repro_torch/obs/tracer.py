"""Low-overhead structured tracing for the serving stack.

One :class:`Tracer` per engine records typed :class:`Event` records into a
bounded ring buffer (``collections.deque(maxlen=capacity)``) on a monotonic
clock, plus a flat counter/gauge registry.  Everything is host-side Python:
no event ever becomes a device value, so a traced engine launches *exactly*
what an untraced one does (identical tokens with tracing on vs off).

When tracing is off the engine holds :data:`NULL_TRACER`, whose hooks are
no-ops and whose ``enabled`` flag lets hot paths skip even the argument
construction (``if tracer.enabled: tracer.emit(...)``).

Event taxonomy (DESIGN.md section Observability):

  lifecycle   submit, admit, resume, preempt, token, done — the per-request
              span skeleton; step stamps follow the scheduler clock and the
              stream replays through the scheduler-model invariant
              harness (consumer mode);
  engine      decode_step, spec_round, prefill, recompile — per-dispatch
              wall time and token accounting (repro_torch.obs.profile);
  decisions   adapt_decision, mode_switch, draft_shift, tier_tick,
              preempt_plan, admit_defer, admit_refuse, page_evict, cow_fork,
              prefix_share — every reconfiguration with its *cause*.

The exporters of the reference (Chrome trace, Prometheus text, the
precision timeline) are not ported yet: their methods raise
NotImplementedError naming the ROADMAP item.
"""
from __future__ import annotations

import collections
import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Tracing knobs carried on ``ServeConfig.trace``.

    ``capacity``: ring-buffer size in events — old events drop first (the
    replay harness requires a lossless ring, so size it to the run).
    ``out``: Chrome-trace path ``launch/serve --trace-out`` writes at exit.
    """

    capacity: int = 1 << 16
    out: str | None = None

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


@dataclasses.dataclass
class Event:
    """One typed trace record.  ``ts`` is the tracer's monotonic clock
    (seconds, ``time.perf_counter``); ``step`` is the scheduler clock the
    event belongs to; ``cause`` names *why* for decision events."""

    ts: float
    step: int
    kind: str
    rid: int | None = None
    slot: int | None = None
    cause: str | None = None
    data: dict | None = None


class Tracer:
    """Ring-buffered event recorder + counter/gauge registry."""

    enabled = True

    def __init__(self, config: TraceConfig | None = None,
                 clock=time.perf_counter):
        self.config = config or TraceConfig()
        self.clock = clock
        self.events: collections.deque[Event] = collections.deque(
            maxlen=self.config.capacity)
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        #: current scheduler step — the engine advances this once per
        #: ``step()`` so emit sites need not thread the clock through
        self.step = 0
        self.emitted = 0

    @property
    def dropped(self) -> int:
        """Events the ring has discarded (0 = lossless, replayable)."""
        return self.emitted - len(self.events)

    def emit(self, kind: str, *, rid: int | None = None,
             slot: int | None = None, cause: str | None = None,
             step: int | None = None, **data) -> None:
        self.emitted += 1
        self.events.append(Event(
            ts=self.clock(), step=self.step if step is None else int(step),
            kind=kind, rid=rid, slot=slot, cause=cause, data=data or None))

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    # -- exporters: not ported yet (ROADMAP Queue A item 10) -------------------

    def _exporters_not_ported(self):
        raise NotImplementedError(
            "trace exporters (Chrome trace, Prometheus, precision timeline) "
            "are not ported yet: ROADMAP Queue A item 10 (Observability)")

    def chrome(self) -> dict:
        self._exporters_not_ported()

    def export_chrome(self, path: str) -> dict:
        self._exporters_not_ported()

    def prometheus(self) -> str:
        self._exporters_not_ported()

    def precision_timeline(self) -> list[dict]:
        self._exporters_not_ported()

    def format_timeline(self) -> str:
        self._exporters_not_ported()

    def describe(self) -> str:
        kinds: dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        body = " ".join(f"{k}:{n}" for k, n in sorted(kinds.items()))
        return (f"{self.emitted} events ({self.dropped} dropped, "
                f"capacity {self.config.capacity}) | {body or '-'}")


class NullTracer:
    """The tracing-off sentinel: every hook is a no-op and ``enabled`` is
    False, so guarded emit sites cost one attribute read.  Exporters refuse
    loudly rather than returning an empty trace that looks like a run."""

    enabled = False
    events: tuple = ()
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    step = 0
    emitted = 0
    dropped = 0

    def emit(self, kind: str, **kw) -> None:
        pass

    def inc(self, name: str, value: float = 1.0) -> None:
        pass

    def set_gauge(self, name: str, value: float) -> None:
        pass

    def _off(self):
        raise RuntimeError(
            "tracing is off: construct the engine with "
            "ServeConfig(trace=TraceConfig(...)) to record events")

    def chrome(self) -> dict:
        self._off()

    def export_chrome(self, path: str) -> dict:
        self._off()

    def prometheus(self) -> str:
        self._off()

    def precision_timeline(self) -> list[dict]:
        self._off()

    def format_timeline(self) -> str:
        self._off()

    def describe(self) -> str:
        return "tracing off"


#: shared no-op tracer: the default for every instrumented component
NULL_TRACER = NullTracer()
