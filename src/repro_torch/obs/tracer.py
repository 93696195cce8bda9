"""Low-overhead structured tracing for the serving stack.

One :class:`Tracer` per engine records typed :class:`Event` records into a
bounded ring buffer (``collections.deque(maxlen=capacity)``) on a monotonic
clock, plus a flat counter/gauge registry.  Everything is host-side Python:
no event ever becomes a device value, so a traced engine launches the
kernels an untraced one does (identical tokens with tracing on vs off),
plus the timing events of its device spans (repro_torch.obs.device).

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
  spans       step, schedule, prefill.*, pages, decode.*, adapt,
              page_tick, capture — host sub-spans of every engine step
              (``Tracer.span``), each one event at its end with its start,
              its length and its parent span; ``prefill`` and
              ``decode_step`` are spans too, and carry the device time of
              the step's blocks (repro_torch.obs.device);
  decisions   adapt_decision, mode_switch, draft_shift, tier_tick,
              preempt_plan, admit_defer, admit_refuse, page_evict, cow_fork,
              prefix_share — every reconfiguration with its *cause*.

Exporters (Chrome trace, Prometheus text, the precision timeline) read the
ring after the run; see repro_torch.obs.export / repro_torch.obs.timeline.
"""
from __future__ import annotations

import collections
import dataclasses
import time

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

from repro_torch.obs.device import NULL_SPAN


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
        #: ids of the spans open now, innermost last (``span``)
        self._open: list[int] = []
        self._spans = 0

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

    def span(self, kind: str, *, rid: int | None = None,
             slot: int | None = None, cause: str | None = None,
             **data) -> "Span":
        """A host span: ``with tracer.span("prefill", rid=...) as sp:``.
        One ``kind`` event at its end (``ts``) whose data carry ``dur_ms``,
        the start ``t0`` on the same clock, the span's id ``span`` and the
        enclosing span's id ``parent`` (None at the top).  While
        ``torch.profiler`` records, the span is also a ``record_function``
        range of the same name."""
        return Span(self, kind, rid, slot, cause, data)

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    # -- exporters (repro_torch.obs.export / repro_torch.obs.timeline) -------

    def chrome(self) -> dict:
        """The trace as a Chrome-trace/Perfetto ``traceEvents`` document."""
        from repro_torch.obs.export import to_chrome

        return to_chrome(list(self.events), self.counters, self.gauges)

    def export_chrome(self, path: str) -> dict:
        """Write the Chrome-trace JSON to ``path``; returns the document."""
        from repro_torch.obs.export import write_chrome

        return write_chrome(path, list(self.events), self.counters,
                            self.gauges)

    def prometheus(self) -> str:
        """Prometheus text exposition of the counter/gauge registry."""
        from repro_torch.obs.export import to_prometheus

        return to_prometheus(self.counters, self.gauges)

    def precision_timeline(self) -> list[dict]:
        """Aligned per-step precision view (repro_torch.obs.timeline)."""
        from repro_torch.obs.timeline import precision_timeline

        return precision_timeline(list(self.events))

    def format_timeline(self) -> str:
        from repro_torch.obs.timeline import format_timeline

        return format_timeline(self.precision_timeline())

    def describe(self) -> str:
        kinds: dict[str, int] = {}
        for e in self.events:
            kinds[e.kind] = kinds.get(e.kind, 0) + 1
        body = " ".join(f"{k}:{n}" for k, n in sorted(kinds.items()))
        return (f"{self.emitted} events ({self.dropped} dropped, "
                f"capacity {self.config.capacity}) | {body or '-'}")


class Span:
    """One host span of a :class:`Tracer` (``Tracer.span``).  ``data`` is
    the event's payload: entries added before the span ends, or after it
    (a device read that has to wait for the span's own sync), land in its
    event; ``event`` is that event once the span has ended."""

    __slots__ = ("tracer", "kind", "rid", "slot", "cause", "data", "event", "_range")

    def __init__(self, tracer: Tracer, kind: str, rid, slot, cause, data: dict):
        self.tracer, self.kind, self.data = tracer, kind, data
        self.rid, self.slot, self.cause = rid, slot, cause
        self.event: Event | None = None
        self._range = None

    def __enter__(self) -> "Span":
        tr = self.tracer
        tr._spans += 1
        self.data["span"] = tr._spans
        self.data["parent"] = tr._open[-1] if tr._open else None
        tr._open.append(tr._spans)
        if _profiler_enabled():
            self._range = record_function(self.kind)
            self._range.__enter__()
        self.data["t0"] = tr.clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self.tracer
        ts = tr.clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        tr._open.pop()
        self.data["dur_ms"] = (ts - self.data["t0"]) * 1e3
        self.event = Event(ts=ts, step=tr.step, kind=self.kind, rid=self.rid,
                           slot=self.slot, cause=self.cause, data=self.data)
        tr.emitted += 1
        tr.events.append(self.event)


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

    def span(self, kind: str, **kw):
        return NULL_SPAN

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
