"""Reading the traced run: ``torch.profiler``'s device timeline and the
engine's own spans (``repro_torch.obs`` events ``prefill`` and
``decode_step``, each stamped when it ended, with its ``dur_ms``).

Everything is put on the host's ``time.perf_counter`` clock: the offset to
the profiler's clock is taken from the ``bench.step`` ranges, whose host
start the driver also recorded.
"""
from __future__ import annotations

import bisect
import dataclasses
import statistics


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    rid: int | None = None


@dataclasses.dataclass
class DeviceTrace:
    """Device operations (kernels, copies, fills) and the benchmark's host
    ranges of one profiled span ``[t0, t1]``, on the host clock."""

    ops: list[Span]
    host: list[Span]
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> list[tuple[float, float]]:
        """The union of device operation intervals inside the span."""
        out: list[list[float]] = []
        for s in sorted(self.ops, key=lambda s: s.t0):
            lo, hi = max(s.t0, self.t0), min(s.t1, self.t1)
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return [(lo, hi) for lo, hi in out]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy())

    def idle_gaps(self) -> list[tuple[float, float]]:
        edges, prev = [], self.t0
        for lo, hi in self.busy():
            if lo > prev:
                edges.append((prev, lo))
            prev = hi
        if self.t1 > prev:
            edges.append((prev, self.t1))
        return edges

    def device_time(self, match, spans: list[Span]) -> float:
        """Seconds of the operations named as ``match`` accepts that started
        inside one of ``spans`` (which do not overlap)."""
        find = covering(spans)
        return sum(s.t1 - s.t0 for s in self.ops if match(s.name) and find(s.t0) is not None)


def covering(spans: list[Span]):
    """A lookup: the span of ``spans`` (which do not overlap) holding a
    time, or None."""
    spans = sorted(spans, key=lambda s: s.t0)
    starts = [s.t0 for s in spans]

    def find(t: float) -> Span | None:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i] if i >= 0 and t <= spans[i].t1 else None

    return find


def from_profiler(prof, step_starts: list[float], t0: float, t1: float) -> DeviceTrace:
    """The profiler's events as a ``DeviceTrace``; ``step_starts`` are the
    host starts of the profiled ``bench.step`` ranges, in order."""
    events = prof.profiler.kineto_results.events()
    ann = sorted((e for e in events if e.name() == "bench.step"
                  and not str(e.device_type()).endswith("CUDA")), key=lambda e: e.start_ns())
    pairs = list(zip(ann, step_starts))
    if not pairs:
        raise RuntimeError("the profiled span holds no engine step")
    offset = statistics.median(e.start_ns() * 1e-9 - t for e, t in pairs)

    def span(e) -> Span:
        a = e.start_ns() * 1e-9 - offset
        return Span(e.name(), a, a + e.duration_ns() * 1e-9)

    ops, host = [], []
    for e in events:
        ours = e.name().startswith("bench.")
        if not str(e.device_type()).endswith("CUDA"):
            if ours:
                host.append(span(e))
        elif not ours and not e.is_user_annotation():
            # (the device copies of the benchmark's own ranges are
            # annotations, not work)
            ops.append(span(e))
    return DeviceTrace(ops, host, t0, t1)


def engine_spans(tracer, kind: str) -> list[Span]:
    """The engine's ``kind`` events (``prefill``, ``decode_step``) as host
    spans: each event is stamped at its end and carries its ``dur_ms``."""
    return [Span(kind, e.ts - e.data["dur_ms"] * 1e-3, e.ts, e.rid)
            for e in tracer.events if e.kind == kind]


def host_phase(trace: DeviceTrace, engine: list[Span]):
    """A lookup: what the host was doing at a time: an engine span
    (``prefill``, ``decode_step``) inside a ``bench.step``, or the
    benchmark's own range."""
    in_engine, in_bench = covering(engine), covering(trace.host)

    def find(t: float) -> str:
        s = in_engine(t)
        if s is not None:
            return f"bench.step/{s.name}"
        s = in_bench(t)
        return "between ranges" if s is None else s.name

    return find


def breakdown(trace: DeviceTrace, engine: list[Span], top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, in seconds."""
    ops: dict[str, float] = {}
    for s in trace.ops:
        ops[s.name[:96]] = ops.get(s.name[:96], 0.0) + (s.t1 - s.t0)
    idle: dict[str, float] = {}
    phase = host_phase(trace, engine)
    for lo, hi in trace.idle_gaps():
        name = phase((lo + hi) / 2)
        idle[name] = idle.get(name, 0.0) + (hi - lo)
    order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order], "idle_gaps": [[k, v] for k, v in gaps]}


def is_limb_kernel(name: str) -> bool:
    """A launch of the limb kernel: its bodies (``limb_matmul_kernel``,
    ``_skinny_``, ``_mma_``) and the split-K reduction it launches after
    them; not the double-f32 kernel."""
    return ("limb_matmul" in name or "splitk_reduce" in name) and "_dd" not in name
