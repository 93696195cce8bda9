"""The program's own spans in a traced run.

With tracing on, the port's engine records each step as a tree of host
spans (``repro_torch.obs`` ``Tracer.span``: one event at each span's end,
with ``t0``, ``dur_ms``, ``span`` and ``parent`` in its data) and puts the
device time of the step's blocks on its ``decode_step`` events
(``device_ms``: the whole replay; ``sites_ms``: each device span, summed
over the layers) and ``prefill`` events (``sites_ms``).  The readings here
take those events as the engine left them (``engine.tracer.events``) and the
window's bounds; where the events hold no such span or field, as a program
without these spans gives, each reading is None.
"""
from __future__ import annotations

import statistics

from harness.trace import DeviceTrace, Span, covering

#: the blocks whose device time lies inside a decode step's replay, disjoint
BLOCKS = ("attention", "ffn", "state")


def spans(events, kind: str, t_open: float, t_close: float) -> list[dict]:
    """The data of every ``kind`` span that lies inside ``[t_open, t_close]``
    (warm-up steps start before the window opens)."""
    return [e.data for e in events
            if e.kind == kind and e.data and "t0" in e.data
            and t_open <= e.data["t0"] and e.ts <= t_close]


def _median(values: list[float]) -> float | None:
    return statistics.median(values) if values else None


def replay_device_ms(events, t_open: float, t_close: float) -> float | None:
    """Median over the window's decode steps of the replay's device time."""
    return _median([d["device_ms"] for d in spans(events, "decode_step", t_open, t_close)
                    if "device_ms" in d])


def site_ms(events, kind: str, site: str, t_open: float, t_close: float) -> float | None:
    """Median over the window's ``kind`` spans (``decode_step``, ``prefill``)
    of the device ms of ``site`` (a device span's path: ``attention``,
    ``ffn``, ``state``, ``scatter``, ``attention/attn_qk``), summed over
    its pairs in the step."""
    return _median([d["sites_ms"][site] for d in spans(events, kind, t_open, t_close)
                    if site in d.get("sites_ms", {})])


def host_ms(events, t_open: float, t_close: float) -> dict[str, float]:
    """Median host ms of each kind of span over the window's spans of that
    kind (``decode.emit``, ``decode.replay``, ``prefill.forward``, ...)."""
    out = {}
    for kind in sorted({e.kind for e in events if e.data and "t0" in e.data}):
        got = _median([d["dur_ms"] for d in spans(events, kind, t_open, t_close)])
        if got is not None:
            out[kind] = got
    return out


def all_sites_ms(events, kind: str, t_open: float, t_close: float) -> dict[str, float]:
    """``site_ms`` of every device span path the window's ``kind`` spans
    name."""
    paths = {p for d in spans(events, kind, t_open, t_close) for p in d.get("sites_ms", {})}
    return {p: site_ms(events, kind, p, t_open, t_close) for p in sorted(paths)}


def blocks_over_replay(events) -> list[int]:
    """The ids of decode steps whose blocks (``BLOCKS``) together read more
    device time than the whole replay: each must be none."""
    return [d["span"] for e in events if e.kind == "decode_step" and e.data
            and "device_ms" in (d := e.data)
            and sum(d["sites_ms"].get(b, 0.0) for b in BLOCKS) > d["device_ms"]]


def ops_by_span(trace: DeviceTrace, events, kinds=("prefill", "decode_step"),
                top: int = 10) -> dict[str, dict[str, float]]:
    """Seconds of each of the ``top`` device operations (by total time) that
    started inside each ``kinds`` span (by the engine's own span, not the
    profiler's ranges)."""
    total: dict[str, float] = {}
    for op in trace.ops:
        total[op.name] = total.get(op.name, 0.0) + (op.t1 - op.t0)
    names = sorted(total, key=lambda n: -total[n])[:top]
    within = {kind: covering([Span(kind, e.data["t0"], e.ts) for e in events
                              if e.kind == kind and e.data and "t0" in e.data])
              for kind in kinds}
    out = {n: {"all": total[n]} | dict.fromkeys(kinds, 0.0) for n in names}
    for op in trace.ops:
        if op.name in out:
            for kind, find in within.items():
                if find(op.t0) is not None:
                    out[op.name][kind] += op.t1 - op.t0
    return {n[:96]: v for n, v in out.items()}


def idle_by_span(trace: DeviceTrace, events) -> dict[str, float]:
    """Seconds of the device's idle gaps by the innermost engine span that
    holds each gap's middle, named by its path from the outermost
    (``step/decode_step/decode.sync``); a gap outside every span goes to
    ``"outside the engine's spans"``."""
    tree = sorted(((e.data["t0"], e.ts, e.kind) for e in events
                   if e.data and "t0" in e.data), key=lambda s: (s[0], -s[1]))
    gaps = sorted(((lo + hi) / 2, hi - lo) for lo, hi in trace.idle_gaps())
    out: dict[str, float] = {}
    stack: list[tuple[float, float, str]] = []
    i = 0
    for mid, length in gaps:
        # the spans are nested or disjoint, so the open ones form a chain
        while i < len(tree) and tree[i][0] <= mid:
            while stack and stack[-1][1] <= tree[i][0]:
                stack.pop()
            stack.append(tree[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = "/".join(s[2] for s in stack) if stack else "outside the engine's spans"
        out[name] = out.get(name, 0.0) + length
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
