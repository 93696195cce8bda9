"""Trace exporters: Chrome-trace/Perfetto JSON and Prometheus text.

The Chrome document uses only self-balancing phases — ``"X"`` (complete
spans with explicit ``dur``), ``"i"`` (instants), ``"C"`` (counters) and
``"M"`` (metadata) — so a truncated ring can never produce unbalanced
begin/end pairs.  Layout: pid 1 is the engine (its host spans — every event
with a ``dur_ms``, nested step > prefill / decode_step > their parts, each
with the device time of its blocks in its args — and decision instants on
tid 0), pid 2 holds one thread per request (tid = rid) whose
spans are the request lifecycle reconstructed from submit/admit/preempt/
resume/done events.  Timestamps are microseconds relative to the
earliest event or span start.

``validate_chrome`` is the schema + well-formedness gate CI runs on
exported traces; ``span_violations`` checks the *semantic* lifecycle
ordering on the raw event stream (the replay harness in
tests/scheduler_model.py checks the scheduler invariants proper).
"""
from __future__ import annotations

import json

from repro_torch.obs.tracer import Event

# request-lifecycle phases, in legal transition order
_QUEUED, _RUNNING, _PREEMPTED = "queued", "running", "preempted"

#: engine events rendered as instants on the engine track; values are the
#: Chrome ``s`` scope ("t" thread-scoped, "p" process-scoped)
_INSTANT_KINDS = {
    "mode_switch": "p",
    "draft_shift": "p",
    "tier_tick": "t",
    "adapt_decision": "t",
    "preempt_plan": "t",
    "admit_defer": "t",
    "admit_refuse": "t",
    "page_evict": "t",
    "cow_fork": "t",
    "prefix_share": "t",
    "recompile": "p",
    "spec_round": "t",
}

#: engine events rendered as complete spans even without a ``dur_ms``
#: payload (length 0); every event that carries ``dur_ms`` is one too — the
#: host spans of ``Tracer.span`` (with their own start ``t0``) and the
#: speculative round
_SPAN_KINDS = ("decode_step", "prefill")


def _args(e: Event) -> dict:
    args = {"step": e.step}
    if e.cause is not None:
        args["cause"] = e.cause
    if e.slot is not None:
        args["slot"] = e.slot
    if e.data:
        args.update(e.data)
    return args


def to_chrome(events: list[Event], counters: dict | None = None,
              gauges: dict | None = None) -> dict:
    """Build a Chrome-trace document from a recorded event list."""
    out: list[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
         "args": {"name": "requests"}},
    ]
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    t0 = min([e.ts for e in events]
             + [e.data["t0"] for e in events if e.data and "t0" in e.data])

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    # -- engine track: dispatch spans, instants, counters --------------------
    for e in events:
        data = e.data or {}
        if e.kind in _SPAN_KINDS or data.get("dur_ms") is not None:
            if "t0" in data:  # a span that knows its start
                start = us(data["t0"])
                dur_us = us(e.ts) - start
            else:
                dur_us = float(data.get("dur_ms") or 0.0) * 1e3
                start = max(0.0, us(e.ts) - dur_us)
            out.append({
                "ph": "X", "pid": 1, "tid": 0, "name": e.kind, "cat": "engine",
                "ts": start, "dur": dur_us, "args": _args(e)})
            if e.kind == "decode_step" and "n_active" in (e.data or {}):
                out.append({
                    "ph": "C", "pid": 1, "tid": 0, "name": "active_slots",
                    "ts": us(e.ts),
                    "args": {"active": e.data["n_active"]}})
        elif e.kind in _INSTANT_KINDS:
            out.append({
                "ph": "i", "pid": 1, "tid": 0, "name": e.kind, "cat": "engine",
                "ts": us(e.ts), "s": _INSTANT_KINDS[e.kind],
                "args": _args(e)})

    # -- request tracks: lifecycle spans ------------------------------------
    # open[rid] = (phase_name, start_ts); transitions close the open span
    open_: dict[int, tuple[str, float]] = {}
    named: set[int] = set()
    end_ts = max(e.ts for e in events)

    def close(rid: int, ts: float) -> None:
        phase, start = open_.pop(rid)
        out.append({
            "ph": "X", "pid": 2, "tid": rid, "name": phase, "cat": "request",
            "ts": us(start), "dur": max(0.0, us(ts) - us(start)),
            "args": {"rid": rid}})

    for e in events:
        if e.rid is None or e.kind not in (
                "submit", "admit", "resume", "preempt", "done"):
            continue
        rid = e.rid
        if rid not in named:
            named.add(rid)
            out.append({"ph": "M", "pid": 2, "tid": rid, "name": "thread_name",
                        "args": {"name": f"request {rid}"}})
        if rid in open_:
            close(rid, e.ts)
        if e.kind == "submit":
            open_[rid] = (_QUEUED, e.ts)
        elif e.kind in ("admit", "resume"):
            open_[rid] = (_RUNNING, e.ts)
        elif e.kind == "preempt":
            open_[rid] = (_PREEMPTED, e.ts)
        # "done" closes without reopening
    for rid in sorted(open_):  # requests still in flight at ring end
        close(rid, end_ts)

    # -- final registry values as a trailing counter sample ------------------
    for name, value in sorted((counters or {}).items()):
        out.append({"ph": "C", "pid": 1, "tid": 0, "name": name,
                    "ts": us(end_ts), "args": {"value": value}})
    for name, value in sorted((gauges or {}).items()):
        out.append({"ph": "C", "pid": 1, "tid": 0, "name": name,
                    "ts": us(end_ts), "args": {"value": value}})

    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome(path: str, events: list[Event], counters: dict | None = None,
                 gauges: dict | None = None) -> dict:
    doc = to_chrome(events, counters, gauges)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


_REQUIRED = {"ph", "pid", "tid", "name"}
_KNOWN_PH = {"X", "i", "C", "M"}
#: nesting tolerance in µs — adjacent spans produced from one float clock
#: can land ~1e-9 µs apart after the relative-µs conversion
_EPS_US = 1e-3


def validate_chrome(doc: dict) -> list[str]:
    """Schema + span-tree well-formedness.  Returns violation strings
    (empty = valid): every event carries the required keys, only
    self-balancing phases appear, X durations are non-negative, and on each
    (pid, tid) track the X spans form a proper tree (nested or disjoint,
    never partially overlapping)."""
    problems: list[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    tracks: dict[tuple, list[tuple[float, float, str]]] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        missing = _REQUIRED - e.keys()
        if missing:
            problems.append(f"event {i}: missing keys {sorted(missing)}")
            continue
        ph = e["ph"]
        if ph not in _KNOWN_PH:
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        if ph != "M" and "ts" not in e:
            problems.append(f"event {i}: {ph}-event without ts")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: X-event bad dur {dur!r}")
                continue
            tracks.setdefault((e["pid"], e["tid"]), []).append(
                (float(e["ts"]), float(dur), e["name"]))
        elif ph == "i" and e.get("s") not in ("t", "p", "g"):
            problems.append(f"event {i}: instant with bad scope {e.get('s')!r}")
    for key, spans in tracks.items():
        spans.sort()
        stack: list[tuple[float, float, str]] = []
        for ts, dur, name in spans:
            while stack and ts >= stack[-1][0] + stack[-1][1] - _EPS_US:
                stack.pop()
            if stack:
                p_ts, p_dur, p_name = stack[-1]
                if ts + dur > p_ts + p_dur + _EPS_US:
                    problems.append(
                        f"track {key}: span {name!r} [{ts}, {ts + dur}] "
                        f"partially overlaps {p_name!r} "
                        f"[{p_ts}, {p_ts + p_dur}]")
            stack.append((ts, dur, name))
    return problems


#: legal predecessor states per lifecycle event; None = not yet seen
_LIFECYCLE = {
    "submit": (None,),
    "admit": (_QUEUED,),
    "resume": (_PREEMPTED,),
    "preempt": (_RUNNING,),
    "done": (_QUEUED, _RUNNING),  # zero-budget requests finish from queued
}
_NEXT_STATE = {"submit": _QUEUED, "admit": _RUNNING, "resume": _RUNNING,
               "preempt": _PREEMPTED, "done": "done"}


def span_violations(events: list[Event]) -> list[str]:
    """Per-request lifecycle-order check on the raw stream: submit before
    admit, resume only after preempt, exactly one done, nothing after it."""
    problems: list[str] = []
    state: dict[int, str | None] = {}
    for e in events:
        if e.kind not in _LIFECYCLE or e.rid is None:
            continue
        prev = state.get(e.rid)
        if prev == "done":
            problems.append(f"rid {e.rid}: {e.kind} after done (step {e.step})")
        elif prev not in _LIFECYCLE[e.kind]:
            problems.append(
                f"rid {e.rid}: {e.kind} from state {prev!r} (step {e.step})")
        state[e.rid] = _NEXT_STATE[e.kind]
    return problems


def to_prometheus(counters: dict, gauges: dict) -> str:
    """Prometheus text exposition of the registry, names prefixed
    ``repro_obs_`` and sanitized to the metric charset."""
    def clean(name: str) -> str:
        return "repro_obs_" + "".join(
            c if c.isalnum() or c == "_" else "_" for c in name)

    lines: list[str] = []
    for name, value in sorted(counters.items()):
        m = clean(name)
        lines += [f"# TYPE {m} counter", f"{m} {value:g}"]
    for name, value in sorted(gauges.items()):
        m = clean(name)
        lines += [f"# TYPE {m} gauge", f"{m} {value:g}"]
    return "\n".join(lines) + ("\n" if lines else "")
