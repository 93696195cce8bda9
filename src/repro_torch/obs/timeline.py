"""Precision timeline: one aligned per-step view of every precision axis.

The serving stack reconfigures precision on three independent clocks —
the adapt controller shifts the mode table (``mode_switch``), the
speculation controller moves the draft shift (``draft_shift``), and the
page-tier controller moves the cold-page mantissa depth (``tier_tick``).
Each already keeps its own timeline; this module merges the trace events
into one step-indexed table with carry-forward semantics, so "what
precision was everything at when step 37 went slow?" is one row.
"""
from __future__ import annotations

from repro_torch.obs.tracer import Event


def precision_timeline(events: list[Event]) -> list[dict]:
    """Rows ``{step, mode, sites, draft_shift, tier_keep, tier_depth}``,
    one per step at which any axis changed (values carry forward between
    rows).  ``mode``/``sites`` come from mode_switch events (decode_step
    events seed the initial mode label), draft_shift and tier_tick fill the
    other axes."""
    state = {"mode": None, "sites": None, "draft_shift": None,
             "tier_keep": None, "tier_depth": None}
    rows: list[dict] = []

    def push(step: int) -> None:
        if rows and rows[-1]["step"] == step:
            rows[-1].update({"step": step, **state})
        else:
            rows.append({"step": step, **state})

    for e in events:
        data = e.data or {}
        if e.kind == "decode_step":
            mode = data.get("mode")
            if mode is not None and state["mode"] is None:
                state["mode"] = mode
                push(e.step)
        elif e.kind == "mode_switch":
            if "mode" in data:
                state["mode"] = data["mode"]
            if "sites" in data:
                state["sites"] = data["sites"]
            push(e.step)
        elif e.kind == "draft_shift":
            state["draft_shift"] = data.get("shift")
            push(e.step)
        elif e.kind == "tier_tick":
            state["tier_keep"] = data.get("keep")
            state["tier_depth"] = data.get("depth")
            push(e.step)
    return rows


def _cell(value) -> str:
    if value is None:
        return "-"
    if isinstance(value, dict):
        return ",".join(f"{k}={v}" for k, v in sorted(value.items()))
    return str(value)


def format_timeline(rows: list[dict]) -> str:
    """Fixed-width table of the merged timeline (for --trace-out runs)."""
    if not rows:
        return "precision timeline: no reconfiguration events recorded"
    cols = ("step", "mode", "sites", "draft_shift", "tier_keep", "tier_depth")
    table = [[_cell(r.get(c)) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in table))
              for i, c in enumerate(cols)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
    lines += ["  ".join(v.ljust(w) for v, w in zip(row, widths))
              for row in table]
    return "\n".join(lines)
