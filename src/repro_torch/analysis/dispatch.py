"""Dispatch & fusion auditor: count precision-dispatch structure in a step's
recorded ops.

The reference's ``repro.analysis.dispatch`` walks a traced jaxpr; the port's
steps are eager, so every counter here is read from the op recorder's
events (``launch.op_cost.record_ops``): ``pallas_calls`` are the hand-kernel
events (each wrapper charges one where it launches, and the recorder does
not descend into it, so the predicated passes inside the mode-map kernel are
not switches), ``switches`` the run-time mode choices ``core.rmpm`` marks
(``_mode_select`` on a device scalar, the host-int branch of
``mp_matmul_runtime`` / ``mp_einsum_runtime``: the reference's
``lax.switch``), and gathers, scatters, converts, dots and the largest
gather's bytes are read from the aten ops (gathers, scatters and dots are
the cost reader's op classes, ``launch.op_cost``).  The reference's
``scans`` and ``whiles`` have no counterpart: an eager step runs its loops
in Python and dispatches every iteration, so no op stands for a loop.
``kernels/tile_matmul/tile_policy.py`` re-exports ``dispatch_stats``.

Two rules:

``DISP-COUNT``
    A declarative count expectation failed — e.g. the runtime-bound tile
    pmm must be exactly 1 mode-map kernel launch with 0 switches (the
    paper's one-multiplier/many-modes contract), the static decode step
    must make no run-time mode choice at all.

``DISP-DENSIFY``
    A gather-class op materialized more bytes than the declared per-path
    bound — the "paged gather rows never densify the pool" contract:
    page-table reads may gather each row's own pages (≤ B × cap rows),
    never the whole pool per row.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.report import Violation
from repro_torch.launch import op_cost
from repro_torch.launch.op_cost import DOT_OPS, GATHER_OPS, SCATTER_OPS, op_base

#: dtype conversions
CONVERT_OPS = frozenset({"_to_copy", "to"})


def dispatch_stats(fn, *args, **kwargs) -> dict[str, int]:
    """Run ``fn(*args, **kwargs)`` under the recorder and count
    precision-dispatch structure: ``switches`` (run-time mode choices — the
    old N-branch runtime path) and ``pallas_calls`` (hand-kernel launches).
    The predicated passes inside the mode-map kernel do not count as
    switches.  Used by tests to assert the tile path collapses N branches
    into one launch."""
    full = audit_stats(fn, *args, **kwargs)
    return {"switches": full["switches"], "pallas_calls": full["pallas_calls"]}


def audit_stats(fn, *args, **kwargs) -> dict[str, int]:
    """Full dispatch audit of ``fn(*args, **kwargs)``'s recorded ops.

    Returns every counter the per-path expectations can bind:
    ``switches`` / ``pallas_calls`` (as ``dispatch_stats``), ``gathers`` /
    ``scatters`` (indexed memory traffic), ``converts`` (dtype-changing
    copies), ``dots`` (dot-class ops — the GEMM count of non-kernel
    paths), ``eqns`` (recorded aten ops) and ``max_gather_bytes`` (largest
    gather-class output — the densify measure)."""
    _, rec = op_cost.record_ops(fn, *args, **kwargs)
    return audit_events(rec.events)


def audit_events(events) -> dict[str, int]:
    """``audit_stats`` over already-recorded events."""
    stats = {
        "switches": 0, "pallas_calls": 0, "gathers": 0, "scatters": 0, "converts": 0,
        "dots": 0, "eqns": 0, "max_gather_bytes": 0,
    }
    for ev in events:
        if ev.kind == "kernel":
            stats["pallas_calls"] += 1
            continue
        if ev.kind == "mark":
            stats["switches"] += ev.name == "switch"
            continue
        stats["eqns"] += 1
        name = op_base(ev.name)
        if name in GATHER_OPS:
            stats["gathers"] += 1
            stats["max_gather_bytes"] = max(stats["max_gather_bytes"],
                                            sum(t.nbytes for t in ev.outputs))
        elif name in SCATTER_OPS:
            stats["scatters"] += 1
        elif name in CONVERT_OPS:
            if ev.inputs and ev.outputs and ev.inputs[0].dtype != ev.outputs[0].dtype:
                stats["converts"] += 1
        elif name in DOT_OPS:
            stats["dots"] += 1
    return stats


@dataclasses.dataclass(frozen=True)
class Expect:
    """Declarative dispatch expectation for one audited hot path.

    ``exact`` pins a counter to a value, ``at_most``/``at_least`` bound it;
    ``densify_bytes`` caps ``max_gather_bytes`` (the pool-densify rule) —
    set it to the path's legitimate per-step gather ceiling, e.g.
    B × cap × heads × head_dim × itemsize for a paged decode step.  (The
    reference's ``scans`` / ``whiles`` counters have no eager op.)
    """

    exact: dict[str, int] = dataclasses.field(default_factory=dict)
    at_most: dict[str, int] = dataclasses.field(default_factory=dict)
    at_least: dict[str, int] = dataclasses.field(default_factory=dict)
    densify_bytes: int | None = None

    def check(self, stats: dict[str, int], where: str) -> list[Violation]:
        out: list[Violation] = []
        for key, want in self.exact.items():
            if stats.get(key) != want:
                out.append(Violation(
                    "DISP-COUNT", where,
                    f"expected {key} == {want}, recorded {stats.get(key)}"))
        for key, cap in self.at_most.items():
            if stats.get(key, 0) > cap:
                out.append(Violation(
                    "DISP-COUNT", where,
                    f"expected {key} <= {cap}, recorded {stats.get(key)}"))
        for key, floor in self.at_least.items():
            if stats.get(key, 0) < floor:
                out.append(Violation(
                    "DISP-COUNT", where,
                    f"expected {key} >= {floor}, recorded {stats.get(key)}"))
        if (self.densify_bytes is not None
                and stats.get("max_gather_bytes", 0) > self.densify_bytes):
            out.append(Violation(
                "DISP-DENSIFY", where,
                f"a gather materialized {stats['max_gather_bytes']} bytes "
                f"(> {self.densify_bytes}): rows must gather their own "
                "pages, never densify the pool"))
        return out


def audit(fn, args, expect: Expect, where: str, **kwargs) -> list[Violation]:
    """Record ``fn(*args, **kwargs)`` and check ``expect`` against it."""
    return expect.check(audit_stats(fn, *args, **kwargs), where)
