"""Mutable runtime mode table + the binding that layers read.

This is the half of `repro_torch.adapt` that touches the decode step.  The
paper's mode-select bits are *runtime inputs* of the multiplier — no
re-synthesis when they change.  Here: the table is host state, its modes
are host ints; `models/layers.pmm` routes a bound site through the
mode-map kernel, which reads the mode from a device int32 map inside ONE
kernel, and `pein` branches on the host int.  Changing a mode between steps
changes data, never what is built, and costs no host sync.

Two pieces:

  * :class:`ModeTable` — host-side mutable ``site -> Mode`` map over the
    runtime-switchable f32 ladder {M8, M16, M24}.  The planner's static pick
    (``ModeTable.from_plans``) is merely the table's initial condition; the
    controller (`repro_torch.adapt.controller`) shifts it afterwards.
  * :func:`bind_modes` — a context manager installing the table's modes
    for the duration of one step.  ``pmm``/``pein`` consult
    :func:`runtime_mode_for`; unbound sites keep their static plan, so a
    model run outside any binding is bit-identical to the static dispatch.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterable, Mapping

from repro_torch.core.precision import F32_MODES, Mode

#: call-sites every transformer-family model routes through pmm/pein
#: (models/layers.py); moe adds router/moe_expert via plan_model_policy.
DEFAULT_SITES = (
    "qkv", "out", "mlp_up", "mlp_down", "logits", "attn_qk", "attn_av",
)

# Stack of bound {site: mode} dicts.  The engine steps from one thread and
# the binding wraps the step, so a plain module-level stack is sufficient
# (and survives nested bindings: innermost wins).
_BOUND: list[dict[str, Any]] = []


@contextlib.contextmanager
def bind_modes(modes: Mapping[str, Any]):
    """Install runtime modes for the enclosed step.

    ``modes`` maps call-site names to modes (host ints from a ModeTable, or
    device int32 scalars).  A ``"*"`` key acts as the default for sites not
    named explicitly.
    """
    _BOUND.append(dict(modes))
    try:
        yield
    finally:
        _BOUND.pop()


def runtime_mode_for(op: str):
    """The bound mode for ``op``, or None when ``op`` is not adapted
    (static-plan dispatch).  Called by pmm/pein."""
    if not _BOUND:
        return None
    top = _BOUND[-1]
    return top.get(op, top.get("*"))


class ModeTable:
    """Mutable per-call-site RMPM mode table over the f32 ladder.

    The table is host state: reading it (``scalars()``) yields the host ints
    bound for one step, mutating it (``shift_all``/``set``) changes what the
    *next* step runs.  Modes are clamped to ``[min_mode, max_mode]`` — the
    runtime-switchable f32 ladder.
    """

    def __init__(self, sites: Mapping[str, Mode | int],
                 min_mode: Mode = Mode.M8, max_mode: Mode = Mode.M24):
        if not sites:
            raise ValueError("ModeTable needs at least one call-site")
        self.min_mode = Mode(min_mode)
        self.max_mode = Mode(max_mode)
        for m in (self.min_mode, self.max_mode):
            if m not in F32_MODES:
                raise ValueError(
                    f"{m.name} is not runtime-switchable (f32 ladder only)")
        self._baseline = {k: self._clamp(Mode(v)) for k, v in sites.items()}
        self._modes = dict(self._baseline)
        self.switches = 0
        #: list of (decode_step_or_tag, {site: Mode}) snapshots, one per change
        self.history: list[tuple[Any, dict[str, Mode]]] = []
        # scalar cache: rebuilt only on mutation
        self._scalar_cache: dict[int, dict[str, Any]] = {}

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_plans(cls, plans: Mapping[str, Any], **kw) -> "ModeTable":
        """Initial condition from the planner's per-op plans (repro_torch.plan):
        only runtime-switchable plans join the table — DF32 / pinned-exotic
        sites keep their static execution path."""
        sites = {
            op: p.mode for op, p in plans.items()
            if p.mode in F32_MODES and getattr(p, "dtype", "float32") == "float32"
        }
        if not sites:
            raise ValueError("no runtime-switchable sites among the plans")
        return cls(sites, **kw)

    @classmethod
    def from_policy(cls, policy: Any,
                    sites: Iterable[str] = DEFAULT_SITES, **kw) -> "ModeTable":
        picked = {
            op: policy.mode_for(op) for op in sites
            if policy.mode_for(op) in F32_MODES
        }
        if not picked:
            raise ValueError("policy has no runtime-switchable sites")
        return cls(picked, **kw)

    # -- reads ---------------------------------------------------------------

    def modes(self) -> dict[str, Mode]:
        return dict(self._modes)

    def scalars(self) -> dict[str, Any]:
        """The table as host ints — what ``bind_modes`` installs for a step.
        Cached until the table mutates (the common case is thousands of
        steps per shift)."""
        return self.scalars_shifted(0)

    def scalars_shifted(self, delta: int) -> dict[str, Any]:
        """Shadow scalars at every site shifted by ``delta`` (clamped) — the
        probe's one-mode-down / reference views.  Cached like ``scalars``."""
        cached = self._scalar_cache.get(delta)
        if cached is None:
            cached = {
                k: int(self._clamp(int(v) + delta))
                for k, v in self._modes.items()
            }
            self._scalar_cache[delta] = cached
        return cached

    def label(self) -> str:
        names = sorted({m.name for m in self._modes.values()})
        return names[0] if len(names) == 1 else "/".join(names)

    @property
    def at_max(self) -> bool:
        return all(m == self.max_mode for m in self._modes.values())

    @property
    def at_min(self) -> bool:
        return all(m == self.min_mode for m in self._modes.values())

    # -- mutations -----------------------------------------------------------

    def _clamp(self, mode: Mode | int) -> Mode:
        return Mode(min(max(int(mode), int(self.min_mode)), int(self.max_mode)))

    def set(self, site: str, mode: Mode | int, tag: Any = None) -> bool:
        new = self._clamp(mode)
        if self._modes[site] == new:
            return False
        self._modes[site] = new
        self._scalar_cache.clear()
        self.switches += 1
        self.history.append((tag, self.modes()))
        return True

    def shift(self, site: str, delta: int, tag: Any = None) -> bool:
        return self.set(site, int(self._modes[site]) + delta, tag)

    def shift_all(self, delta: int, tag: Any = None) -> bool:
        """Shift every site by ``delta`` rungs (clamped per site), keeping the
        planner's relative stagger — e.g. an attn_qk planned one rung above
        mlp_up stays one rung above until both hit a clamp.  Counts as one
        switch event when anything moved."""
        if delta == 0:
            return False
        changed = False
        for site, m in self._modes.items():
            new = self._clamp(int(m) + delta)
            if new != m:
                self._modes[site] = new
                changed = True
        if changed:
            self._scalar_cache.clear()
            self.switches += 1
            self.history.append((tag, self.modes()))
        return changed

    def reset(self) -> None:
        self._modes = dict(self._baseline)
        self._scalar_cache.clear()

    def describe(self) -> str:
        return ", ".join(f"{k}={v.name}" for k, v in sorted(self._modes.items()))
