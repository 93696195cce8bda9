"""Precision-tiered KV pages: demotion/promotion policy for the paged cache.

The paper's run-time precision reconfiguration applied to decode *memory*
(DESIGN.md section Paged KV cache): cold pages — pages whose newest token
sits far enough behind the row's decode head — are mantissa-truncated in
place by the ``quantize_mantissa`` kernel (``csrc/quantize_mantissa.cu``),
one tier at a time down a keep-bits ladder.  The closed loop reuses the
hysteresis machinery from repro_torch.adapt.controller verbatim:

  * ``err``      — the relative residual actually introduced by this tick's
                   demotions at the current tier depth;
  * ``err_down`` — the *measured would-be* residual of truncating the same
                   cold pages one tier deeper (computed, never applied);
  * decision +1  — promote: the allowed depth retreats one tier and every
                   page below the new floor is re-labelled at the floor.

**Tier invariant (lossy demotion, label promotion):** truncation is
in-place, so the dropped mantissa bits are gone; "promotion" restores the
*floor* — it stops further loss, re-labels over-demoted pages, and every new
append lands at full precision — it does not resurrect lost bits.  At
``budget=None`` the ladder runs open loop at full depth (the benchmark's
memory-vs-accuracy endpoint); with a budget the controller holds the
measured residual inside ``[budget * down_factor, budget]``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.adapt.controller import SLO, HysteresisController

#: tier label for a page that has never been demoted (keep-bits sentinel
#: larger than any real mantissa width — bf16 has 7 explicit bits)
HOT = 99


@dataclasses.dataclass(frozen=True)
class PageTierPolicy:
    """Demotion policy for precision-tiered KV pages.

    ``levels``: the keep-bits ladder, shallowest first (bf16 pools have 7
    explicit mantissa bits, so levels below 7 truncate).  ``cold_after``:
    tokens a page's newest entry must trail the row head before the page is
    demotion-eligible.  ``every``: engine decode steps between tier ticks.
    ``budget``: closed-loop residual ceiling (None = open loop at full
    depth).  ``rounding``: quantize_mantissa rounding mode.
    """

    levels: tuple[int, ...] = (5, 3)
    cold_after: int = 32
    every: int = 8
    budget: float | None = None
    rounding: str = "trunc"
    cooldown: int = 2

    def __post_init__(self):
        if not self.levels:
            raise ValueError("levels must name at least one keep-bits tier")
        if any(b < 1 for b in self.levels):
            raise ValueError(f"keep bits must be >= 1, got {self.levels}")
        if list(self.levels) != sorted(self.levels, reverse=True):
            raise ValueError(
                f"levels must descend (shallowest tier first), got "
                f"{self.levels}")
        if self.cold_after < 1:
            raise ValueError("cold_after must be >= 1")
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.budget is not None and self.budget <= 0:
            raise ValueError(f"budget must be positive, got {self.budget}")


class PageTierController:
    """Maps the page-residual probe onto a HysteresisController.

    ``depth`` is how far down the ladder demotion may reach (0 = tiering
    effectively off).  With a budget the controller starts at depth 0 and
    only deepens when the measured would-be residual one tier down sits in
    the dead band — the same never-enter-a-violating-config rule the mode
    controller enforces (controller invariant ii).  Without a budget the
    ladder runs open loop at full depth.
    """

    def __init__(self, policy: PageTierPolicy):
        self.policy = policy
        if policy.budget is None:
            self.depth = len(policy.levels)
            self.ctrl = None
        else:
            self.depth = 0
            self.ctrl = HysteresisController(
                SLO(max_err=policy.budget), cooldown=policy.cooldown)
        self.promotions = 0  # applied +1 decisions (floor retreats)
        self.demotions = 0  # applied -1 decisions (floor deepens)

    @property
    def target_keep(self) -> int | None:
        """Keep-bits demotion-eligible cold pages truncate to right now
        (None: depth 0, nothing demotes)."""
        if self.depth == 0:
            return None
        return self.policy.levels[self.depth - 1]

    @property
    def next_keep(self) -> int | None:
        """One tier deeper than the current floor (the err_down shadow);
        None when the ladder is exhausted."""
        if self.depth < len(self.policy.levels):
            return self.policy.levels[self.depth]
        return None

    def observe(self, step: int, err: float, err_down: float) -> int:
        """One tier tick's measured residuals -> depth move in {-1, 0, +1}.
        Open-loop controllers never move."""
        if self.ctrl is None:
            return 0
        decision = self.ctrl.observe(
            step, err, err_down,
            can_up=self.depth > 0,
            can_down=self.depth < len(self.policy.levels))
        if decision > 0:
            self.depth -= 1
            self.promotions += 1
        elif decision < 0:
            self.depth += 1
            self.demotions += 1
        return decision

    def describe(self) -> str:
        mode = ("open-loop" if self.ctrl is None
                else f"budget={self.policy.budget:g}")
        tgt = self.target_keep
        return (f"tiers {self.policy.levels} ({mode}) depth={self.depth} "
                f"keep={'hot' if tgt is None else tgt} | "
                f"{self.promotions} promotions / {self.demotions} deepenings")
