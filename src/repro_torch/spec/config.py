"""Speculation config + the acceptance-driven draft-shift controller.

The draft model is the verify model's mode table shifted ``draft_shift``
rungs down the runtime-switchable f32 ladder (M24 -> M16 -> M8).  The shift
is itself a run-time knob: the measured draft rejection rate feeds the same
dual-threshold hysteresis controller repro_torch.adapt uses for numeric
error, so

  * too many rejections  -> shallower draft (shift toward the verify modes:
    each rejected round wastes draft work, so buy acceptance with precision);
  * high acceptance      -> cheaper draft (spend the headroom on fewer limb
    passes per drafted token).

Precedence vs the SLO controller: the SLO controller owns the *verify*
table — output quality — and never consults acceptance; this controller
owns only the *relative* draft shift, so when the SLO controller moves the
verify table the draft follows at the same distance.  Output tokens come exclusively from the
verify chain, so neither controller can change what is emitted — only what
it costs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """``ServeEngine(speculate=SpecConfig(...))`` knobs.

    ``k``: draft depth — cheap-mode tokens proposed per round (the verify
    chain then replays ``k + 1`` positions).  ``draft_shift``: initial rungs
    below the verify table for the draft table (clamped to the ladder).
    ``adapt``: let the acceptance controller retune ``draft_shift`` at run
    time.  ``max_reject``: rejection-rate ceiling — above it the draft
    shallows; at or below ``max_reject * down_factor`` it deepens (the dead
    band between is where the controller holds).  ``every``: controller
    cadence in rounds; ``cooldown``: minimum observations between shifts.
    """

    k: int = 3
    draft_shift: int = 2
    adapt: bool = True
    max_reject: float = 0.4
    down_factor: float = 0.25
    every: int = 4
    cooldown: int = 1

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"draft depth k must be >= 1, got {self.k}")
        if self.draft_shift < 1:
            raise ValueError(
                f"draft_shift must be >= 1 (0 would draft with the verify "
                f"modes themselves), got {self.draft_shift}")
        if not (0.0 < self.max_reject < 1.0):
            raise ValueError(
                f"max_reject must be in (0, 1), got {self.max_reject}")


class AcceptanceController:
    """Rejection rate -> draft-shift moves, with hysteresis.

    Reuses :class:`repro_torch.adapt.HysteresisController` verbatim: the
    "observed error" is the windowed draft rejection rate, an *up* decision
    (error above the SLO) shrinks the shift by one rung, a *down* decision
    grows it.  ``ladder`` is the number of rungs available below the verify
    table (the f32 ladder span), so the shift lives in ``[1, ladder]``.
    """

    def __init__(self, cfg: SpecConfig, ladder: int, shift: int | None = None):
        from repro_torch.adapt import SLO, HysteresisController

        self.cfg = cfg
        self.ladder = max(int(ladder), 1)
        self.shift = max(1, min(cfg.draft_shift if shift is None else shift,
                                self.ladder))
        self.controller = HysteresisController(
            SLO(max_err=cfg.max_reject, down_factor=cfg.down_factor),
            cooldown=cfg.cooldown,
        )

    @property
    def shallower_moves(self) -> int:
        return self.controller.up_shifts

    @property
    def deeper_moves(self) -> int:
        return self.controller.down_shifts

    def observe(self, round_idx, reject_rate: float) -> int:
        """One windowed rejection-rate observation -> applied shift delta
        in {-1, 0, +1} rungs of draft *precision* (+1 = shallower draft)."""
        decision = self.controller.observe(
            round_idx, err=float(reject_rate),
            can_up=self.shift > 1, can_down=self.shift < self.ladder,
        )
        if decision > 0:
            self.shift -= 1  # shallower: draft one rung closer to verify
        elif decision < 0:
            self.shift += 1  # deeper: cheaper draft modes
        return decision
