"""repro_torch.spec — self-speculative decoding via run-time precision drafting.

The paper's multiplier reconfigures its precision at run time with no
re-synthesis; repro_torch.adapt made that literal (the mode reaches the
mode-map kernel as data).  This package exploits the consequence no
fixed-precision engine gets for free: **the cheap mode of the same step is
a draft model** — speculative decoding with no second set of weights, no
second kernel build, and no extra parameter memory.

    config.py   SpecConfig + the acceptance-driven draft-shift controller
                (repro_torch.adapt's hysteresis controller fed the measured
                rejection rate instead of a numeric error probe)
    rollout.py  the draft/verify/rollback round: k cheap-mode substeps
                propose, k+1 exact baseline substeps verify, and a single
                rollback-select restores every slot to its accepted prefix
                (KV positions/lengths arithmetically, ring rows by a pos-mask
                select, the decode position by a per-slot gather)

``ServeEngine(config=ServeConfig(spec=SpecConfig(...)))`` closes the loop.
Outputs are identical to the non-speculative greedy engine by construction:
the verify chain replays the exact baseline step, so the accepted prefix
plus the correction token *is* the baseline's token sequence.
"""
from repro_torch.spec.config import AcceptanceController, SpecConfig  # noqa: F401
from repro_torch.spec.rollout import build_spec_round  # noqa: F401
