"""repro_torch.adapt — closed-loop run-time precision adaptation.

The paper's headline property — "adjust the power and delay requirements
according to different accuracy requirements by reconfiguring itself during
run time" — as a feedback loop over the RMPM engine:

    runtime_policy.py  mutable site->mode table + the binding layers read
                       (the mode-select bits as host ints: nothing is built
                       when they change, and the tile kernel reads them as
                       data)
    probe.py           online error probes (shadow-forward logit residual,
                       sampled-row matmul residual)
    controller.py      SLO + dual-threshold hysteresis controller

``ServeEngine(config=ServeConfig(adapt=AdaptConfig(slo=...)))`` closes the
loop.  The page-tier policy, the synthetic workload and the training
schedule of the reference are not ported yet.
"""
from repro_torch.adapt.controller import SLO, HysteresisController  # noqa: F401
from repro_torch.adapt.probe import (  # noqa: F401
    logit_residual,
    sampled_matmul_residual,
    softmax_tv,
)
from repro_torch.adapt.runtime_policy import (  # noqa: F401
    DEFAULT_SITES,
    ModeTable,
    bind_modes,
    runtime_mode_for,
)
