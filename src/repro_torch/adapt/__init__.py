"""repro_torch.adapt — closed-loop run-time precision adaptation.

The paper's headline property — "adjust the power and delay requirements
according to different accuracy requirements by reconfiguring itself during
run time" — as a feedback loop over the RMPM engine:

    runtime_policy.py  mutable site->mode table + the binding layers read
                       (the mode-select bits as host ints, or as device
                       scalars for captured steps: nothing is built when
                       they change, and the kernels read them as data)
    probe.py           online error probes (shadow-forward logit residual,
                       sampled-row matmul residual, grad-norm drift)
    controller.py      SLO + dual-threshold hysteresis controller, and the
                       training loop's precision schedule
    pages.py           precision tiers of paged KV memory: the keep-bits
                       ladder policy and its controller
    workload.py        the synthetic ill-conditioned serving workload that
                       exercises the loop end to end (imported as
                       ``repro_torch.adapt.workload``: it builds a model)

``ServeEngine(config=ServeConfig(adapt=AdaptConfig(slo=...)))`` closes the
loop; ``CacheConfig(tier_policy=PageTierPolicy(...))`` tiers cold KV pages;
``train_loop(adapt=TrainPrecisionSchedule(...))`` shifts a training run's
modes on grad-norm drift.
"""
from repro_torch.adapt.controller import (  # noqa: F401
    SLO,
    HysteresisController,
    TrainPrecisionSchedule,
)
from repro_torch.adapt.pages import HOT, PageTierController, PageTierPolicy  # noqa: F401
from repro_torch.adapt.probe import (  # noqa: F401
    GradDriftProbe,
    logit_residual,
    sampled_matmul_residual,
    softmax_tv,
)
from repro_torch.adapt.runtime_policy import (  # noqa: F401
    DEFAULT_SITES,
    DeviceModes,
    ModeTable,
    bind_modes,
    runtime_mode_for,
)
