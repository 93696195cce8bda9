"""repro_torch.plan — cost-model-driven matmul planner/executor.

Unifies the paper's three run-time levers (RMPM precision mode, Strassen
depth, execution impl) behind one shape- and accuracy-aware API:

    plan  = plan_matmul(shape_a, shape_b, accuracy=2**-12)   # backend=None: the GPU
    out   = execute(plan, a, b)          # or: matmul(a, b, accuracy=2**-12)

The cost model is in repro_torch.plan.cost.
"""
from repro_torch.plan.cost import (  # noqa: F401
    DEFAULT_BALANCE,
    F32_FLOPS,
    HBM_BW,
    PEAK_FLOPS,
    MODE_REL_ERROR,
    NATIVE_REL_ERROR,
    CostEstimate,
    MachineBalance,
    cheapest_mode,
    estimate,
    fit_balance,
    limb_factors,
    strassen_overhead,
)
from repro_torch.plan.planner import (  # noqa: F401
    Plan,
    clear_plan_cache,
    execute,
    matmul,
    plan_cache_stats,
    plan_matmul,
    plan_model_policy,
)
