"""repro_torch.tune — measured-cost autotuner feeding the matmul planner.

Microbenchmarks the planner's candidate space — (RMPM mode, Strassen depth,
impl, kernel block sizes) — on the device it runs on, and persists the
measurements to a versioned JSON tuning table the planner resolves against
(exact hit -> scaled neighbor -> re-fit roofline):

    table = tune((256, 1024), iters=3)     # or: python -m repro_torch.tune
    table.save("build/tuning/gpu.json")
    plan_matmul((256, 256), (256, 256), accuracy=2**-4, tune_table=table)

Tables also load process-wide from the ``TUNE_TABLE`` env var (a table file
or a directory of ``<backend>.json`` files) or via
``repro_torch.plan.set_tune_table``.  The reference package's tables (for
example its ``tuning/cpu.json``) load unchanged.
"""

from repro_torch.tune.runner import (  # noqa: F401
    DEFAULT_BLOCKS,
    DEFAULT_MODES,
    Candidate,
    candidates,
    depth_candidates,
    measure,
    tune,
)
from repro_torch.tune.table import (  # noqa: F401
    NATIVE_MODE_KEY,
    NEIGHBOR_MAX_FLOP_RATIO,
    SCHEMA_VERSION,
    TuneRecord,
    TuneTable,
    mode_key,
)
