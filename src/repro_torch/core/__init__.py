"""Core: the paper's contribution as composable PyTorch modules.

C1 rmpm      — run-time-reconfigurable multi-precision matmul engine
C2 precision — mode ladder + auto-mode operand probe
C3 rounding  — G&(R|T|E) / RNE / truncate mantissa quantization
C4 strassen  — top-down Strassen block matmul
"""
from repro_torch.core.precision import (  # noqa: F401
    DF32_MODES,
    F32_MODES,
    MODE_BITS,
    MODE_LIMBS,
    MODE_PASSES,
    DoubleF32,
    Mode,
    PrecisionSpec,
    auto_mode,
    classify,
    df32_from_f32,
    df32_from_f64,
    mode_mismatch_error,
)
from repro_torch.core.policy import (  # noqa: F401
    FAST_M8,
    MIXED,
    NATIVE_F32,
    PAPER_BASELINE,
    PRESETS,
    PrecisionPolicy,
)
from repro_torch.core.rmpm import (  # noqa: F401
    mp_einsum,
    mp_einsum_runtime,
    mp_linear,
    mp_matmul,
    mp_matmul_runtime,
    mp_matmul_runtime_df32,
)
from repro_torch.core.rounding import quantize_mantissa  # noqa: F401
from repro_torch.core.strassen import strassen_matmul  # noqa: F401
