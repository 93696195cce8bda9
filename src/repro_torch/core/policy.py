"""Per-layer/per-op precision policies.

The paper's mode-select bits are set "by the application program" (section 3.3.1).
In this framework the application program is the model config: a
``PrecisionPolicy`` maps op classes (qkv / attn_qk / attn_av / out / mlp_up /
mlp_down / moe_expert / logits / embed / ssm_in / ...) to RMPM modes, either
statically (one plan per mode) or as a runtime
scalar (one kernel build, the mode rides in as data — used by serving).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.precision import Mode


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    default: Mode = Mode.M24
    overrides: tuple[tuple[str, Mode], ...] = ()
    rounding: str = "rne"
    impl: str = "xla"  # 'xla' | 'pallas' | 'tile' | 'native' | 'auto' (planner picks)
    # Largest Strassen depth the planner (repro.plan) may choose for this
    # policy's matmuls.  0 keeps every contraction classical — bit-identical
    # to the pre-planner dispatch; serving/benchmark paths opt in.
    max_strassen_depth: int = 0

    def mode_for(self, op: str) -> Mode:
        for name, mode in self.overrides:
            if name == op:
                return mode
        return self.default

    def with_impl(self, impl: str) -> "PrecisionPolicy":
        return dataclasses.replace(self, impl=impl)

    def with_strassen(self, max_depth: int) -> "PrecisionPolicy":
        return dataclasses.replace(self, max_strassen_depth=max_depth)

    def describe(self) -> str:
        ov = ", ".join(f"{n}={m.name}" for n, m in self.overrides)
        out = f"default={self.default.name}" + (f" [{ov}]" if ov else "")
        if self.impl != "xla":
            out += f" impl={self.impl}"
        if self.max_strassen_depth:
            out += f" strassen<={self.max_strassen_depth}"
        return out


# The paper-faithful baseline: every multiply at single-precision fidelity
# (mode 4 / 23-bit mantissa ~ M24 = 3 limbs, 6 tensor-core passes).  This is
# what a "conventional" non-reconfigurable FP unit would do.
PAPER_BASELINE = PrecisionPolicy(default=Mode.M24)

# Reduced-precision run-time mode: everything in one tensor-core pass (bf16), the
# paper's mode 2.  Accuracy-critical ops stay higher per the mixed policy.
FAST_M8 = PrecisionPolicy(default=Mode.M8)

# Beyond-paper mixed policy (the optimized configuration in section Perf):
# bulk GEMMs at one pass, numerically sensitive contractions at 2-3 limbs.
MIXED = PrecisionPolicy(
    default=Mode.M8,
    overrides=(
        ("attn_qk", Mode.M16),
        ("logits", Mode.M16),
        ("router", Mode.M24),
    ),
)

# One plain f32 torch.matmul per site (numerically ~= M24).
NATIVE_F32 = PrecisionPolicy(default=Mode.M24, impl="native")

PRESETS: dict[str, PrecisionPolicy] = {
    "paper_baseline": PAPER_BASELINE,
    "fast_m8": FAST_M8,
    "mixed": MIXED,
    "native_f32": NATIVE_F32,
}
