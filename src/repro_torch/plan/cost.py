"""Roofline cost model for the matmul planner .

One estimator, three levers — the same levers the paper exposes as run-time
reconfiguration, lifted to the block-algorithm level:

  * **RMPM precision mode** — a k-limb mode runs ``MODE_PASSES[mode]`` =
    k(k+1)/2 bf16 tensor-core passes per leaf matmul (compute term scales with
    passes) and, on the ``xla`` impl, materializes k bf16 limb copies of each
    operand in HBM (memory term scales with limbs).  The ``pallas`` impl
    (kernels/limb_matmul) reads the f32 operands once per block and extracts
    limbs on chip, collapsing the limb memory factor back to ~1.
  * **Strassen depth** — each level multiplies leaf matmul FLOPs by 7/8 in
    exchange for O(n^2) block adds and zero-padding to ``align * 2^depth``
    multiples (core/strassen.py).  The cost model charges the padded leaf
    FLOPs, the add FLOPs, and the add memory traffic explicitly, so depth
    only wins when the (7/8)^depth saving beats the pad + add overhead at
    the machine balance point.
  * **impl** — 'native' (plain f32 dot: 1 pass, no limb traffic, fidelity
    ~= M24), 'xla' (limb algebra in HBM), 'pallas' (fused limb extraction).

The machine-balance defaults are DATA-SHEET constants of the NVIDIA H100 SXM
(989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM, 67 TFLOP/s of
f32 outside the tensor cores), labelled as such in ``MachineBalance.source``.
'native' is one f32 ``torch.matmul``, which does not run at the bf16
tensor-core rate, so it is charged at the f32 rate; otherwise it would win
every accuracy-planned GEMM and the planner would never pick the multiplier
this system is about.  ``chip_smoke.py`` measures an f32 ``torch.matmul``
beside that constant.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.precision import MODE_PASSES, Mode

# NVIDIA H100 SXM data-sheet constants (dense rates, full 700 W power limit).
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
F32_FLOPS = 67e12  # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 900e9  # bytes/s of NVLink 4 per GPU (both directions together)

F32_BYTES = 4
BF16_BYTES = 2

# Relative-error ceiling per mode on well-conditioned operands — the ladder
# validated by tests/test_core_precision.py (TestModeLadder) and the paper's
# Table 9 / Fig 17.  M24 is f32-accumulation limited, not 2^-24.
MODE_REL_ERROR: dict[Mode, float] = {
    Mode.M8: 2.0**-7,
    Mode.M16: 2.0**-15,
    Mode.M24: 2.0**-21,
    Mode.M32: 2.0**-28,
    Mode.M48: 2.0**-35,
}

# 'native' executes torch.matmul in f32: numerically ~= M24 (see core/rmpm.py).
NATIVE_REL_ERROR = MODE_REL_ERROR[Mode.M24]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class MachineBalance:
    """The roofline's machine constants: peak bf16 tensor-core FLOP/s, HBM
    bandwidth, and the f32 rate that 'native' (one f32 matmul) is charged at.

    The defaults are the H100 SXM data-sheet figures.  ``fit_balance``
    re-fits the first two from measured samples so the planner can rank
    candidates against the machine it actually runs on.  ``f32_flops=None``
    charges 'native' at ``peak_flops`` (a machine with no separate f32 rate).
    """

    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    f32_flops: float | None = F32_FLOPS
    source: str = "H100 SXM data sheet"


DEFAULT_BALANCE = MachineBalance()


def fit_balance(samples, *, source: str = "fit") -> MachineBalance:
    """Re-fit the roofline constants from measured (CostEstimate, wall_s) pairs.

    Under the roofline ``t = max(flops/P, bytes/B)`` every sample is a lower
    bound ``P >= flops/t`` and ``B >= bytes/t``; the tightest machine
    consistent with all samples is the max over each bound — the achieved-
    rate envelope.  Compute-bound samples pin P, memory-bound samples pin B;
    with only one regime sampled the other constant stays a (loose) envelope
    too, which only shrinks the estimated time of candidates the measurements
    never contradicted.  Empty/degenerate input falls back to the defaults.
    """
    peak = 0.0
    bw = 0.0
    for est, wall_s in samples:
        if wall_s <= 0:
            continue
        peak = max(peak, est.flops / wall_s)
        bw = max(bw, est.hbm_bytes / wall_s)
    if peak <= 0 or bw <= 0:
        return DEFAULT_BALANCE
    return MachineBalance(peak_flops=peak, hbm_bw=bw, f32_flops=None, source=source)


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Roofline terms for one (mode, impl, depth) candidate."""

    flops: float  # tensor-core + add flops
    hbm_bytes: float  # operand/limb/add/result traffic
    t_compute_s: float
    t_memory_s: float

    @property
    def t_total_s(self) -> float:
        # Roofline: compute and memory overlap; the slower term binds.  Using
        # max() (not sum) matches roofline_terms() in launch/hlo_cost.py.
        return max(self.t_compute_s, self.t_memory_s)

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute_s >= self.t_memory_s else "memory"


def limb_factors(mode: Mode, impl: str) -> tuple[int, float]:
    """(tensor-core passes per leaf, operand-read multiplier) for a mode x impl.

    'native' runs one f32 pass and reads each operand once.  'xla' runs
    k(k+1)/2 bf16 passes and materializes k bf16 limb tensors per operand
    (k * 2 bytes = k/2 the f32 footprint per read, but each pass re-reads its
    two limb operands — we charge one bf16 read per pass operand, the
    schedule of the unfused formulation).  'pallas' reads
    the f32 block once and keeps limbs on chip (csrc/rmpm_gemm.cuh).
    """
    if impl == "native":
        return 1, 1.0
    passes = MODE_PASSES[mode]
    if impl in ("pallas", "tile"):
        # 'tile' shares the fused-kernel roofline: a uniform map runs the
        # same passes over the same once-read blocks; the per-tile mode map
        # itself is O(grid) int32 — negligible traffic.
        return passes, 1.0
    # xla: each of the `passes` bf16 dots reads one limb of A and one of B.
    return passes, passes * (BF16_BYTES / F32_BYTES)


def strassen_overhead(m: int, k: int, n: int, depth: int, align: int) -> tuple[
    tuple[int, int, int], float, float
]:
    """Padded leaf dims + (add flops, add bytes) for a depth-level recursion.

    Per level on an (M, K) x (K, N) node: 10 operand pre-adds (quarter A/B
    size) and 8 combination adds (quarter C size); each add element is 1 flop
    and 3 f32 transfers (2 reads + 1 write).  Level l has 7^(l-1) nodes of
    1/4^(l-1) the area — the O(n^2) term that caps useful depth.
    """
    if depth == 0:
        return (m, k, n), 0.0, 0.0
    unit = align * (2**depth)
    mp_, kp, np_ = _ceil_to(m, unit), _ceil_to(k, unit), _ceil_to(n, unit)
    add_elems = 0.0
    nodes = 1.0
    a_area, b_area, c_area = mp_ * kp, kp * np_, mp_ * np_
    for _ in range(depth):
        a_area /= 4.0
        b_area /= 4.0
        c_area /= 4.0
        add_elems += nodes * (10.0 * max(a_area, b_area) + 8.0 * c_area)
        nodes *= 7.0
    return (mp_, kp, np_), add_elems, 3.0 * F32_BYTES * add_elems


def estimate(
    m: int,
    k: int,
    n: int,
    mode: Mode,
    impl: str,
    depth: int,
    *,
    align: int = 128,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    f32_flops: float | None = None,
) -> CostEstimate:
    """Roofline estimate for C = A (m, k) @ B (k, n) under one candidate.

    ``f32_flops`` is the rate 'native' is charged at; ``None`` charges it
    at ``peak_flops`` like every other impl."""
    (mp_, kp, np_), add_flops, add_bytes = strassen_overhead(m, k, n, depth, align)
    passes, read_mult = limb_factors(mode, impl)
    leaf_ratio = (7.0 / 8.0) ** depth
    mxu_flops = leaf_ratio * 2.0 * mp_ * kp * np_ * passes
    operand_bytes = read_mult * F32_BYTES * (mp_ * kp + kp * np_)
    result_bytes = F32_BYTES * mp_ * np_
    if mode in (Mode.M32, Mode.M48):
        operand_bytes *= 2.0  # DoubleF32 (hi, lo) operands
        result_bytes *= 2.0
    flops = mxu_flops + add_flops
    hbm = operand_bytes + result_bytes + add_bytes
    return CostEstimate(
        flops=flops,
        hbm_bytes=hbm,
        t_compute_s=flops / (f32_flops if impl == "native" and f32_flops
                             else peak_flops),
        t_memory_s=hbm / hbm_bw,
    )


def cheapest_mode(accuracy: float | None) -> Mode:
    """Smallest mode whose error ceiling meets ``accuracy`` (max rel error).

    ``None`` means "single-precision fidelity" -> M24, the paper-baseline
    default (a conventional FP32 unit's behaviour).
    """
    if accuracy is None:
        return Mode.M24
    for mode in (Mode.M8, Mode.M16, Mode.M24, Mode.M32, Mode.M48):
        if MODE_REL_ERROR[mode] <= accuracy:
            return mode
    return Mode.M48
