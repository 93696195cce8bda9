"""The matmul planner: one place where (mode, Strassen depth, impl) is chosen.

Before this subsystem the three run-time levers the paper exposes — RMPM
precision mode (C1/C2), Strassen depth (C4) and execution impl — were
hard-coded at every call site.  ``plan_matmul`` turns a *shape + accuracy*
request into an executable ``Plan`` via the roofline cost model in
``repro_torch.plan.cost``; ``execute`` runs a plan on concrete operands.  Plans are
cached per static key, so tracing a model re-plans each distinct GEMM shape
exactly once.

    plan_matmul(shape_a, shape_b, accuracy=..., backend=...) -> Plan
    execute(plan, a, b) -> Array

Example::

    >>> from repro_torch.plan import plan_matmul
    >>> p = plan_matmul((4096, 4096), (4096, 4096), accuracy=2**-12,
    ...                 backend="gpu")
    >>> p.mode.name, p.impl
    ('M16', 'pallas')

``backend=None`` means the GPU and raises when there is none; ``'cpu'`` and
``'tpu'`` are accepted so that plans can be compared with the reference's
(``balance=`` then carries that machine's constants).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.core.precision import DF32_MODES, MODE_LIMBS, DoubleF32, Mode
from repro_torch.plan import cost as cost_lib
from repro_torch.plan.cost import CostEstimate, NATIVE_REL_ERROR

Array = torch.Tensor

_DF32 = "df32"
_MAX_DEPTH_DEFAULT = 2


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable matmul decision: every lever pinned, costs attached."""

    shape_a: tuple[int, ...]  # (..., M, K)
    shape_b: tuple[int, int]  # (K, N)
    dtype: str  # 'float32' | 'df32'
    mode: Mode
    impl: str  # 'xla' | 'pallas' | 'native' | 'tile'
    strassen_depth: int
    rounding: str
    backend: str
    cost: CostEstimate
    reason: str
    accuracy: float | None = None
    align: int = 128
    #: how the winning candidate's cost was resolved: 'roofline' (the cost
    #: model on data-sheet constants) until the tuner is ported.
    source: str = "roofline"
    #: resolved execution time ranked against the other candidates —
    #: cost.t_total_s of the winner (scaled by the batch).
    t_resolved_s: float | None = None
    #: (bm, bn, bk) map-tile override; None = kernel defaults.  Meaningful
    #: for impl='pallas'/'tile'.
    block: tuple[int, int, int] | None = None
    #: how the tile kernel's per-tile mode map is built (impl='tile' only):
    #: 'uniform' (one mode everywhere — bit-exact with impl='pallas') or
    #: 'magnitude' (per-tile operand abs-max picks the cheapest mode meeting
    #: the plan's accuracy budget; see kernels/tile_matmul/tile_policy.py).
    map_source: str = "uniform"

    @property
    def tile_eligible(self) -> bool:
        """True when a runtime-bound call site (models.layers.pmm) may route
        this plan through the partitioned tile kernel: the fused single-
        dispatch path covers exactly what impl='pallas' covers (f32 ladder),
        and a uniform map is bit-identical to the pallas branch — so any
        pallas-or-tile plan is eligible."""
        return self.impl in ("pallas", "tile") and self.dtype == "float32"

    @property
    def batch(self) -> int:
        return math.prod(self.shape_a[:-2]) if len(self.shape_a) > 2 else 1

    @property
    def mkn(self) -> tuple[int, int, int]:
        return (self.shape_a[-2], self.shape_a[-1], self.shape_b[1])

    @property
    def out_shape(self) -> tuple[int, ...]:
        return self.shape_a[:-1] + (self.shape_b[1],)

    def describe(self) -> str:
        m, k, n = self.mkn
        t = self.cost.t_total_s if self.t_resolved_s is None else self.t_resolved_s
        return (
            f"[{self.batch}x]({m}x{k})@({k}x{n}) -> mode={self.mode.name} "
            f"impl={self.impl} depth={self.strassen_depth} "
            f"({self.cost.dominant}-bound, ~{t*1e6:.1f}us {self.source}) "
            f"| {self.reason}"
        )


# ---------------------------------------------------------------------------
# Plan cache — keyed on the full static request; hit == no re-planning.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    @property
    def entries(self) -> int:
        return len(_PLAN_CACHE)


_PLAN_CACHE: dict[tuple, Plan] = {}
_STATS = CacheStats()


def plan_cache_stats() -> CacheStats:
    return _STATS


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    _STATS.hits = 0
    _STATS.misses = 0


# ---------------------------------------------------------------------------
# Tuning tables — the autotuner is not ported yet (ROADMAP Queue A item 3).
# ---------------------------------------------------------------------------

_TUNER_NOT_PORTED = (
    "measured tuning tables are not ported yet (ROADMAP Queue A item 3, "
    "'Planner and tuner': tune/table.py, tune/runner.py); pass "
    "tune_table=None or False to plan from the roofline model")


def _resolve_tune_table(tune_table, backend: str):
    """``None`` and ``False`` both mean pure roofline; anything else needs
    the tuner, which waits for a later slice."""
    if tune_table is None or tune_table is False:
        return None
    raise NotImplementedError(_TUNER_NOT_PORTED)


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def _impl_candidates(
    mode: Mode, impl: str | None, backend: str, accuracy: float | None,
    mode_pinned: bool, rounding: str,
) -> list[str]:
    if impl is not None:
        return [impl]
    if mode in DF32_MODES:
        # Validation-grade extended precision: the Neumaier scan path
        # (core/rmpm._limb_matmul_dd): a kernel whose passes sum K products
        # in plain f32 saturates in the high 20s of bits.
        return ["xla"]
    cands = []
    # 'native' (plain f32 dot, fidelity ~= M24) is only eligible when the
    # caller asked for an accuracy target that f32 meets — never when a
    # specific mode was pinned (mode semantics, e.g. quantization studies,
    # must be honoured) and never for non-RNE roundings (C3 runs in limbs).
    # A 'tpu' backend (accepted for comparing plans with the reference) has
    # no 1-pass f32 unit, so 'native' is only a candidate on cpu/gpu.
    if (
        backend != "tpu"
        and not mode_pinned
        and rounding == "rne"
        and accuracy is not None
        and NATIVE_REL_ERROR <= accuracy
    ):
        cands.append("native")
    cands.append("xla")
    if backend in ("gpu", "tpu"):
        # The hand-written kernels exist for the GPU (and the reference's for
        # the TPU).  Fused limb extraction only pays off with >= 2 limbs.
        if MODE_LIMBS[mode] >= 2:
            cands.append("pallas")
        # The mode-map tile kernel shares the limb kernel's roofline (same
        # datapath; the map is O(grid) int32), so on ties the earlier
        # 'pallas' candidate wins — 'tile' is selected when pinned, or by
        # the runtime-dispatch layer (Plan.tile_eligible).
        cands.append("tile")
    return cands


def _depth_candidates(m: int, k: int, n: int, mode: Mode, max_depth: int,
                      align: int) -> list[int]:
    if mode in DF32_MODES:
        return [0]  # DoubleF32 leaves cannot flow through the block adds
    out = [0]
    for d in range(1, max_depth + 1):
        # every leaf must still be at least one MXU tile per side
        if min(m, k, n) >= align * (2**d):
            out.append(d)
    return out


def plan_matmul(
    shape_a: tuple[int, ...],
    shape_b: tuple[int, int],
    *,
    dtype: str = "float32",
    accuracy: float | None = None,
    mode: Mode | int | None = None,
    impl: str | None = None,
    backend: str | None = None,
    rounding: str = "rne",
    max_depth: int = _MAX_DEPTH_DEFAULT,
    align: int = 128,
    tune_table: Any = None,
    map_source: str = "uniform",
    balance: cost_lib.MachineBalance | None = None,
) -> Plan:
    """Choose (mode, Strassen depth, impl) for ``a @ b`` from the cost model.

    Args:
      shape_a: operand A shape ``(..., M, K)`` (leading dims are batch).
      shape_b: operand B shape ``(K, N)``.
      dtype: ``'float32'`` or ``'df32'`` (DoubleF32 hi/lo operand pairs).
      accuracy: max acceptable relative error; the cheapest adequate RMPM
        mode is selected (None -> single-precision fidelity, M24).
      mode: pin the RMPM mode instead of deriving it from ``accuracy``.
      impl: pin the execution impl ('xla' | 'pallas' | 'native' | 'tile').
      map_source: tile-map construction for impl='tile' — 'uniform'
        (default; bit-exact with 'pallas') or 'magnitude' (per-tile operand
        statistics pick the cheapest mode within the accuracy budget;
        requires ``accuracy`` and forces impl='tile', the plan's mode being
        the per-tile ceiling).
      backend: 'gpu' | 'cpu' | 'tpu'; None -> 'gpu', raising when no GPU
        is present.
      balance: machine constants the roofline ranks against; None -> the
        H100 SXM data-sheet defaults.
      rounding: limb-extraction rounding ('rne' | 'grte' | 'trunc').
      max_depth: largest Strassen depth the cost model may choose.
      align: leaf tile alignment (MXU tile side).
      tune_table: ``None`` or ``False`` (pure roofline).  Measured tuning
        tables are not ported yet: anything else raises NotImplementedError.

    Returns a cached :class:`Plan`; identical static requests return the
    identical object (see ``plan_cache_stats``).
    """
    shape_a = tuple(int(d) for d in shape_a)
    shape_b = tuple(int(d) for d in shape_b)
    if len(shape_a) < 2 or len(shape_b) != 2:
        raise ValueError(f"need A (..., M, K) and B (K, N); got {shape_a} @ {shape_b}")
    if shape_a[-1] != shape_b[0]:
        raise ValueError(f"contraction mismatch {shape_a} @ {shape_b}")
    if impl is not None and impl not in ("xla", "pallas", "native", "tile"):
        raise ValueError(
            f"unknown impl {impl!r}: want 'xla' | 'pallas' | 'native' | 'tile'"
        )
    if dtype not in ("float32", _DF32):
        raise ValueError(f"unknown dtype {dtype!r}: want 'float32' | 'df32'")
    if map_source not in ("uniform", "magnitude"):
        raise ValueError(
            f"unknown map_source {map_source!r}: want 'uniform' | 'magnitude'"
        )
    if map_source == "magnitude":
        if impl is None:
            impl = "tile"  # per-tile maps exist only in the tile kernel
        elif impl != "tile":
            raise ValueError(f"map_source='magnitude' requires impl='tile', got {impl!r}")
        if accuracy is None:
            raise ValueError("map_source='magnitude' needs an accuracy budget")
        if dtype == _DF32:
            raise ValueError("map_source='magnitude' covers the f32 ladder only")
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "plan_matmul(backend=None) plans for the GPU and found none; "
                "pass backend='cpu' to plan for the CPU")
        backend = "gpu"
    _resolve_tune_table(tune_table, backend)
    if balance is None:
        balance = cost_lib.DEFAULT_BALANCE
    key = (shape_a, shape_b, dtype, accuracy, mode if mode is None else int(mode),
           impl, backend, rounding, max_depth, align, map_source, balance)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _STATS.hits += 1
        return cached
    _STATS.misses += 1

    mode_pinned = mode is not None
    if mode_pinned:
        mode = Mode(mode)
        if mode == Mode.AUTO:
            raise ValueError(
                "Mode.AUTO is a runtime operand probe (core.rmpm."
                "mp_matmul_runtime); the planner needs a static mode or an "
                "accuracy target"
            )
    else:
        mode = cost_lib.cheapest_mode(accuracy)
    if dtype == _DF32 and mode not in DF32_MODES:
        if mode_pinned:
            # pinned-mode semantics must be honoured, and f32 modes reject
            # DoubleF32 operands at execution (core.rmpm._check_mode_operands)
            raise ValueError(
                f"mode {mode.name} pinned but dtype='df32': DoubleF32 "
                f"operands need M32/M48"
            )
        mode = Mode.M32  # DoubleF32 operands need an extended-precision mode
    # DF32 modes on plain f32 operands are legal (core.rmpm accepts them: the
    # product of the given f32 values is computed past 2^-24 and returned as
    # a DoubleF32 pair) — callers asking for accuracy < 2^-21 opt into the
    # wider result type.

    batch = math.prod(shape_a[:-2]) if len(shape_a) > 2 else 1
    m, k = shape_a[-2], shape_a[-1]
    n = shape_b[1]

    best: tuple[tuple, CostEstimate, str, int, str, Any] | None = None
    # Magnitude maps are defined on the whole GEMM's tile grid; Strassen's
    # block adds/subtracts would scramble the per-tile magnitudes the map
    # was derived from, so the recursion is disabled for that source.
    depths = ([0] if map_source == "magnitude"
              else _depth_candidates(m, k, n, mode, max_depth, align))
    for cand_impl in _impl_candidates(mode, impl, backend, accuracy,
                                      mode_pinned, rounding):
        for depth in depths:
            est = cost_lib.estimate(
                m, k, n, mode, cand_impl, depth, align=align,
                peak_flops=balance.peak_flops, hbm_bw=balance.hbm_bw,
                f32_flops=balance.f32_flops,
            )
            # the roofline estimate; measured and interpolated costs belong
            # to the tuner
            t_cand, source, block = est.t_total_s, "roofline", None
            if batch > 1:
                est = CostEstimate(
                    flops=est.flops * batch,
                    hbm_bytes=est.hbm_bytes * batch,
                    t_compute_s=est.t_compute_s * batch,
                    t_memory_s=est.t_memory_s * batch,
                )
                t_cand *= batch
            # Resolved-time ties are common when compute-bound: break them
            # toward less HBM traffic (headroom for everything co-scheduled),
            # then fewer flops.
            rank = (t_cand, est.hbm_bytes, est.flops)
            if best is None or rank < best[0]:
                best = (rank, est, cand_impl, depth, source, block)
    assert best is not None
    rank, est, chosen_impl, chosen_depth, source, block = best
    why = []
    why.append(
        f"mode {mode.name} pinned" if mode_pinned
        else f"mode {mode.name} cheapest for accuracy<={accuracy:.1e}"
        if accuracy is not None else f"mode {mode.name} (single-precision default)"
    )
    why.append(f"impl {chosen_impl}" + (" pinned" if impl is not None else " by cost"))
    why.append(f"depth {chosen_depth} by cost" if chosen_depth or max_depth
               else "depth 0 (disabled)")
    why.append(f"cost {source} ({balance.source})")
    plan = Plan(
        shape_a=shape_a,
        shape_b=shape_b,
        dtype=dtype,
        mode=mode,
        impl=chosen_impl,
        strassen_depth=chosen_depth,
        rounding=rounding,
        backend=backend,
        cost=est,
        reason="; ".join(why),
        accuracy=accuracy,
        align=align,
        source=source,
        t_resolved_s=rank[0],
        block=block if chosen_impl in ("pallas", "tile") else None,
        map_source=map_source,
    )
    _PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def execute(plan: Plan, a, b):
    """Run a :class:`Plan` on concrete operands, on the device they are on.

    Leading batch dims of ``a`` are handled by the engine itself; only the
    Strassen path, which is 2-D, loops over them.
    """
    from repro_torch.core import rmpm, strassen

    a_shape = a.hi.shape if isinstance(a, DoubleF32) else a.shape
    if tuple(a_shape) != plan.shape_a or tuple(b.shape if not isinstance(b, DoubleF32) else b.hi.shape) != plan.shape_b:
        raise ValueError(
            f"operands {tuple(a_shape)} @ "
            f"{tuple(b.shape if not isinstance(b, DoubleF32) else b.hi.shape)} "
            f"do not match plan {plan.shape_a} @ {plan.shape_b}"
        )
    if plan.map_source == "magnitude":
        from repro_torch.kernels.tile_matmul import ops as tile_ops

        bm, bn, bk = plan.block if plan.block is not None else tile_ops.DEFAULT_BLOCK
        return tile_ops.tile_matmul_auto(
            a, b, plan.accuracy, max_mode=plan.mode, rounding=plan.rounding,
            bm=bm, bn=bn, bk=bk,
        )
    device = a.hi.device if isinstance(a, DoubleF32) else a.device
    mm = functools.partial(
        rmpm.mp_matmul, mode=plan.mode, rounding=plan.rounding, impl=plan.impl,
        block=plan.block, device=device,
    )
    if plan.strassen_depth == 0:
        return mm(a, b)
    leaf = mm

    def mm2d(x, y):
        return strassen.strassen_matmul(
            x, y, depth=plan.strassen_depth, leaf_fn=leaf, align=plan.align
        )

    if len(plan.shape_a) == 2:
        return mm2d(a, b)
    flat = a.reshape(-1, *plan.shape_a[-2:])
    out = torch.stack([mm2d(x, b) for x in flat])
    return out.reshape(*plan.out_shape)


def matmul(
    a,
    b,
    *,
    accuracy: float | None = None,
    mode: Mode | int | None = None,
    impl: str | None = None,
    backend: str | None = None,
    rounding: str = "rne",
    max_depth: int = _MAX_DEPTH_DEFAULT,
    tune_table: Any = None,
    map_source: str = "uniform",
    device=None,
) -> Array:
    """Plan-and-execute convenience: ``matmul(a, b, accuracy=2**-12)``.
    Operands are moved to ``device`` (None -> the GPU) and the plan is made
    for that device's backend unless ``backend`` says otherwise."""
    from repro_torch.core.rmpm import _place
    from repro_torch.device import backend_of, resolve_device

    dev = resolve_device(device)
    a, b = _place(a, dev), _place(b, dev)
    if backend is None:
        backend = backend_of(dev)
    dtype = _DF32 if isinstance(a, DoubleF32) or isinstance(b, DoubleF32) else "float32"
    shape_a = a.hi.shape if isinstance(a, DoubleF32) else a.shape
    shape_b = b.hi.shape if isinstance(b, DoubleF32) else b.shape
    plan = plan_matmul(
        tuple(shape_a),
        tuple(shape_b),
        dtype=dtype,
        accuracy=accuracy,
        mode=mode,
        impl=impl,
        backend=backend,
        rounding=rounding,
        max_depth=max_depth,
        tune_table=tune_table,
        map_source=map_source,
    )
    return execute(plan, a, b)


# ---------------------------------------------------------------------------
# Model-level bridge: derive a PrecisionPolicy from planned GEMMs
# ---------------------------------------------------------------------------

# Per-op tightening factors applied to the caller's bulk accuracy budget.
# Numerically sensitive contractions demand more bits — the beyond-paper
# MIXED policy's structure, now cost-derived instead of hand-tuned.
_OP_ACCURACY_SCALE = {
    "attn_qk": 2.0**-4,  # softmax logits: tight
    "logits": 2.0**-4,
    "router": 2.0**-6,  # MoE routing: tightest (top-k flips)
}


def plan_model_policy(cfg: Any, tokens: int, *, accuracy: float,
                      backend: str | None = None, max_depth: int = 0,
                      rounding: str = "rne", tune_table: Any = None,
                      balance: cost_lib.MachineBalance | None = None):
    """Plan the dominant GEMMs of an ArchConfig-like model and fold the
    decisions into a PrecisionPolicy (+ the per-op plans, for reporting).

    ``accuracy`` is the bulk-GEMM relative-error budget; numerically
    sensitive op classes are planned at a tightened budget (see
    ``_OP_ACCURACY_SCALE``).  ``tokens`` is the expected batch*seq of one
    step — it sets the M dim the cost model sees.
    """
    from repro_torch.core.policy import PrecisionPolicy

    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    qkv_out = cfg.n_heads * cfg.head_dim if cfg.n_heads else d
    gemms = {
        "qkv": (d, qkv_out),
        "out": (qkv_out, d),
        "mlp_up": (d, ff),
        "mlp_down": (ff, d),
        "logits": (d, vocab),
        "attn_qk": (d, d),
        "attn_av": (d, d),
    }
    if getattr(cfg, "moe_experts", 0):
        gemms["router"] = (d, cfg.moe_experts)
        gemms["moe_expert"] = (d, ff)
    plans = {}
    for op, (din, dout) in gemms.items():
        acc = accuracy * _OP_ACCURACY_SCALE.get(op, 1.0)
        plans[op] = plan_matmul(
            (max(tokens, 1), din), (din, dout),
            accuracy=acc, backend=backend, max_depth=max_depth,
            rounding=rounding, tune_table=tune_table, balance=balance,
        )
    default_mode = plans["mlp_up"].mode
    overrides = tuple(
        (op, p.mode) for op, p in plans.items() if p.mode != default_mode
    )
    # one impl for the whole policy: what the planner chose for the largest
    # GEMM (the vocab head dominates the step cost)
    impl = plans["logits"].impl
    depth = max(p.strassen_depth for p in plans.values())
    policy = PrecisionPolicy(
        default=default_mode,
        overrides=overrides,
        rounding=rounding,
        impl=impl,
        max_strassen_depth=depth if max_depth else 0,
    )
    return policy, plans
