"""Operations and bytes: the yardstick of the roofline and MFU metrics.

What a model's forward counts comes from its family (``fam``: the
configuration's ``perfbench/reference/<family>.py``, with sizes ``sz``):
``kernel_sites``, ``active_params_per_token`` and ``attention_flops``.
What is here composes them with the card's peaks.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), the
constants of ``repro_torch.plan.cost`` (``PEAK_FLOPS``, ``HBM_BW``), copied.
``gemm_work`` is a frozen copy of ``repro_torch.oprecord.gemm_work`` (used
by ``chip_smoke.gemm_bound_ms``): each f32 operand read once, each output
written once, ``passes`` limb products of 2*M*K*N each.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s

#: tensor-core passes of each precision mode: the retained limb products
#: |{(i, j): i + j < limbs}| of a ``limbs``-limb multiply
MODE_LIMBS = {"M8": 1, "M16": 2, "M24": 3}


def mode_passes(mode: str) -> int:
    k = MODE_LIMBS[mode]
    return k * (k + 1) // 2


def gemm_work(m: int, k: int, n: int, passes: float, outputs: int = 1) -> tuple[float, float]:
    """(FLOPs, bytes) of one hand-GEMM launch."""
    return passes * 2.0 * m * k * n, 4.0 * (m * k + k * n + outputs * m * n)


def gemm_bound_s(m: int, k: int, n: int, passes: float) -> float:
    """Least time for the launch on the data-sheet card: operations over
    the bf16 rate or bytes over the memory rate, whichever is larger."""
    flops, nbytes = gemm_work(m, k, n, passes)
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


def limb_bound_s(fam, sz, m: int, mode: str) -> float:
    """The limb kernel's least time over one forward of ``m`` rows."""
    passes = mode_passes(mode)
    return sum(layers * sum(gemm_bound_s(m, k, n, passes) for k, n in sites)
               for layers, sites in fam.kernel_sites(sz))


def prefill_flops(fam, sz, s: int) -> float:
    """The model's own FLOPs for a prompt of ``s`` tokens (causal: query
    ``i`` attends ``i + 1`` keys); the logits of every position, as the
    served prefill computes them."""
    return 2.0 * fam.active_params_per_token(sz) * s + fam.attention_flops(sz, s * (s + 1) // 2)


def decode_flops(fam, sz, contexts: list[int]) -> float:
    """One decode step over rows whose caches hold ``contexts`` keys each
    (the new token included): each row's token through the model and its
    attention over its real context."""
    return sum(2.0 * fam.active_params_per_token(sz) + fam.attention_flops(sz, c)
               for c in contexts)
