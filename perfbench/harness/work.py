"""Operations and bytes: the yardstick of the roofline and MFU metrics.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), the
constants of ``repro_torch.plan.cost`` (``PEAK_FLOPS``, ``HBM_BW``), copied.
``gemm_work`` is a frozen copy of ``repro_torch.oprecord.gemm_work`` (used
by ``chip_smoke.gemm_bound_ms``): each f32 operand read once, each output
written once, ``passes`` limb products of 2*M*K*N each.
"""
from __future__ import annotations

from reference.model import Sizes

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


def kernel_sites(sz: Sizes) -> list[tuple[int, int]]:
    """(K, N) of every two-operand ``mk,kn->mn`` site of one layer, the
    sites the port sends to the limb kernel under an ``impl='pallas'``
    policy: the attention projections, and a dense layer's SwiGLU.  (The
    router, the experts, attention's products and the logits are general
    einsums, outside the kernel.)"""
    d, hd = sz.d_model, sz.head_dim
    sites = [(d, sz.n_heads * hd), (d, sz.n_kv_heads * hd), (d, sz.n_kv_heads * hd),
             (sz.n_heads * hd, d)]
    if not sz.moe:
        sites += [(d, sz.d_ff), (d, sz.d_ff), (sz.d_ff, d)]
    return sites


def limb_bound_s(sz: Sizes, m: int, mode: str) -> float:
    """The limb kernel's least time over one forward of ``m`` rows."""
    passes = mode_passes(mode)
    return sz.n_layers * sum(gemm_bound_s(m, k, n, passes) for k, n in kernel_sites(sz))


def active_params_per_token(sz: Sizes) -> int:
    """Weights one token multiplies by: every layer's attention projections
    and its MLP (a MoE layer: its router and ``top_k`` experts), and the
    output head.  The embedding is a lookup."""
    d, hd = sz.d_model, sz.head_dim
    attn = d * (sz.n_heads + 2 * sz.n_kv_heads) * hd + sz.n_heads * hd * d
    mlp = (d * sz.experts + sz.top_k * 3 * d * sz.d_ff) if sz.moe else 3 * d * sz.d_ff
    return sz.n_layers * (attn + mlp) + d * sz.vocab


def attention_flops(sz: Sizes, keys: int) -> float:
    """Scores and weighted values of one query over ``keys`` keys, every
    layer."""
    return sz.n_layers * 4.0 * sz.n_heads * sz.head_dim * keys


def prefill_flops(sz: Sizes, s: int) -> float:
    """The model's own FLOPs for a prompt of ``s`` tokens (causal: query
    ``i`` attends ``i + 1`` keys); the logits of every position, as the
    served prefill computes them."""
    return 2.0 * active_params_per_token(sz) * s + attention_flops(sz, s * (s + 1) // 2)


def decode_flops(sz: Sizes, contexts: list[int]) -> float:
    """One decode step over rows whose caches hold ``contexts`` keys each
    (the new token included): each row's token through the model and its
    attention over its real context."""
    return sum(2.0 * active_params_per_token(sz) + attention_flops(sz, c) for c in contexts)
