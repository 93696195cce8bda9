"""RMPM — the Run-time-reconfigurable Multi-Precision Matmul engine (C1+C2).

This is the paper's reconfigurable floating-point multiplier, lifted from a
single FP multiply to the GPU's unit of work: a matmul on the tensor cores.

  * ``mp_matmul(a, b, mode)``         — static-mode k-limb matmul
  * ``mp_matmul_runtime(a, b, mode)`` — run-time mode; with ``impl='tile'``
        the mode is data read inside ONE kernel; otherwise a host int
        branches on the host over the static paths and a device scalar
        selects among them on the device (no read-back)
  * ``mp_einsum(eq, a, b, mode)``     — same engine for arbitrary
        contractions (attention scores, attention-value, logits, ...)

Implementation paths (the names are the reference's; plans, policies and
tables carry them):
  * ``impl='xla'``    — limb algebra as separate PyTorch products, one f32
        product per retained term (the plain version; CPU and GPU).
  * ``impl='pallas'`` — the fused hand-written limb kernel
        (kernels/limb_matmul): operands read once, limbs made on chip.
  * ``impl='tile'``   — the hand-written mode-map kernel
        (kernels/tile_matmul): a per-tile mode map rides along as data, so
        one launch serves every f32-ladder mode (and mixed-mode maps);
        uniform maps are bit-identical to impl='pallas'.
  * ``impl='native'`` — one plain f32 ``torch.matmul``/``einsum``
        (numerically ~= M24).

High modes (M32/M48) accumulate their partial products with Neumaier
compensation, because a plain f32 accumulator would cap the achievable
precision near 2^-24 for large K.

Entry points take ``device=None``, meaning the GPU (and raise when there is
none); the CPU is used only when ``device="cpu"`` is passed.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core import limb as limb_lib
from repro_torch.core.precision import (
    DF32_MODES,
    F32_MODES,
    MODE_LIMBS,
    DoubleF32,
    Mode,
    auto_mode,
)
from repro_torch.device import require_full_f32_matmul, resolve_device

Tensor = torch.Tensor


def _place(x, device):
    """Operand on the resolved device (a no-op when it is already there)."""
    if isinstance(x, DoubleF32):
        return DoubleF32(_place(x.hi, device), _place(x.lo, device))
    return torch.as_tensor(x).to(device)


def _device_of(x) -> torch.device:
    return (x.hi if isinstance(x, DoubleF32) else x).device


def _two_sum(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _neumaier_sum(parts: Sequence[Tensor]) -> Tensor:
    s = parts[0]
    comp = torch.zeros_like(s)
    for p in parts[1:]:
        s, e = _two_sum(s, p)
        comp = comp + e
    return s + comp


# ---------------------------------------------------------------------------
# Core limb contraction
# ---------------------------------------------------------------------------


def _einsum(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``torch.einsum(eq, a, b)``.  A DTensor ``a`` sharded on one of its
    free dims after the first (the sequence of a sequence-parallel arch's
    (batch, sequence, d) activations) has its first dim made a batch dim of
    both operands (``b`` expanded, a view): ``einsum`` would otherwise
    flatten the free dims into one, which DTensor (torch 2.11) refuses
    where a dim other than the first of them is sharded."""
    if isinstance(a, DTensor) and a.ndim >= 3:
        left, rest = eq.split(",")
        right, out = rest.split("->")
        lead = left[0]
        if lead in out and lead not in right and any(
                isinstance(p, Shard) and p.dim >= 1 and left[p.dim] not in right
                for p in a.placements):
            return torch.einsum(f"{left},{lead}{right}->{out}", a,
                                b.expand(a.shape[0], *b.shape))
    return torch.einsum(eq, a, b)


def _limb_einsum(
    eq: str,
    a,
    b,
    k: int,
    rounding: str = "rne",
    compensated: bool | None = None,
) -> Tensor:
    """k-limb multi-pass contraction: sum over Karatsuba terms (i+j < k) of
    einsum(a_i, b_j), one f32 product per pass.

    A PyTorch product of bf16 inputs returns bf16, so each limb is upcast to
    f32 first (exact: a bf16 value is an f32 value) and the pass is a full
    f32 product — TF32 must be off on the GPU, and is checked to be.  The
    limbs are made in f32 one at a time (``split_limbs_f32``) and terms are
    computed one at a time, so that a large operand (the logits weight)
    never holds more than its f32 limbs and one product.  Under autograd
    the limbs are cast per product instead (``limb_operands``), so the
    gradient rounds where the reference's does."""
    if compensated is None:
        compensated = k >= 4
    a_f = limb_lib.limb_operands(a, k, rounding)
    b_f = limb_lib.limb_operands(b, k, rounding)
    require_full_f32_matmul(_device_of(a))
    terms = limb_lib.limb_product_terms(k)
    if compensated:
        return _neumaier_sum([_einsum(eq, a_f(i), b_f(j)) for i, j in terms])
    acc = None
    for i, j in terms:
        p = _einsum(eq, a_f(i), b_f(j))
        acc = p if acc is None else acc + p
    return acc


def _limb_einsum_ladder(eq: str, a, b, rounding: str = "rne") -> list[Tensor]:
    """``_limb_einsum(eq, a, b, k)`` at every f32-ladder mode, in ladder
    order, bit for bit, from ONE set of limb products.

    For an f32 operand ``split_limbs(x, k)``'s leading limbs do not depend on
    ``k`` (its loop only stops sooner), so each retained product is made
    once at the ladder's top and shared.  The sums are NOT: the terms are
    ordered smallest first (``limb_product_terms``), so k = 3's order does
    not extend k = 2's and each mode folds its own terms in its own order."""
    kmax = MODE_LIMBS[F32_MODES[-1]]
    a_f = limb_lib.limb_operands(a, kmax, rounding)
    b_f = limb_lib.limb_operands(b, kmax, rounding)
    require_full_f32_matmul(_device_of(a))
    products = {(i, j): _einsum(eq, a_f(i), b_f(j))
                for i, j in limb_lib.limb_product_terms(kmax)}
    out = []
    for mode in F32_MODES:
        acc = None
        for ij in limb_lib.limb_product_terms(MODE_LIMBS[mode]):
            acc = products[ij] if acc is None else acc + products[ij]
        out.append(acc)
    return out


def _mode_select(mode: Tensor, branches: Sequence[Tensor]) -> Tensor:
    """``branches[i]`` is a result at ``F32_MODES[i]``: return the one an
    int32 device scalar ``mode`` names, clamped to the ladder as the host
    path clamps.  The choice is made by ``torch.where`` on the device, with
    no read-back, so it survives CUDA-graph capture — the port's
    counterpart of the reference's ``lax.switch``."""
    m = mode.to(device=branches[0].device, dtype=torch.int32)
    out = branches[-1]
    for i in range(len(branches) - 2, -1, -1):
        out = torch.where(m <= int(F32_MODES[i]), branches[i], out)
    return out


def _matmul_eq(ndim: int) -> str:
    """The einsum ``mp_matmul`` runs an ``ndim``-D left operand through."""
    if ndim == 2:
        return "mk,kn->mn"
    lead = "uvwxyz"[: ndim - 1]
    return f"{lead}k,kn->{lead}n"


def _limb_matmul_dd(a, b, k: int, rounding: str = "rne") -> DoubleF32:
    """High-precision (M32/M48) 2D matmul with double-f32 (Neumaier)
    accumulation.  a: (M, K), b: (K, N)  ->  (M, N) DoubleF32.

    bf16 x bf16 elementwise products are EXACT in f32 (16-bit significands),
    so the only error source is summation; a TwoSum cascade over the K axis
    and the Karatsuba terms keeps it near u^2 ~ 2^-48 instead of the ~2^-24
    cap of a monolithic f32 dot.  O(K) sequential Python loop — this is the
    validation-grade path.
    """
    a_f = limb_lib.split_limbs(a, k, rounding).to(torch.float32)  # (k, M, K)
    b_f = limb_lib.split_limbs(b, k, rounding).to(torch.float32)  # (k, K, N)
    terms = limb_lib.limb_product_terms(k)
    m, kdim = a_f.shape[1], a_f.shape[2]
    n = b_f.shape[2]
    s = torch.zeros((m, n), dtype=torch.float32, device=a_f.device)
    comp = torch.zeros_like(s)
    for x in range(kdim):
        for i, j in terms:
            p = a_f[i, :, x][:, None] * b_f[j, x, :][None, :]  # exact in f32
            s, e = _two_sum(s, p)
            comp = comp + e
    # The result carries > 24 significand bits, so it is returned as a
    # DoubleF32 pair (the paper likewise outputs the full double-width word).
    hi, lo = _two_sum(s, comp)
    return DoubleF32(hi, lo)


def _check_mode_operands(mode: Mode, a, b) -> None:
    if mode in DF32_MODES:
        return  # DoubleF32 preferred but plain f32 accepted (lo = 0)
    if isinstance(a, DoubleF32) or isinstance(b, DoubleF32):
        raise ValueError(
            f"mode {mode.name} is an f32 mode; DoubleF32 operands need M32/M48"
        )


def mp_einsum(
    eq: str,
    a,
    b,
    mode: Mode = Mode.M24,
    *,
    rounding: str = "rne",
    impl: str = "xla",
    block: tuple[int, int, int] | None = None,
    device=None,
) -> Tensor:
    """Multi-precision einsum through the RMPM engine (two-operand).

    ``block`` carries a (bm, bn, bk) map-tile override: it is honoured when
    ``impl`` is 'pallas'/'tile' and ``eq`` is the plain 2D matmul contraction
    (dispatched to the fused kernels), and ignored otherwise — general
    einsum contractions run the limb algebra as plain products.
    """
    mode = Mode(mode)
    dev = resolve_device(device)
    a, b = _place(a, dev), _place(b, dev)
    if impl in ("pallas", "tile") and eq == "mk,kn->mn" and mode != Mode.AUTO:
        return mp_matmul(a, b, mode, rounding=rounding, impl=impl, block=block,
                         device=dev)
    if impl == "native" or mode == Mode.AUTO:
        if mode == Mode.AUTO:
            raise ValueError("AUTO requires mp_matmul_runtime / mp_einsum_runtime")
        av = a.hi + a.lo if isinstance(a, DoubleF32) else a
        bv = b.hi + b.lo if isinstance(b, DoubleF32) else b
        require_full_f32_matmul(dev)
        return _einsum(eq, av.to(torch.float32), bv.to(torch.float32))
    _check_mode_operands(mode, a, b)
    return _limb_einsum(eq, a, b, MODE_LIMBS[mode], rounding)


def mp_matmul(
    a,
    b,
    mode: Mode = Mode.M24,
    *,
    rounding: str = "rne",
    impl: str = "xla",
    strassen_depth: int = 0,
    block: tuple[int, int, int] | None = None,
    device=None,
) -> Tensor:
    """Multi-precision matmul: a (..., K) @ b (K, N) -> (..., N) f32.

    ``strassen_depth > 0`` routes through the paper's top-down Strassen block
    recursion (C4) with this engine at the leaves.  ``block`` overrides the
    kernels' (bm, bn, bk) map-tile sizes; the non-kernel impls ignore it.
    """
    mode = Mode(mode)
    dev = resolve_device(device)
    a, b = _place(a, dev), _place(b, dev)
    if strassen_depth > 0:
        from repro_torch.core import strassen as strassen_lib  # local import (cycle)

        leaf = functools.partial(
            mp_matmul, mode=mode, rounding=rounding, impl=impl, block=block,
            device=dev,
        )
        return strassen_lib.strassen_matmul(a, b, depth=strassen_depth, leaf_fn=leaf)
    if impl == "tile":
        from repro_torch.kernels.tile_matmul import ops as tile_ops

        bm, bn, bk = block if block is not None else tile_ops.DEFAULT_BLOCK
        return tile_ops.tile_matmul_mode(
            a, b, mode, rounding=rounding, bm=bm, bn=bn, bk=bk
        )
    if impl == "pallas":
        from repro_torch.kernels.limb_matmul import ops as limb_ops

        if block is not None:
            bm, bn, bk = block
            return limb_ops.limb_matmul(
                a, b, MODE_LIMBS[mode], rounding=rounding, bm=bm, bn=bn, bk=bk
            )
        return limb_ops.limb_matmul(a, b, MODE_LIMBS[mode], rounding=rounding)
    shape_a = a.hi.shape if isinstance(a, DoubleF32) else a.shape
    if len(shape_a) == 2 and mode in DF32_MODES and impl == "xla":
        return _limb_matmul_dd(a, b, MODE_LIMBS[mode], rounding)
    return mp_einsum(_matmul_eq(len(shape_a)), a, b, mode, rounding=rounding,
                     impl=impl, device=dev)


# ---------------------------------------------------------------------------
# Runtime reconfiguration (C1's mode-select bits + C2's auto-mode)
# ---------------------------------------------------------------------------


def _host_mode(mode) -> int:
    """A run-time mode as a host int.  A device tensor has to be read back
    (one sync): only the DF32 switch does this — the f32 paths select on
    the device instead."""
    if isinstance(mode, torch.Tensor):
        return int(mode.item())
    return int(mode)


def mp_matmul_runtime(
    a: Tensor,
    b: Tensor,
    mode=Mode.AUTO,
    *,
    rounding: str = "rne",
    auto_tol: float = 0.0,
    impl: str = "xla",
    block: tuple[int, int, int] | None = None,
    allow_auto: bool = True,
    device=None,
) -> Tensor:
    """Runtime-reconfigurable matmul over the f32 mode set {M8, M16, M24}.

    ``mode`` may be a host int (a ModeTable's ``scalars()``) or a device
    int32 scalar (its ``device_view``, which the serving engine binds so
    that a captured step reads its mode as data).  ``Mode.AUTO`` (0) probes
    the operands and picks the cheapest adequate mode.

    ``impl='tile'`` is the run-time path proper: the mode becomes a uniform
    map in device memory read by ONE kernel, so no branch is taken on the
    host and nothing is built when the mode changes.  The other impls
    branch on a host int over the static paths; a device scalar computes
    every static branch (for ``'xla'`` from one shared set of limb products)
    and selects on the device (``_mode_select``), bit-equal to the host
    branch at every mode and with no read-back.

    ``allow_auto=False`` asserts the mode is concrete (1..3), never
    ``Mode.AUTO``: the operand-occupancy probe, which reads both operands
    three times, is skipped entirely.
    """
    dev = resolve_device(device)
    a, b = _place(a, dev), _place(b, dev)
    if isinstance(mode, Mode) and mode != Mode.AUTO:
        return mp_matmul(a, b, mode, rounding=rounding, impl=impl, block=block,
                         device=dev)
    selected = mode
    if allow_auto:
        if isinstance(mode, torch.Tensor):
            mode_t = mode.to(device=dev, dtype=torch.int32)
            selected = torch.where(
                mode_t == int(Mode.AUTO),
                auto_mode(a, b, tol=auto_tol, max_mode=Mode.M24), mode_t)
        elif int(mode) == int(Mode.AUTO):
            selected = auto_mode(a, b, tol=auto_tol, max_mode=Mode.M24)
    if impl == "tile":
        from repro_torch.kernels.tile_matmul import ops as tile_ops

        bm, bn, bk = block if block is not None else tile_ops.DEFAULT_BLOCK
        return tile_ops.tile_matmul_runtime(
            a, b, selected, rounding=rounding, bm=bm, bn=bn, bk=bk
        )
    if isinstance(selected, torch.Tensor):
        if impl == "xla":
            branches = _limb_einsum_ladder(_matmul_eq(a.dim()), a, b, rounding)
        else:
            branches = [mp_matmul(a, b, m, rounding=rounding, impl=impl,
                                  block=block, device=dev) for m in F32_MODES]
        return _mode_select(selected, branches)
    idx = min(max(_host_mode(selected) - 1, 0), len(F32_MODES) - 1)
    return mp_matmul(a, b, F32_MODES[idx], rounding=rounding, impl=impl,
                     block=block, device=dev)


def mp_einsum_runtime(
    eq: str,
    a: Tensor,
    b: Tensor,
    mode,
    *,
    rounding: str = "rne",
    impl: str = "xla",
    block: tuple[int, int, int] | None = None,
    device=None,
) -> Tensor:
    """Runtime-switchable einsum over the f32 mode set {M8, M16, M24} —
    ``mp_matmul_runtime``'s contraction-generic sibling, used by the adapted
    ``pein`` call-sites (attention scores / attention-value / logits).

    ``impl='native'`` is rejected: its branches would all compute the same
    plain f32 einsum, silently turning the mode switch into a no-op.

    A device int32 ``mode`` is selected on the device, as in
    ``mp_matmul_runtime``: a general contraction makes its limb products
    once (``_limb_einsum_ladder``) and folds them per mode.  A site bound
    this way pays the ladder top's k(k+1)/2 = 6 products at every mode.
    """
    if impl == "native":
        raise ValueError(
            "impl='native' ignores the mode: a runtime switch over identical "
            "branches is a no-op; use the static mp_einsum instead"
        )
    dev = resolve_device(device)
    if impl == "tile":
        if eq == "mk,kn->mn":
            return mp_matmul_runtime(
                a, b, mode, rounding=rounding, impl="tile", block=block,
                allow_auto=False, device=dev,
            )
        # General contractions have no tile kernel; keep the branch over the
        # plain limb algebra rather than silently changing numerics.
        impl = "xla"
    if isinstance(mode, torch.Tensor):
        a, b = _place(a, dev), _place(b, dev)
        if impl == "pallas" and eq == "mk,kn->mn":
            branches = [mp_matmul(a, b, m, rounding=rounding, impl=impl,
                                  block=block, device=dev) for m in F32_MODES]
        else:
            branches = _limb_einsum_ladder(eq, a, b, rounding)
        return _mode_select(mode, branches)
    idx = min(max(_host_mode(mode) - 1, 0), len(F32_MODES) - 1)
    return mp_einsum(eq, a, b, F32_MODES[idx], rounding=rounding, impl=impl,
                     block=block, device=dev)


def mp_matmul_runtime_df32(
    a: DoubleF32,
    b: DoubleF32,
    mode,
    *,
    rounding: str = "rne",
    device=None,
) -> DoubleF32:
    """Runtime switch over the extended-precision mode set {M32, M48}."""
    idx = min(max(_host_mode(mode) - int(Mode.M32), 0), len(DF32_MODES) - 1)
    return mp_matmul(a, b, DF32_MODES[idx], rounding=rounding, device=device)


# ---------------------------------------------------------------------------
# Model-facing convenience
# ---------------------------------------------------------------------------


def mp_linear(x: Tensor, w: Tensor, b: Tensor | None, mode: Mode, **kw) -> Tensor:
    out = mp_matmul(x, w, mode, **kw)
    if b is not None:
        out = out + b.to(out.dtype)
    return out
