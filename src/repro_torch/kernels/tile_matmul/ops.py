"""Wrappers, plain version and launch path of the mode-map tile_matmul kernel.

The CUDA kernel (``csrc/tile_matmul.cu``) replaces the TPU kernel
``tile_matmul_pallas``.  Entry points (all accept leading batch dims on ``a``):

* ``tile_matmul(a, b, mode_map)``       — explicit per-tile map
* ``tile_matmul_mode(a, b, mode)``      — static uniform map from a Mode
  (bit-identical to ``limb_matmul`` at the same blocks, by construction)
* ``tile_matmul_runtime(a, b, scalar)`` — a run-time mode (host int or
  device int32 scalar) broadcast into a uniform map ON THE DEVICE: one launch
  of one kernel at every mode, no host sync, nothing built when it changes
* ``tile_matmul_auto(a, b, budget)``    — magnitude-statistics map (see
  ``tile_policy.magnitude_map``)

For CUDA tensors the kernel is launched (or the call raises); CPU tensors
run ``tile_matmul_plain``, the same function in plain PyTorch.  Every entry
point takes ``splits=`` (the K split count; ``None``: ``split_k``, see
``kernels.limb_matmul.ops``) as an override for timing.
"""
from __future__ import annotations

import torch

from repro_torch.core.limb import limb_product_terms
from repro_torch.core.precision import F32_MODES, MODE_LIMBS, Mode
from repro_torch.kernels import build
from repro_torch.kernels.limb_matmul.ops import (
    DEFAULT_BLOCK,  # noqa: F401  (re-exported: the planner reads it here)
    check_gemm_operands,
    extract_limbs,
    gemm_body,
    k_step,
    reduce_splits,
    resolve_splits,
    split_pieces,
    split_workspace,
    tile_grid,
)
from repro_torch import oprecord

F32_KMAX = max(MODE_LIMBS[m] for m in F32_MODES)  # 3 limbs (M24)


def _expand_map(mode_map2d: torch.Tensor, bm: int, bn: int, m: int, n: int) -> torch.Tensor:
    """(gm, gn) map -> per-element (m, n) limb counts."""
    return mode_map2d.repeat_interleave(bm, 0).repeat_interleave(bn, 1)[:m, :n]


def tile_matmul_plain(a: torch.Tensor, b: torch.Tensor, mode_map: torch.Tensor, *,
                      kmax: int, bm: int, bn: int, bk: int, splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel on (M, K) @ (K, N) f32 with the
    CLAMPED blocks.  Same walk as ``limb_matmul_plain`` (per split, its K
    pieces with terms high order first; partials added in split order), each
    piece under the map entry of its slab; a pass updates only the elements
    whose tile runs it, so a uniform map reproduces ``limb_matmul_plain`` bit
    for bit at every ``splits``."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, kdim = a.shape
    n = b.shape[1]
    mode_map = mode_map.to(device=a.device, dtype=torch.int32)
    al, bl = extract_limbs(a, kmax), extract_limbs(b, kmax)
    parts = []
    for pieces in split_pieces(kdim, bk, k_step(kmax), splits):
        acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
        for kk, k0, k1 in pieces:
            slab = mode_map[:, :, kk] if mode_map.dim() == 3 else mode_map
            k_elem = _expand_map(slab, bm, bn, m, n)
            for ti, tj in limb_product_terms(kmax):
                p = al[ti][:, k0:k1] @ bl[tj][k0:k1, :]
                acc = torch.where(ti + tj < k_elem, acc + p, acc)
        parts.append(acc)
    return reduce_splits(parts)


def _launch(a2, b2, mode_map, kmax, bm, bn, bk, splits) -> torch.Tensor:
    check_gemm_operands(a2, b2, "tile_matmul")
    if not 1 <= kmax <= F32_KMAX:
        raise ValueError(f"tile_matmul kernel supports kmax 1..{F32_KMAX}, got {kmax}")
    if (not mode_map.is_cuda or mode_map.dtype != torch.int32
            or not mode_map.is_contiguous() or mode_map.device != a2.device):
        raise ValueError(
            "tile_matmul kernel takes the mode map as a contiguous int32 "
            f"tensor on the operands' device, got {mode_map.dtype} on {mode_map.device}")
    m, kdim = a2.shape
    n = b2.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a2.device)
    ws = split_workspace(splits, m, n, a2.device)
    lib = build.library()
    with torch.cuda.device(a2.device):
        build.prepare_device(lib)
        code = lib.rmpm_tile_matmul(
            a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), mode_map.data_ptr(),
            mode_map.dim(), m, n, kdim, kmax, bm, bn, bk, splits,
            build.current_stream_ptr())
    build.check_launch(lib, code, "tile_matmul")
    build.LAUNCHES["tile_matmul"] += 1
    return out


def tile_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    mode_map: torch.Tensor,
    *,
    kmax: int = F32_KMAX,
    rounding: str = "rne",
    bm: int = 128,
    bn: int = 128,
    bk: int = 512,
    splits: int | None = None,
) -> torch.Tensor:
    """Multi-precision matmul a (..., K) @ b (K, N) with a per-tile mode map.

    ``mode_map`` entries are f32-ladder Mode values (== limb counts, in
    [1, kmax]); its shape must match ``tile_grid`` for the flattened
    problem.  The map is data: a new map reuses the built kernel.  Raises
    under autograd (``build.refuse_autograd``).
    """
    build.refuse_autograd("tile_matmul", a, b)
    if rounding != "rne":
        from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op

        # GRTE applies at the coarsest retained limb width (kmax), matching
        # limb_matmul's pre-pass for uniform maps; identity for kmax >= 3.
        keep = 8 * kmax - 1
        a = quantize_mantissa_op(a, keep, rounding)
        b = quantize_mantissa_op(b, keep, rounding)
    lead = a.shape[:-1]
    kdim = a.shape[-1]
    n = b.shape[-1]
    a2 = a.reshape(-1, kdim).to(torch.float32)
    b2 = b.to(torch.float32)
    m = a2.shape[0]
    grid, (bm_, bn_, bk_) = tile_grid(m, n, kdim, bm=bm, bn=bn, bk=bk)
    mode_map = torch.as_tensor(mode_map)
    expect = grid[:2] if mode_map.dim() == 2 else grid
    if mode_map.dim() not in (2, 3) or tuple(mode_map.shape) != expect:
        raise ValueError(
            f"mode_map shape {tuple(mode_map.shape)} != tile grid {expect} for "
            f"flattened matmul ({m}, {kdim}) @ ({kdim}, {n}) at blocks "
            f"({bm_}, {bn_}, {bk_})"
        )
    s = resolve_splits(splits, a2.device, m, n, kdim, bm=bm_, bn=bn_, bk=bk_, tk=k_step(kmax),
                       body=gemm_body(m, kmax))

    def run():
        if a2.is_cuda or b2.is_cuda:
            dev_map = mode_map.to(device=a2.device, dtype=torch.int32).contiguous()
            return _launch(a2.contiguous(), b2.contiguous(), dev_map, kmax, bm_, bn_, bk_, s)
        return tile_matmul_plain(a2, b2, mode_map, kmax=kmax, bm=bm_, bn=bn_, bk=bk_, splits=s)

    if oprecord.ACTIVE is None:
        out = run()
    else:
        # the map is data: charged at kmax's passes, the most it can run
        # (reading the map would cost a sync)
        flops, nbytes = oprecord.gemm_work(m, kdim, n, len(limb_product_terms(kmax)))
        out = oprecord.run_kernel("tile_matmul", run, (a2, b2, mode_map), flops=flops,
                                 nbytes=nbytes + mode_map.numel() * 4, dtype=torch.bfloat16)
    return out.reshape(*lead, n)


def _uniform_grid(a, b, bm, bn, bk) -> tuple[int, int]:
    lead_m = 1
    for d in a.shape[:-1]:
        lead_m *= d
    grid, _ = tile_grid(lead_m, b.shape[-1], a.shape[-1], bm=bm, bn=bn, bk=bk)
    return grid[:2]


def tile_matmul_mode(
    a: torch.Tensor,
    b: torch.Tensor,
    mode: Mode,
    *,
    rounding: str = "rne",
    bm: int = 128,
    bn: int = 128,
    bk: int = 512,
    splits: int | None = None,
) -> torch.Tensor:
    """Uniform static-mode tile matmul — bit-identical to
    ``limb_matmul(k=MODE_LIMBS[mode])`` at the same blocks (kmax is set to
    the mode's limb count, so the executed passes, their order, and the GRTE
    pre-pass width all coincide with the uniform kernel)."""
    mode = Mode(mode)
    if mode not in F32_MODES:
        raise ValueError(f"tile impl supports the f32 ladder {F32_MODES}, got {mode!r}")
    k = MODE_LIMBS[mode]
    mode_map = torch.full(_uniform_grid(a, b, bm, bn, bk), k, dtype=torch.int32,
                          device=a.device)
    return tile_matmul(a, b, mode_map, kmax=k, rounding=rounding, bm=bm, bn=bn, bk=bk,
                       splits=splits)


def tile_matmul_runtime(
    a: torch.Tensor,
    b: torch.Tensor,
    mode_scalar,
    *,
    rounding: str = "rne",
    bm: int = 128,
    bn: int = 128,
    bk: int = 512,
    splits: int | None = None,
) -> torch.Tensor:
    """Run-time reconfigurable tile matmul: an f32-ladder mode — a host int
    (e.g. one entry of ``repro_torch.adapt``'s ModeTable) or a device int32
    scalar (e.g. from ``auto_mode``) — broadcast into a uniform map.

    One launch of the same kernel at every mode; the mode never leaves the
    side it is on (no ``.item()``), and changing it builds nothing.
    """
    shape = _uniform_grid(a, b, bm, bn, bk)
    if isinstance(mode_scalar, torch.Tensor):
        k = torch.clamp(mode_scalar.to(device=a.device, dtype=torch.int32), 1, F32_KMAX)
        mode_map = torch.ones(shape, dtype=torch.int32, device=a.device) * k
    else:
        k = min(max(int(mode_scalar), 1), F32_KMAX)
        mode_map = torch.full(shape, k, dtype=torch.int32, device=a.device)
    return tile_matmul(a, b, mode_map, kmax=F32_KMAX, rounding=rounding,
                       bm=bm, bn=bn, bk=bk, splits=splits)


def tile_matmul_auto(
    a: torch.Tensor,
    b: torch.Tensor,
    budget: float,
    *,
    relative: bool = True,
    per_k: bool = False,
    max_mode: Mode = Mode.M24,
    rounding: str = "rne",
    bm: int = 128,
    bn: int = 128,
    bk: int = 512,
) -> torch.Tensor:
    """Magnitude-statistics tile matmul: per-tile operand abs-max picks the
    cheapest mode meeting the per-tile error ``budget`` (see
    ``tile_policy.magnitude_map``), then one launch runs the map."""
    from repro_torch.kernels.tile_matmul.tile_policy import magnitude_map

    mode_map = magnitude_map(
        a, b, budget, relative=relative, per_k=per_k, max_mode=max_mode,
        bm=bm, bn=bn, bk=bk,
    )
    return tile_matmul(
        a, b, mode_map, kmax=MODE_LIMBS[Mode(max_mode)], rounding=rounding,
        bm=bm, bn=bn, bk=bk,
    )
