"""Mode-map construction for the mode-map tile_matmul kernel.

Three map sources, coarsest to finest:

* ``uniform_map``   — constant map from a static Mode: whole-matmul
  granularity, bit-exact with ``mp_matmul(impl="pallas")``.
* ``table_map``     — a per-site mode (host int or device int32 scalar, e.g.
  from ``repro_torch.adapt``'s ModeTable) broadcast into a map.  The map is
  data, so per-tile values need no new build.
* ``magnitude_map`` — per-tile operand abs-max statistics pick the cheapest
  mode meeting a per-tile error budget, so one outlier-heavy tile no longer
  forces the entire matmul to the expensive mode.

``magnitude_map`` budget semantics: the worst-case absolute error of a tile
computed at mode m is bounded by ``eps_m * amax_tile(A) * amax_tile(B) * K``
(eps_m = the mode's relative-error ceiling from ``repro_torch.plan.cost``).
Each tile takes the cheapest mode whose bound fits the budget;
``relative=True`` (default) expresses the budget as a fraction of the global
magnitude envelope ``S = max_tile(amax_A) * max_tile(amax_B) * K``.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import F32_MODES, MODE_LIMBS, Mode
from repro_torch.kernels.blocking import pad_to_block
from repro_torch.kernels.tile_matmul.ops import tile_grid


def _f32_ladder_eps() -> list[tuple[int, float]]:
    """(limb count, relative-error ceiling) for the f32 ladder, cheap first."""
    from repro_torch.plan.cost import MODE_REL_ERROR  # lazy: kernels<->plan cycle

    return sorted((MODE_LIMBS[m], MODE_REL_ERROR[m]) for m in F32_MODES)


def _grid_for(shape_a, shape_b, bm, bn, bk) -> tuple[int, int, int]:
    lead_m = 1
    for d in shape_a[:-1]:
        lead_m *= d
    grid, _ = tile_grid(lead_m, shape_b[-1], shape_a[-1], bm=bm, bn=bn, bk=bk)
    return grid


def uniform_map(shape_a, shape_b, mode: Mode, *, per_k: bool = False,
                bm: int = 128, bn: int = 128, bk: int = 512,
                device="cpu") -> torch.Tensor:
    """Constant mode map for ``a @ b`` — the bit-exact-with-limb source."""
    mode = Mode(mode)
    if mode not in F32_MODES:
        raise ValueError(f"tile maps cover the f32 ladder {F32_MODES}, got {mode!r}")
    grid = _grid_for(shape_a, shape_b, bm, bn, bk)
    shape = grid if per_k else grid[:2]
    return torch.full(shape, MODE_LIMBS[mode], dtype=torch.int32, device=device)


def table_map(shape_a, shape_b, mode_scalar, *, per_k: bool = False,
              bm: int = 128, bn: int = 128, bk: int = 512,
              device="cpu") -> torch.Tensor:
    """Broadcast a per-site mode (host int or device scalar) into a tile
    map.  Values are clipped to the f32 ladder's limb range [1, 3]."""
    grid = _grid_for(shape_a, shape_b, bm, bn, bk)
    shape = grid if per_k else grid[:2]
    kmax = max(MODE_LIMBS[m] for m in F32_MODES)
    if isinstance(mode_scalar, torch.Tensor):
        k = torch.clamp(mode_scalar.to(torch.int32), 1, kmax)
        return torch.ones(shape, dtype=torch.int32, device=k.device) * k
    return torch.full(shape, min(max(int(mode_scalar), 1), kmax),
                      dtype=torch.int32, device=device)


def magnitude_map(a: torch.Tensor, b: torch.Tensor, budget: float, *,
                  relative: bool = True, per_k: bool = False,
                  max_mode: Mode = Mode.M24, bm: int = 128, bn: int = 128,
                  bk: int = 512) -> torch.Tensor:
    """Per-tile cheapest mode meeting the error budget (see module docs).

    Returns an int32 map of limb counts in [1, limbs(max_mode)]; tiles whose
    bound fits no cheaper mode fall back to ``max_mode``.
    """
    max_mode = Mode(max_mode)
    if max_mode not in F32_MODES:
        raise ValueError(f"max_mode must be on the f32 ladder, got {max_mode!r}")
    kdim = a.shape[-1]
    n = b.shape[-1]
    a2 = a.reshape(-1, kdim).to(torch.float32).abs()
    b2 = b.to(torch.float32).abs()
    m = a2.shape[0]
    grid, (bm_, bn_, bk_) = tile_grid(m, n, kdim, bm=bm, bn=bn, bk=bk)
    gm, gn, gk = grid
    # Per-(row-tile, k-slab) and per-(k-slab, col-tile) operand maxima.
    amax = pad_to_block(a2, bm_, bk_).reshape(gm, bm_, gk, bk_).amax(dim=(1, 3))
    bmax = pad_to_block(b2, bk_, bn_).reshape(gk, bk_, gn, bn_).amax(dim=(1, 3))
    if per_k:
        mag = amax[:, None, :] * bmax.t()[None, :, :] * bk_  # (gm, gn, gk)
    else:
        mag = amax.amax(dim=1)[:, None] * bmax.amax(dim=0)[None, :] * kdim  # (gm, gn)
    scale = amax.max() * bmax.max() * (bk_ if per_k else kdim)
    abs_budget = (budget * scale if relative
                  else torch.tensor(budget, dtype=torch.float32, device=mag.device))
    kmax = MODE_LIMBS[max_mode]
    mode = torch.full(mag.shape, kmax, dtype=torch.int32, device=mag.device)
    # Walk the ladder expensive -> cheap so the final value is the cheapest
    # mode whose worst-case bound eps * mag fits the budget.
    for limbs, eps in sorted(_f32_ladder_eps(), reverse=True):
        if limbs > kmax:
            continue
        mode = torch.where(eps * mag <= abs_budget,
                           torch.tensor(limbs, dtype=torch.int32, device=mag.device), mode)
    return mode


# The dispatch walker lives in repro_torch.analysis.dispatch; re-exported
# here, as the reference's tile_policy re-exports its own.
from repro_torch.analysis.dispatch import dispatch_stats  # noqa: E402,F401
