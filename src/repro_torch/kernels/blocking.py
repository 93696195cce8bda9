"""Shared blocking arithmetic for the kernel wrappers.

In the port ``(bm, bn, bk)`` has ONE meaning: the granularity of the
per-tile mode map (and of the K slabs a 3-D map addresses).  The CUDA
kernels choose their own thread-block tile inside a map tile and mask ragged
edges themselves, so nothing is padded in device memory; ``pad_to_block`` is
kept for the plain versions and the map builders, which reason in whole
tiles.  The arithmetic matches the reference bit for bit so that maps built
for one package have the shapes the other expects.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Map-tile quantum: a clamped block is the dim rounded up to a multiple of 8
# (kept equal to the reference's value so map shapes agree).
BLOCK_QUANTUM = 8


def ceil_to(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return -(-x // m) * m


def clamp_block(block: int, dim: int, quantum: int = BLOCK_QUANTUM) -> int:
    """Largest useful block for a dim: the requested ``block`` when the dim
    fills it, else the dim rounded up to the tiling quantum
    (``clamp_block(128, 1) == 8``)."""
    if dim >= block:
        return block
    return ceil_to(max(dim, 1), quantum)


def pad_to_block(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """Zero-pad a 2D tensor up to multiples of ``(bm, bn)``.

    Zero padding is exact for every op in this package: padded rows/cols
    contribute ``x + 0.0 == x`` to f32 accumulation and quantize to zero.
    """
    m, n = x.shape
    return F.pad(x, (0, ceil_to(n, bn) - n, 0, ceil_to(m, bm) - m))
