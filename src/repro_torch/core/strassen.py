"""Strassen top-down block matmul (paper C4, section 3.1).

The paper's recommended *top-down* organisation — Strassen as the external
algorithm over 2x2 block partitions, the classical multiply as the internal
(leaf) algorithm: recursive 2x2 block split, 7 block products per level (vs
8 classical), leaves dispatched to the RMPM limb engine.  Each level scales
matmul FLOPs by 7/8 in exchange for O(n^2) extra adds and working set.

Note: the paper's Eq. (3) contains a typo (p11 appears twice); we use the
standard Strassen combination with p22 = S1 - S2 + S3 + S6.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
LeafFn = Callable[[Tensor, Tensor], Tensor]


def _default_leaf(a: Tensor, b: Tensor) -> Tensor:
    return a.to(torch.float32) @ b.to(torch.float32)


def _pad_to(x: Tensor, rows: int, cols: int) -> Tensor:
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    if pr == 0 and pc == 0:
        return x
    return F.pad(x, (0, pc, 0, pr))


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _strassen(a: Tensor, b: Tensor, depth: int, leaf_fn: LeafFn) -> Tensor:
    if depth == 0:
        return leaf_fn(a, b)
    m, k = a.shape
    _, n = b.shape
    mh, kh, nh = m // 2, k // 2, n // 2
    a11, a12 = a[:mh, :kh], a[:mh, kh:]
    a21, a22 = a[mh:, :kh], a[mh:, kh:]
    b11, b12 = b[:kh, :nh], b[:kh, nh:]
    b21, b22 = b[kh:, :nh], b[kh:, nh:]

    def rec(x, y):
        return _strassen(x, y, depth - 1, leaf_fn)

    # Paper Eq. (2): the seven partial products S1..S7.
    s1 = rec(a11 + a22, b11 + b22)
    s2 = rec(a21 + a22, b11)
    s3 = rec(a11, b12 - b22)
    s4 = rec(a22, b21 - b11)
    s5 = rec(a11 + a12, b22)
    s6 = rec(a21 - a11, b11 + b12)
    s7 = rec(a12 - a22, b21 + b22)
    # Paper Eq. (3) (typo-corrected).
    c11 = s1 + s4 - s5 + s7
    c12 = s3 + s5
    c21 = s2 + s4
    c22 = s1 - s2 + s3 + s6
    return torch.cat([torch.cat([c11, c12], dim=1), torch.cat([c21, c22], dim=1)], dim=0)


def strassen_matmul(
    a: Tensor,
    b: Tensor,
    depth: int = 1,
    leaf_fn: LeafFn | None = None,
    align: int = 128,
) -> Tensor:
    """Strassen block matmul a (M, K) @ b (K, N) with ``depth`` recursion
    levels (7^depth leaf products).  Operands are zero-padded so every leaf is
    a multiple of ``align`` — padding preserves the product.
    """
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("strassen_matmul is 2D; flatten leading dims first")
    if depth < 0:
        raise ValueError("depth must be >= 0")
    leaf_fn = leaf_fn or _default_leaf
    if depth == 0:
        return leaf_fn(a, b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} @ {tuple(b.shape)}")
    unit = align * (2**depth)
    mp_, kp, np_ = _ceil_to(m, unit), _ceil_to(k, unit), _ceil_to(n, unit)
    ap = _pad_to(a.to(torch.float32), mp_, kp)
    bp = _pad_to(b.to(torch.float32), kp, np_)
    out = _strassen(ap, bp, depth, leaf_fn)
    return out[:m, :n]


def leaf_products(depth: int) -> int:
    """Number of leaf matmuls: 7^depth (classical recursion would be 8^depth)."""
    return 7**depth


def flops_ratio(depth: int) -> float:
    """Matmul-FLOP ratio vs classical: (7/8)^depth."""
    return (7.0 / 8.0) ** depth
