"""Loop oracle for the tile_matmul kernel.

Deliberately written from scratch (NOT importing the wrapper or core.rmpm):
it materializes each (bm, bn) output tile independently at its mapped limb
count, against the contraction split into bk slabs — an independent
formulation of the same per-tile arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch


def tile_matmul_ref(a, b, mode_map, *, bm: int, bn: int, bk: int) -> torch.Tensor:
    """a (M, K) f32 @ b (K, N) f32 (block multiples) with per-tile limb
    counts from ``mode_map`` ((gm, gn) or (gm, gn, gk) ints)."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    mode_map = np.asarray(mode_map)
    m, kdim = a.shape
    n = b.shape[1]
    assert m % bm == 0 and n % bn == 0 and kdim % bk == 0
    gk = kdim // bk

    def limbs(x, k):
        out, r = [], x
        for _ in range(k):
            li = r.to(torch.bfloat16)
            out.append(li.to(torch.float32))
            r = r - li.to(torch.float32)
        return out

    out = torch.zeros((m, n), dtype=torch.float32)
    for i in range(m // bm):
        for j in range(n // bn):
            acc = torch.zeros((bm, bn), dtype=torch.float32)
            for kk in range(gk):
                k_tile = int(mode_map[i, j, kk] if mode_map.ndim == 3 else mode_map[i, j])
                at = a[i * bm:(i + 1) * bm, kk * bk:(kk + 1) * bk]
                bt = b[kk * bk:(kk + 1) * bk, j * bn:(j + 1) * bn]
                al, bl = limbs(at, k_tile), limbs(bt, k_tile)
                terms = sorted(
                    [(ti, tj) for ti in range(k_tile) for tj in range(k_tile)
                     if ti + tj < k_tile],
                    key=lambda ij: -(ij[0] + ij[1]),
                )
                for ti, tj in terms:
                    acc = acc + al[ti] @ bl[tj]
            out[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] = acc
    return out
