"""Oracle for the limb_matmul kernel.

Deliberately written from scratch (NOT importing core.rmpm or the wrapper)
so kernel tests check against an independent formulation of the same
arithmetic: whole-K products per term, no slabs.
"""
from __future__ import annotations

import torch


def limb_matmul_ref(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """a (M, K) f32 @ b (K, N) f32 at k bf16-limb precision -> (M, N) f32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)

    def limbs(x):
        out, r = [], x
        for _ in range(k):
            li = r.to(torch.bfloat16)
            out.append(li)
            r = r - li.to(torch.float32)
        return out

    al, bl = limbs(a), limbs(b)
    terms = sorted(
        [(i, j) for i in range(k) for j in range(k) if i + j < k],
        key=lambda ij: -(ij[0] + ij[1]),
    )
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for i, j in terms:
        acc = acc + al[i].to(torch.float32) @ bl[j].to(torch.float32)
    return acc
