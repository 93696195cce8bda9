"""NumPy oracle for the quantize_mantissa kernel (independent of core)."""
from __future__ import annotations

import numpy as np


def quantize_mantissa_ref(x: np.ndarray, keep: int, rounding: str = "grte") -> np.ndarray:
    """NumPy bit-level reference (scalar loop semantics, vectorized)."""
    x = np.asarray(x, np.float32)
    if keep >= 23:
        return x
    drop = 23 - keep
    xi = x.view(np.uint32)
    lsb_unit = np.uint32(1 << drop)
    kept = xi & ~np.uint32(lsb_unit - 1)
    if rounding == "trunc":
        qi = kept
    elif rounding == "grte":
        g = (xi >> (drop - 1)) & 1
        r = (xi >> (drop - 2)) & 1 if drop >= 2 else np.zeros_like(xi)
        e = (xi >> (drop - 3)) & 1 if drop >= 3 else np.zeros_like(xi)
        t = (
            ((xi & np.uint32((1 << (drop - 3)) - 1)) != 0).astype(np.uint32)
            if drop >= 4
            else np.zeros_like(xi)
        )
        qi = kept + (g & (r | t | e)) * lsb_unit
    elif rounding == "rne":
        g = (xi >> (drop - 1)) & 1
        rest = ((xi & np.uint32((1 << (drop - 1)) - 1)) != 0).astype(np.uint32)
        lsb = (xi >> drop) & 1
        qi = kept + (g & (rest | lsb)) * lsb_unit
    else:
        raise ValueError(rounding)
    q = qi.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(x), q, x)
