"""Bit-exact mantissa truncation + rounding (paper C3, section 3.3.4).

The paper truncates operands to the selected mantissa width *before*
multiplication and rounds with a 4-bit scheme:

    G = guard  (MSB of the dropped field)
    R = round  (next bit)
    E = extra  (next bit — the paper's addition over classic G/R/T)
    T = sticky (OR of all remaining dropped bits)

    rnd = G & (R | T | E)                                   (paper Eq. 10)

and adds ``rnd`` to the LSB of the kept mantissa (round-up scheme).  It is
implemented on the signed integer view of f32 / f64: two's-complement
and/or/add give the same bits as the unsigned arithmetic, and every shifted
value is masked to one bit, so arithmetic right shifts are harmless.
"""
from __future__ import annotations

import torch

_ROUNDINGS = ("trunc", "rne", "grte")


def _quantize_bits(xi: torch.Tensor, mant_bits: int, keep: int, rounding: str):
    """Quantize the significand of a float viewed as a (signed) integer.

    mant_bits: explicit mantissa field width of the format (23 for f32, 52
    for f64); keep: number of explicit mantissa bits to keep.
    """
    drop = mant_bits - keep
    if drop <= 0:
        return xi
    lsb_unit = 1 << drop  # one ULP of the kept format
    kept = xi & ~(lsb_unit - 1)

    if rounding == "trunc":
        return kept
    if rounding == "grte":
        g = (xi >> (drop - 1)) & 1
        r = (xi >> (drop - 2)) & 1 if drop >= 2 else torch.zeros_like(xi)
        e = (xi >> (drop - 3)) & 1 if drop >= 3 else torch.zeros_like(xi)
        if drop >= 4:
            t = ((xi & ((1 << (drop - 3)) - 1)) != 0).to(xi.dtype)
        else:
            t = torch.zeros_like(xi)
        rnd = g & (r | t | e)  # paper Eq. (10)
        return kept + rnd * lsb_unit
    if rounding == "rne":
        g = (xi >> (drop - 1)) & 1
        rest = ((xi & ((1 << (drop - 1)) - 1)) != 0).to(xi.dtype)
        lsb = (xi >> drop) & 1
        # a carry into the exponent field is the correct IEEE behaviour
        # (mantissa overflow renormalizes), so plain integer add works
        return kept + (g & (rest | lsb)) * lsb_unit
    raise ValueError(f"rounding must be one of {_ROUNDINGS}, got {rounding!r}")


def quantize_mantissa(x: torch.Tensor, keep_bits: int, rounding: str = "grte") -> torch.Tensor:
    """Reduce ``x`` to ``keep_bits`` explicit mantissa bits (sign/exponent
    unchanged) using the selected rounding scheme.  Plain tensor oracle for
    the CUDA kernel in ``kernels/quantize_mantissa``.
    """
    if rounding not in _ROUNDINGS:
        raise ValueError(f"rounding must be one of {_ROUNDINGS}, got {rounding!r}")
    if keep_bits < 1:
        # keep_bits <= 0 would make drop > mant_bits: the kept-mask and the
        # rounding carry then reach into the exponent and sign fields
        raise ValueError(f"keep_bits must be >= 1, got {keep_bits}")
    if x.dtype == torch.float32:
        xi = x.contiguous().view(torch.int32)
        out = _quantize_bits(xi, 23, min(keep_bits, 23), rounding).view(torch.float32)
    elif x.dtype == torch.float64:
        xi = x.contiguous().view(torch.int64)
        out = _quantize_bits(xi, 52, min(keep_bits, 52), rounding).view(torch.float64)
    else:
        raise TypeError(f"quantize_mantissa supports f32/f64, got {x.dtype}")
    # NaN/Inf have all-ones exponents; mantissa rounding could corrupt them
    # (Inf -> NaN or NaN payload change).  Pass specials through untouched.
    return torch.where(torch.isfinite(x), out, x)
