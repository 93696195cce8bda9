"""Precision modes for the run-time-reconfigurable multi-precision matmul.

Paper mapping (Arish & Sharma 2017, Table 1):

    paper mode 1 (000) auto            -> Mode.AUTO   (operand probe, C2)
    paper mode 2 (001) 8-bit mantissa  -> Mode.M8     (1 bf16 limb,  1 pass)
    paper mode 3 (010) 16-bit          -> Mode.M16    (2 limbs,      3 passes)
    paper mode 4 (011) 23-bit (single) -> Mode.M24    (3 limbs,      6 passes)
    paper mode 5 (100) 36-bit          -> Mode.M32    (4 limbs,     10 passes)
    paper mode 6 (101) 52-bit (double) -> Mode.M48    (6 limbs,     21 passes)

The tensor cores' multiply quantum used here is the bf16 8-bit significand,
so the paper's mantissa ladder is quantized to limb multiples.  Modes >= M32
take DoubleF32 (hi, lo) operands.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch


class Mode(enum.IntEnum):
    """Precision mode select (the paper's 3 mode-select bits)."""

    AUTO = 0
    M8 = 1
    M16 = 2
    M24 = 3
    M32 = 4
    M48 = 5


# Number of bf16 limbs per mode.
MODE_LIMBS: dict[Mode, int] = {
    Mode.M8: 1,
    Mode.M16: 2,
    Mode.M24: 3,
    Mode.M32: 4,
    Mode.M48: 6,
}

# Effective significand bits carried per mode (8 bits per limb).
MODE_BITS: dict[Mode, int] = {m: 8 * k for m, k in MODE_LIMBS.items()}

# Tensor-core passes = retained Karatsuba cross products: |{(i,j): i+j<k}|.
MODE_PASSES: dict[Mode, int] = {m: k * (k + 1) // 2 for m, k in MODE_LIMBS.items()}

# Modes that operate on plain f32 operands (runtime-switchable set).
F32_MODES = (Mode.M8, Mode.M16, Mode.M24)
# Modes that require DoubleF32 operands.
DF32_MODES = (Mode.M32, Mode.M48)


class DoubleF32(NamedTuple):
    """Unevaluated hi+lo f32 pair (Dekker / double-double style).

    value == hi + lo with |lo| <= ulp(hi)/2: the stand-in for the paper's
    52-bit-mantissa double-precision operands.
    """

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    def value_f64(self) -> torch.Tensor:  # oracle-side only
        return self.hi.to(torch.float64) + self.lo.to(torch.float64)


def df32_from_f64(x) -> DoubleF32:
    """Split a float64 tensor into a DoubleF32 pair (test/oracle helper)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return DoubleF32(hi, lo)


def df32_from_f32(x: torch.Tensor) -> DoubleF32:
    x = x.to(torch.float32)
    return DoubleF32(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Carried alongside operands; the software analogue of the paper's
    67-bit bus format (3 mode bits prepended to the IEEE word)."""

    mode: Mode = Mode.M24
    rounding: str = "rne"  # 'rne' | 'grte' | 'trunc'  (C3)
    auto_tol: float = 0.0  # relative tolerance for auto-mode probe

    @property
    def limbs(self) -> int:
        return MODE_LIMBS[self.mode]


def classify(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """Exception signals of the paper's multiplier output port:
    zero / infinity / NaN / denormal (per-element booleans).

    Bit-level (exponent==0 / all-ones) so flush-to-zero backends cannot hide
    denormals — mirrors the paper's exponent+significand field tests.
    """
    xi = x.to(torch.float32).contiguous().view(torch.int32)
    exp = (xi >> 23) & 0xFF
    mant = xi & 0x7FFFFF
    return {
        "zero": (exp == 0) & (mant == 0),
        "infinity": (exp == 0xFF) & (mant == 0),
        "nan": (exp == 0xFF) & (mant != 0),
        "denormal": (exp == 0) & (mant != 0),
    }


def mode_mismatch_error(mode_a, mode_b) -> torch.Tensor:
    """Paper section 3.3.1: operands carrying different mode-select bits raise
    the mode-select-error signal."""
    return torch.as_tensor(mode_a) != torch.as_tensor(mode_b)


# ---------------------------------------------------------------------------
# Auto-mode (C2): operand limb-occupancy probe.
# ---------------------------------------------------------------------------


def _limbs_needed(x: torch.Tensor, max_limbs: int, tol: float) -> torch.Tensor:
    """Smallest k such that the k-limb bf16 expansion reconstructs ``x`` to
    within ``tol * max|x|`` (the paper's trailing-zero count, Fig 7):
    integer-valued / low-precision data needs fewer limbs."""
    r = x.to(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    scale = torch.clamp(r.abs().max(), min=tiny)
    n_ok = torch.zeros((), dtype=torch.int32, device=r.device)
    for _ in range(max_limbs):
        limb = r.to(torch.bfloat16).to(torch.float32)
        r = r - limb
        ok = r.abs().max() <= tol * scale
        n_ok = n_ok + ok.to(torch.int32)
    return torch.clamp(max_limbs - n_ok + 1, 1, max_limbs)


def auto_mode(a: torch.Tensor, b: torch.Tensor, tol: float = 0.0,
              max_mode: Mode = Mode.M24) -> torch.Tensor:
    """Runtime mode selection from operand contents (paper mode 1).

    Returns an int32 scalar tensor in {1..max_mode}, on the operands' device
    (no host sync: the tile kernel takes it as data).
    """
    max_limbs = MODE_LIMBS[Mode(max_mode)]
    ka = _limbs_needed(a, max_limbs, tol)
    kb = _limbs_needed(b, max_limbs, tol)
    k = torch.maximum(ka, kb)
    # limb count -> mode index (1,2,3 limbs -> M8,M16,M24; 4->M32; 6->M48)
    k_to_mode = torch.tensor([0, 1, 2, 3, 4, 5, 5], dtype=torch.int32,
                             device=k.device)
    return k_to_mode[torch.clamp(k, 1, 6).long()]
