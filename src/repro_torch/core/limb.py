"""bf16 limb decomposition — the analogue of the paper's Karatsuba split.

A float is expanded into a sum of bf16 "limbs", each carrying the next ~8
significand bits (the tensor cores' bf16 quantum):

    x = x0 + x1 + ... + x_{k-1} + r_k,   x_i = bf16(x - sum_{j<i} x_j)

For f32 input, 3 limbs reconstruct exactly (24-bit significand) over the
normal range.  Modes beyond 24 bits take DoubleF32 (hi, lo) operands: the hi
word contributes the first 3 limbs, the lo word the rest — mirroring how the
paper feeds 52-bit mantissas through an 8-bit leaf multiplier.

Optionally, limbs can be extracted with the paper's G&(R|T|E) rounding (C3)
instead of the hardware round-to-nearest-even cast.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import DoubleF32
from repro_torch.core.rounding import quantize_mantissa


def _to_bf16(x: torch.Tensor, rounding: str) -> torch.Tensor:
    if rounding == "rne":
        return x.to(torch.bfloat16)
    # Paper-faithful rounding: quantize the f32 mantissa to bf16's 7 explicit
    # bits with the selected scheme, then the bf16 cast is exact.
    return quantize_mantissa(x, 7, rounding).to(torch.bfloat16)


def split_limbs(x, k: int, rounding: str = "rne") -> torch.Tensor:
    """Split ``x`` (f32 tensor or DoubleF32) into ``k`` bf16 limbs.

    Returns a (k, *x.shape) bf16 tensor with x ~= sum_i limbs[i] (the limbs
    of ``split_limbs_f32``, cast back: exact).
    """
    return torch.stack([li.to(torch.bfloat16) for li in split_limbs_f32(x, k, rounding)])


def split_limbs_f32(x, k: int, rounding: str = "rne") -> list[torch.Tensor]:
    """Split ``x`` (f32 tensor or DoubleF32) into ``k`` bf16 limbs, each
    returned upcast to float32 (exact): the form the limb algebra
    multiplies.  The limbs are made one at a time and the residual is
    updated in place, so a large operand (a logits weight of 4096 x 256000)
    holds at most its f32 limbs, one residual and one bf16 limb at once."""
    if isinstance(x, DoubleF32):
        hi, lo = x.hi.to(torch.float32), x.lo.to(torch.float32)
    else:
        hi, lo = x.to(torch.float32), None
    limbs = []
    r = hi
    for i in range(k):
        if lo is not None and i == 3:
            # hi's 24 significand bits are exhausted after 3 limbs; inject lo.
            # (The residual r is ~0 here; adding first keeps any leftovers.)
            r = r + lo
            lo = None
        b = _to_bf16(r, rounding)
        if i + 1 == k:
            r = None  # the last residual is not needed: free it first
        li = b.to(torch.float32)
        del b
        limbs.append(li)
        if r is not None:
            # the first subtraction makes a new tensor (``r`` may be the
            # caller's operand); the later ones reuse it
            r = r - li if r is hi else r.sub_(li)
    return limbs


def _split_limbs_bf16(x, k: int, rounding: str = "rne") -> list[torch.Tensor]:
    """The k bf16 limbs of ``x`` made as the reference makes them
    (``li = bf16(r); r = r - f32(li)``), for a graph that autograd walks."""
    if isinstance(x, DoubleF32):
        hi, lo = x.hi.to(torch.float32), x.lo.to(torch.float32)
    else:
        hi, lo = x.to(torch.float32), None
    limbs = []
    r = hi
    for i in range(k):
        if lo is not None and i == 3:
            r = r + lo
            lo = None
        li = _to_bf16(r, rounding)
        limbs.append(li)
        if i + 1 < k:
            r = r - li.to(torch.float32)
    return limbs


def _differentiated(x) -> bool:
    parts = (x.hi, x.lo) if isinstance(x, DoubleF32) else (x,)
    return torch.is_grad_enabled() and any(
        isinstance(p, torch.Tensor) and p.requires_grad for p in parts)


def limb_operands(x, k: int, rounding: str = "rne"):
    """``x``'s k limbs as the limb products' f32 operands: ``limb(i)``
    gives limb ``i`` for one product.

    Without autograd these are ``split_limbs_f32``'s limbs, shared by every
    product.  Under autograd (grad enabled and ``x`` requires grad) the bf16
    limbs are the graph's nodes and each product gets its own f32 cast, so
    each product's cotangent is rounded to bf16 at its cast and a limb's
    cotangents are summed in bf16: the casts of the reference, whose
    products take bf16 limbs and whose gradients (``jax.grad`` of the limb
    algebra) are the oracle.  The forward values are the same either way."""
    if _differentiated(x):
        limbs = _split_limbs_bf16(x, k, rounding)
        return lambda i: limbs[i].to(torch.float32)
    return split_limbs_f32(x, k, rounding).__getitem__


def reconstruct(limbs: torch.Tensor) -> torch.Tensor:
    """Sum limbs back to f32 (low-order first for accuracy)."""
    acc = torch.zeros(limbs.shape[1:], dtype=torch.float32, device=limbs.device)
    for i in range(limbs.shape[0] - 1, -1, -1):
        acc = acc + limbs[i].to(torch.float32)
    return acc


def limb_product_terms(k: int) -> list[tuple[int, int]]:
    """Retained Karatsuba cross products for a k-limb multiply: all (i, j)
    with i + j < k, ordered high-order-first (smallest magnitude first) so the
    f32 accumulation loses the least (paper section 3.3.5.3 economy: terms with
    i + j >= k fall entirely below the kept mantissa and are dropped)."""
    terms = [(i, j) for i in range(k) for j in range(k) if i + j < k]
    terms.sort(key=lambda ij: -(ij[0] + ij[1]))
    return terms
