"""Wrapper, plain version and launch path of the quantize_mantissa kernel.

The CUDA kernel (``csrc/quantize_mantissa.cu``) replaces the TPU kernel
``quantize_mantissa_pallas``.  ``quantize_mantissa_op`` launches it for a
CUDA tensor and runs ``quantize_mantissa_plain`` — the same function in
plain PyTorch — only for a CPU tensor.  The two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.rounding import _ROUNDINGS, quantize_mantissa
from repro_torch.kernels import build

_ROUNDING_CODE = {"trunc": 0, "grte": 1, "rne": 2}


def quantize_mantissa_plain(x: torch.Tensor, keep: int, rounding: str = "grte") -> torch.Tensor:
    """Plain PyTorch version of the kernel: bit ops on the int32 view."""
    if keep >= 23:
        return x
    return quantize_mantissa(x.to(torch.float32), keep, rounding)


def _launch(x: torch.Tensor, keep: int, rounding: str) -> torch.Tensor:
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(
            "quantize_mantissa kernel takes a contiguous float32 CUDA tensor, "
            f"got {x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    out = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.rmpm_quantize_mantissa(
            x.data_ptr(), out.data_ptr(), x.numel(), keep,
            _ROUNDING_CODE[rounding], build.current_stream_ptr())
    build.check_launch(lib, code, "quantize_mantissa")
    build.LAUNCHES["quantize_mantissa"] += 1
    return out


def quantize_mantissa_op(x: torch.Tensor, keep: int, rounding: str = "grte") -> torch.Tensor:
    """Quantize the mantissa of an arbitrary-shape f32 tensor to ``keep``
    explicit bits with the selected rounding (trunc | rne | grte).
    ``keep`` must be >= 1 (values below would reach into the exponent/sign
    fields); ``keep >= 23`` is the identity.  Raises under autograd
    (``build.refuse_autograd``)."""
    build.refuse_autograd("quantize_mantissa", x)
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    if rounding not in _ROUNDINGS:
        raise ValueError(f"rounding must be one of {_ROUNDINGS}, got {rounding!r}")
    if keep >= 23:
        return x
    if x.is_cuda:
        if x.numel() == 0:
            return x.to(torch.float32)
        return _launch(x.to(torch.float32).contiguous(), keep, rounding)
    return quantize_mantissa_plain(x, keep, rounding)
