"""Wrapper, plain version and launch path of the limb_matmul kernel.

The CUDA kernel (``csrc/limb_matmul.cu``) replaces the TPU kernel
``limb_matmul_pallas``.  ``limb_matmul`` launches it for CUDA tensors and
runs ``limb_matmul_plain`` — the same limb algebra as separate PyTorch
products — only for CPU tensors.

``(bm, bn, bk)`` is the granularity of the mode-map grid (see
``kernels.blocking``); the limb kernel has no map but walks K in the same
``bk`` slabs as the mode-map kernel, which is what makes a uniform map
bit-identical to this kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.limb import limb_product_terms
from repro_torch.kernels import build
from repro_torch.kernels.blocking import ceil_to, clamp_block

DEFAULT_BLOCK = (128, 128, 512)


def tile_grid(
    m: int, n: int, kdim: int, *, bm: int = 128, bn: int = 128, bk: int = 512
) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """Clamp blocks to the (flattened) problem shape and return
    ``((gm, gn, gk), (bm, bn, bk))`` — the mode-map grid is ``(gm, gn)`` or
    ``(gm, gn, gk)``.  The single source of truth for map shapes."""
    bm_, bn_, bk_ = clamp_block(bm, m), clamp_block(bn, n), clamp_block(bk, kdim)
    grid = (ceil_to(m, bm_) // bm_, ceil_to(n, bn_) // bn_, ceil_to(kdim, bk_) // bk_)
    return grid, (bm_, bn_, bk_)


def extract_limbs(x: torch.Tensor, k: int) -> list[torch.Tensor]:
    """k bf16 limbs of an f32 tensor, returned upcast to f32 (exact): a
    PyTorch product of bf16 inputs would round its result to bf16."""
    out, r = [], x
    for _ in range(k):
        li = r.to(torch.bfloat16).to(torch.float32)
        out.append(li)
        r = r - li
    return out


def limb_matmul_plain(a: torch.Tensor, b: torch.Tensor, k: int = 3, *,
                      bk: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a (M, K) f32 @ b (K, N) f32 at
    k-limb precision.  K is walked in ``bk`` slabs and, inside a slab, the
    retained terms are added high order first into one f32 accumulator."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, kdim = a.shape
    n = b.shape[1]
    bk_ = clamp_block(bk, kdim)
    al, bl = extract_limbs(a, k), extract_limbs(b, k)
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for k0 in range(0, kdim, bk_):
        for i, j in limb_product_terms(k):
            acc = acc + al[i][:, k0:k0 + bk_] @ bl[j][k0:k0 + bk_, :]
    return acc


def check_gemm_operands(a2: torch.Tensor, b2: torch.Tensor, what: str) -> None:
    for name, t in (("a", a2), ("b", b2)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 2:
            raise ValueError(
                f"{what} kernel takes contiguous 2-D float32 CUDA tensors; "
                f"{name} is {tuple(t.shape)} {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if a2.device != b2.device:
        raise ValueError(f"{what}: operands on {a2.device} and {b2.device}")
    if a2.shape[1] != b2.shape[0]:
        raise ValueError(f"{what}: contraction mismatch {tuple(a2.shape)} @ {tuple(b2.shape)}")


def _launch(a2: torch.Tensor, b2: torch.Tensor, k: int, bm: int, bn: int, bk: int) -> torch.Tensor:
    check_gemm_operands(a2, b2, "limb_matmul")
    if not 1 <= k <= 6:
        raise ValueError(f"limb_matmul kernel supports 1..6 limbs, got {k}")
    m, kdim = a2.shape
    n = b2.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a2.device)
    lib = build.library()
    with torch.cuda.device(a2.device):
        code = lib.rmpm_limb_matmul(
            a2.data_ptr(), b2.data_ptr(), out.data_ptr(), m, n, kdim, k,
            bm, bn, bk, build.current_stream_ptr())
    build.check_launch(lib, code, "limb_matmul")
    build.LAUNCHES["limb_matmul"] += 1
    return out


def limb_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    k: int = 3,
    *,
    rounding: str = "rne",
    bm: int = 128,
    bn: int = 128,
    bk: int = 512,
) -> torch.Tensor:
    """Multi-precision matmul a (..., K) @ b (K, N) via the fused kernel.

    Only RNE limb extraction is fused; the paper's GRTE rounding runs
    through kernels/quantize_mantissa first.  Leading dims of ``a`` are
    flattened; bf16 inputs are accepted."""
    if rounding != "rne":
        from repro_torch.kernels.quantize_mantissa.ops import quantize_mantissa_op

        a = quantize_mantissa_op(a, 8 * k - 1, rounding)
        b = quantize_mantissa_op(b, 8 * k - 1, rounding)
    lead = a.shape[:-1]
    kdim = a.shape[-1]
    n = b.shape[-1]
    a2 = a.reshape(-1, kdim).to(torch.float32)
    b2 = b.to(torch.float32)
    m = a2.shape[0]
    _, (bm_, bn_, bk_) = tile_grid(m, n, kdim, bm=bm, bn=bn, bk=bk)
    if a2.is_cuda or b2.is_cuda:
        if m == 0:
            return torch.zeros((*lead, n), dtype=torch.float32, device=a2.device)
        out = _launch(a2.contiguous(), b2.contiguous(), k, bm_, bn_, bk_)
    else:
        out = limb_matmul_plain(a2, b2, k, bk=bk_)
    return out.reshape(*lead, n)
