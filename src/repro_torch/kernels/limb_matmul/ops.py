"""Wrappers, plain versions and launch paths of the two limb kernels.

The CUDA kernel ``csrc/limb_matmul.cu`` replaces the TPU kernel
``limb_matmul_pallas``.  ``limb_matmul`` launches it for CUDA tensors and
runs ``limb_matmul_plain`` — the same limb algebra as separate PyTorch
products — only for CPU tensors.  Likewise ``csrc/limb_matmul_dd.cu``
replaces ``limb_matmul_dd_pallas``: ``limb_matmul_dd`` returns a (hi, lo)
double-f32 pair, from the kernel for CUDA tensors and from
``limb_matmul_dd_plain`` for CPU tensors.

``(bm, bn, bk)`` is the granularity of the mode-map grid (see
``kernels.blocking``); the limb kernel has no map but walks K in the same
``bk`` slabs as the mode-map kernel, which is what makes a uniform map
bit-identical to this kernel.

Split-K.  The kernels cut one thread block's K walk (``k_walk``: the steps
of ``k_step(k)`` inside each ``bk`` slab) into ``S`` contiguous ranges run
by separate thread blocks, and combine the partial results in the fixed
order s = 0..S-1: the limb and mode-map kernels add f32 partials
(``reduce_splits``), the double-f32 kernel folds (hi, lo) pairs with TwoSum
(``reduce_splits_dd``).  ``split_k`` picks S for the card; the wrappers take
``splits=`` only as an override for timing, and the plain versions take it
so they combine the same partials in the same order.

Two device bodies (``csrc/rmpm_gemm.cuh``) serve the limb and mode-map
kernels, chosen by M (``gemm_body``, the mirror of ``rmpm::use_skinny``):

* M <= ``SKINNY_M_MAX`` (16) at up to three limbs — every decode step — runs
  the weight-streaming body.  There the bound is the weight's bytes, by
  about 50x, and what held the tiled body off it was too few bytes in flight
  and a fixed cost per K step.  So it computes C^T = B^T A^T with
  ``mma.sync`` (swap-AB: weight columns on the MMA's 16-row side), streams
  raw f32 tiles through a ``cp.async`` ring of three stages (two K steps in
  flight, three blocks an SM), and peels limbs in registers with one barrier
  a step.
* Every other launch (M > 16, the limb kernel at 4-6 limbs, and the
  double-f32 kernel at every M) runs the tiled ``wmma`` body, which
  prefetches one K step into registers and peels it into limb planes in
  shared memory.  What bounds it at M > 16 is that fixed cost per K step and,
  for the double-f32 kernel, its TwoSum folds.  The double-f32 kernel loads
  and peels four consecutive elements a thread, with 16-byte loads where the
  operand's base pointer, row length and blocks allow them and 4-byte loads
  elsewhere (a sliced operand, K = 33); the skinny body copies the same way.
  The kernel decides that from the pointers it is given, so no caller can
  misalign it.

Both bodies fold each term's products into the f32 accumulator once per K
step of ``k_step(k)``, so the walk, the splits and the plain versions below
describe both; ``split_k`` sees the body's thread-block tile and residency
(``THREAD_TILE``, ``BLOCKS_PER_SM``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.limb import limb_product_terms
from repro_torch.kernels import build
from repro_torch.kernels.blocking import ceil_to, clamp_block
from repro_torch import oprecord

DEFAULT_BLOCK = (128, 128, 512)
#: the largest M the weight-streaming body serves (``rmpm::SKINNY_M_MAX``)
SKINNY_M_MAX = 16
#: thread-block tile (rows, cols) of each body: the tiled body's ``TM x TN``
#: and the weight-streaming body's ``SK_TM x SK_TN`` (``csrc/rmpm_gemm.cuh``)
THREAD_TILE = {"wide": (32, 32), "skinny": (16, 64)}
#: resident thread blocks per SM that ``split_k`` fills, by body: the tiled
#: body uses up to 255 registers x 128 threads, so two blocks fit an SM's
#: 65,536 registers; the skinny body's ring of 64.5 KB leaves room for three
#: in an SM's 228 KB of shared memory, and its launch bounds hold its
#: registers to what three blocks may use (``rmpm::SK_BLOCKS_PER_SM``)
BLOCKS_PER_SM = {"wide": 2, "skinny": 3}
#: the longest stretch of K one split sums into its f32 accumulators.  The
#: accumulation error grows with the stretch: unsplit at K = 33792 (the
#: command-r+ down projection, 4 x 33792 x 12288, k = 3) the limb kernel lay
#: 2.15e-6 of scale from the exact limb algebra on the H100, over the 2e-6
#: the reference holds its kernels to.  Longer walks are split so that no
#: split sums more than this (every shape of the earlier models has K <=
#: 12288 and keeps its split)
MAX_SPLIT_LEN = 16384


def tile_grid(
    m: int, n: int, kdim: int, *, bm: int = 128, bn: int = 128, bk: int = 512
) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """Clamp blocks to the (flattened) problem shape and return
    ``((gm, gn, gk), (bm, bn, bk))`` — the mode-map grid is ``(gm, gn)`` or
    ``(gm, gn, gk)``.  The single source of truth for map shapes."""
    bm_, bn_, bk_ = clamp_block(bm, m), clamp_block(bn, n), clamp_block(bk, kdim)
    grid = (ceil_to(m, bm_) // bm_, ceil_to(n, bn_) // bn_, ceil_to(kdim, bk_) // bk_)
    return grid, (bm_, bn_, bk_)


def k_step(k: int) -> int:
    """The CUDA kernels' K step at ``k`` limbs: ``Tiling<KMAX>::TK`` of
    ``csrc/rmpm_gemm.cuh`` (64 up to three limbs, 32 above)."""
    return 64 if k <= 3 else 32


def k_walk(kdim: int, bk: int, tk: int) -> list[tuple[int, int, int]]:
    """One thread block's K walk in order: ``(slab, k0, k_end)`` for each
    step of ``tk`` inside each ``bk`` slab (the last step of a slab, and the
    last slab, may be short)."""
    walk = []
    for kk, s0 in enumerate(range(0, kdim, bk)):
        s1 = min(s0 + bk, kdim)
        walk += [(kk, k0, min(k0 + tk, s1)) for k0 in range(s0, s1, tk)]
    return walk


def k_steps(kdim: int, bk: int, tk: int) -> int:
    """``len(k_walk(kdim, bk, tk))``, in closed form (``rmpm::k_steps``)."""
    gk = -(-kdim // bk)
    return (gk - 1) * -(-bk // tk) + -(-(kdim - (gk - 1) * bk) // tk)


def split_ranges(steps: int, splits: int) -> list[tuple[int, int]]:
    """Step range ``[t0, t1)`` of each split: ``[s*T//S, (s+1)*T//S)``."""
    return [(s * steps // splits, (s + 1) * steps // splits) for s in range(splits)]


def split_pieces(kdim: int, bk: int, tk: int, splits: int) -> list[list[tuple[int, int, int]]]:
    """For each split, its K pieces ``(slab, k0, k_end)``: its range of the
    walk with consecutive steps of one slab merged.  With one split the
    pieces are the ``bk`` slabs."""
    walk = k_walk(kdim, bk, tk)
    if not 1 <= splits <= max(len(walk), 1):
        raise ValueError(f"splits must lie in [1, {len(walk)}] (the K walk's steps), "
                         f"got {splits}")
    out = []
    for t0, t1 in split_ranges(len(walk), splits):
        pieces: list[tuple[int, int, int]] = []
        for kk, k0, k1 in walk[t0:t1]:
            if pieces and pieces[-1][0] == kk:
                pieces[-1] = (kk, pieces[-1][1], k1)
            else:
                pieces.append((kk, k0, k1))
        out.append(pieces)
    return out


def reduce_splits(parts: list[torch.Tensor]) -> torch.Tensor:
    """The partials added in the kernels' order: ((p0 + p1) + p2) + ..."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gemm_body(m: int, k: int) -> str:
    """The body a limb or mode-map launch of ``m`` rows at ``k`` limbs (kmax
    for the map) runs: ``"skinny"`` at M <= ``SKINNY_M_MAX`` and k <= 3,
    else ``"wide"`` (``rmpm::use_skinny``).  On the f32 ladder it depends on
    M only, so a uniform map and the limb kernel at the same M run one body.
    The double-f32 kernel always runs ``"wide"``."""
    return "skinny" if m <= SKINNY_M_MAX and k <= 3 else "wide"


def gemm_blocks(m: int, n: int, bm: int, bn: int, body: str = "wide") -> int:
    """Thread blocks of one split of the body's grid (``rmpm::gemm_grid``,
    ``rmpm::skinny_grid``) at the clamped blocks."""
    tm, tn = THREAD_TILE[body]
    return (-(-m // bm) * -(-bm // tm)) * (-(-n // bn) * -(-bn // tn))


def split_k(m: int, n: int, kdim: int, *, bm: int, bn: int, bk: int, tk: int,
            sms: int, body: str = "wide") -> int:
    """Number of K splits for the limb and mode-map kernels: enough to put
    about ``BLOCKS_PER_SM[body]`` thread blocks on each of ``sms`` SMs, and
    enough that no split sums more than ``MAX_SPLIT_LEN`` of K, never more
    than the walk has steps; 1 once the (M, N) grid alone has more blocks
    than the card holds and K is within ``MAX_SPLIT_LEN``.  Depends on the
    problem, the clamped blocks, the K step, the body (by M, ``gemm_body``)
    and the card only — never on the limb count, which keeps uniform map ==
    limb kernel and runtime == static bitwise."""
    want = max(BLOCKS_PER_SM[body] * sms // max(gemm_blocks(m, n, bm, bn, body), 1),
               -(-kdim // MAX_SPLIT_LEN))
    return max(1, min(want, k_steps(kdim, bk, tk)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resolve_splits(splits: int | None, device: torch.device, m: int, n: int, kdim: int, *,
                   bm: int, bn: int, bk: int, tk: int, body: str = "wide") -> int:
    """The S a wrapper runs at: ``splits`` when given (checked against the
    walk), else ``split_k`` for ``body`` on the card of a CUDA ``device``
    and 1 (the unsplit walk) for the CPU's plain versions."""
    steps = k_steps(kdim, bk, tk)
    if splits is None:
        if device.type != "cuda":
            return 1
        index = device.index if device.index is not None else torch.cuda.current_device()
        return split_k(m, n, kdim, bm=bm, bn=bn, bk=bk, tk=tk, sms=_sm_count(index),
                       body=body)
    if not 1 <= splits <= steps:
        raise ValueError(f"splits must lie in [1, {steps}] (the K walk's steps), got {splits}")
    return int(splits)


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
                      bk: int = 512, splits: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: a (M, K) f32 @ b (K, N) f32 at
    k-limb precision.  Each of ``splits`` splits walks its pieces of K
    (``split_pieces``; one split: the ``bk`` slabs) and adds the retained
    terms, high order first, into its own f32 partial; the partials are
    added in split order."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, kdim = a.shape
    n = b.shape[1]
    bk_ = clamp_block(bk, kdim)
    al, bl = extract_limbs(a, k), extract_limbs(b, k)
    parts = []
    for pieces in split_pieces(kdim, bk_, k_step(k), splits):
        acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
        for _, k0, k1 in pieces:
            for i, j in limb_product_terms(k):
                acc = acc + al[i][:, k0:k1] @ bl[j][k0:k1, :]
        parts.append(acc)
    return reduce_splits(parts)


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


def split_workspace(splits: int, m: int, n: int, device: torch.device) -> torch.Tensor | None:
    """The [S, M, N] f32 partial tiles of a split launch (None unsplit)."""
    if splits == 1:
        return None
    return torch.empty((splits, m, n), dtype=torch.float32, device=device)


def _launch(a2: torch.Tensor, b2: torch.Tensor, k: int, bm: int, bn: int, bk: int,
            splits: int) -> torch.Tensor:
    check_gemm_operands(a2, b2, "limb_matmul")
    if not 1 <= k <= 6:
        raise ValueError(f"limb_matmul kernel supports 1..6 limbs, got {k}")
    m, kdim = a2.shape
    n = b2.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a2.device)
    ws = split_workspace(splits, m, n, a2.device)
    lib = build.library()
    with torch.cuda.device(a2.device):
        build.prepare_device(lib)
        code = lib.rmpm_limb_matmul(
            a2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, kdim, k,
            bm, bn, bk, splits, build.current_stream_ptr())
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
    splits: int | None = None,
) -> torch.Tensor:
    """Multi-precision matmul a (..., K) @ b (K, N) via the fused kernel.

    Only RNE limb extraction is fused; the paper's GRTE rounding runs
    through kernels/quantize_mantissa first.  Leading dims of ``a`` are
    flattened; bf16 inputs are accepted.  ``splits`` overrides the K split
    count (``None``: ``split_k`` on the card, 1 on the CPU); it exists for
    timing the layouts side by side.  Raises under autograd
    (``build.refuse_autograd``)."""
    build.refuse_autograd("limb_matmul", a, b)
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
    if (a2.is_cuda or b2.is_cuda) and m == 0:
        return torch.zeros((*lead, n), dtype=torch.float32, device=a2.device)
    s = resolve_splits(splits, a2.device, m, n, kdim, bm=bm_, bn=bn_, bk=bk_, tk=k_step(k),
                       body=gemm_body(m, k))

    def run():
        if a2.is_cuda or b2.is_cuda:
            return _launch(a2.contiguous(), b2.contiguous(), k, bm_, bn_, bk_, s)
        return limb_matmul_plain(a2, b2, k, bk=bk_, splits=s)

    if oprecord.ACTIVE is None:
        out = run()
    else:
        flops, nbytes = oprecord.gemm_work(m, kdim, n, len(limb_product_terms(k)))
        out = oprecord.run_kernel("limb_matmul", run, (a2, b2), flops=flops, nbytes=nbytes,
                                 dtype=torch.bfloat16)
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# double-f32 variant: every partial product folded in with TwoSum
# ---------------------------------------------------------------------------


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Knuth TwoSum: ``s + e == a + b`` exactly, ``s = fl(a + b)``."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def reduce_splits_dd(pairs: list[tuple[torch.Tensor, torch.Tensor]]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-split (hi, lo) pairs combined in the double-f32 kernel's order
    (``splitk_reduce_dd``): (sum, comp) = (hi_0, lo_0); for s = 1..S-1, hi_s
    folded into the pair with TwoSum and lo_s added to comp; then renormalized.
    One pair is returned as it is (an unsplit launch writes it directly)."""
    if len(pairs) == 1:
        return pairs[0]
    s, c = pairs[0]
    for hi, lo in pairs[1:]:
        s, e = _two_sum(s, hi)
        c = (c + e) + lo
    return _two_sum(s, c)


def limb_matmul_dd_plain(a: torch.Tensor, b: torch.Tensor, k: int = 4, *,
                         bk: int = 512, fold: int | None = None, splits: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the double-f32 kernel: a (M, K) f32 @ b (K, N)
    f32 at k-limb precision -> (hi, lo).  Each of ``splits`` splits walks its
    pieces of K (``split_pieces``; one split: the ``bk`` slabs) and, inside a
    piece, steps of ``fold``; every retained term's product over one step
    (high order first) is folded into the split's (sum, compensation) pair
    with TwoSum, and the pair is renormalized.  The pairs are combined by
    ``reduce_splits_dd``.  ``fold=None`` folds once per piece — with one
    split once per slab, the TPU kernel's grain; the CUDA kernel's grain is
    ``k_step(k)``, its K step."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"limb_matmul_dd takes 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    m, kdim = a.shape
    n = b.shape[1]
    bk_ = clamp_block(bk, kdim)
    al, bl = extract_limbs(a, k), extract_limbs(b, k)
    pairs = []
    for pieces in split_pieces(kdim, bk_, k_step(k), splits):
        s = torch.zeros((m, n), dtype=torch.float32, device=a.device)
        c = torch.zeros_like(s)
        for _, k0, k1 in pieces:
            step = k1 - k0 if fold is None else fold
            for f0 in range(k0, k1, step):
                f1 = min(f0 + step, k1)
                for i, j in limb_product_terms(k):
                    s, e = _two_sum(s, al[i][:, f0:f1] @ bl[j][f0:f1, :])
                    c = c + e
        pairs.append(_two_sum(s, c))
    return reduce_splits_dd(pairs)


def _launch_dd(a2: torch.Tensor, b2: torch.Tensor, k: int, bm: int, bn: int,
               bk: int, splits: int) -> tuple[torch.Tensor, torch.Tensor]:
    check_gemm_operands(a2, b2, "limb_matmul_dd")
    if not 1 <= k <= 6:
        raise ValueError(f"limb_matmul_dd kernel supports 1..6 limbs, got {k}")
    m, kdim = a2.shape
    n = b2.shape[1]
    hi = torch.empty((m, n), dtype=torch.float32, device=a2.device)
    lo = torch.empty_like(hi)
    # hi halves of the split pairs, then lo halves: [2, S, M, N]
    ws = None if splits == 1 else torch.empty((2, splits, m, n), dtype=torch.float32,
                                              device=a2.device)
    lib = build.library()
    with torch.cuda.device(a2.device):
        code = lib.rmpm_limb_matmul_dd(
            a2.data_ptr(), b2.data_ptr(), hi.data_ptr(), lo.data_ptr(),
            None if ws is None else ws.data_ptr(), m, n, kdim, k, bm, bn, bk, splits,
            build.current_stream_ptr())
    build.check_launch(lib, code, "limb_matmul_dd")
    build.LAUNCHES["limb_matmul_dd"] += 1
    return hi, lo


def limb_matmul_dd(
    a: torch.Tensor,
    b: torch.Tensor,
    k: int = 4,
    *,
    bm: int = 128,
    bn: int = 128,
    bk: int = 512,
    splits: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """High-precision k-limb matmul a (M, K) @ b (K, N) returning a (hi, lo)
    double-f32 pair (M32 = 4 limbs, M48 = 6), through the fused kernel for
    CUDA tensors.  Ragged shapes need no padding.  ``splits`` overrides the
    K split count (``None``: ``split_k`` on the card, 1 on the CPU); it
    exists for timing the layouts side by side.  Raises under autograd
    (``build.refuse_autograd``)."""
    build.refuse_autograd("limb_matmul_dd", a, b)
    a2 = a.to(torch.float32)
    b2 = b.to(torch.float32)
    if a2.dim() != 2 or b2.dim() != 2:
        raise ValueError(f"limb_matmul_dd takes 2-D operands, got "
                         f"{tuple(a2.shape)} @ {tuple(b2.shape)}")
    m, kdim = a2.shape
    n = b2.shape[1]
    _, (bm_, bn_, bk_) = tile_grid(m, n, kdim, bm=bm, bn=bn, bk=bk)
    s = resolve_splits(splits, a2.device, m, n, kdim, bm=bm_, bn=bn_, bk=bk_, tk=k_step(k))

    def run():
        if a2.is_cuda or b2.is_cuda:
            return _launch_dd(a2.contiguous(), b2.contiguous(), k, bm_, bn_, bk_, s)
        return limb_matmul_dd_plain(a2, b2, k, bk=bk_, splits=s)

    if oprecord.ACTIVE is None:
        return run()
    flops, nbytes = oprecord.gemm_work(m, kdim, n, len(limb_product_terms(k)), outputs=2)
    return oprecord.run_kernel("limb_matmul_dd", run, (a2, b2), flops=flops, nbytes=nbytes,
                              dtype=torch.bfloat16)
