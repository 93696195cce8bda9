"""On-device autotuner: microbenchmark the planner's candidate space.

For each shape in the grid the runner measures every candidate execution
point — (RMPM mode, Strassen depth, impl, and kernel block sizes ``bm/bn/bk``
for the limb and mode-map kernels) — and records median wall time, achieved
FLOP/s and max-abs error vs a float64 reference.  The result is a
:class:`TuneTable` (tune/table.py) the planner resolves against instead of
trusting the data-sheet roofline constants.

The candidate space mirrors the planner's own (planner._impl_candidates /
_depth_candidates): on the GPU 'native', 'xla', 'pallas' (the limb kernel)
and 'tile' (the mode-map kernel with a uniform map), with a block grid for
both kernels; on the CPU 'native' and 'xla'; depths gated by
``align * 2**depth`` fitting the shape.  Measuring 'tile' against 'pallas'
lets the planner decide from data whether the per-tile predication costs
anything on a given card.

Timing: the median over ``iters`` calls of the host's wall time around one
call followed by ``torch.cuda.synchronize()``; one warm-up call first
absorbs the one-time kernel-library build.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core.precision import MODE_LIMBS, Mode
from repro_torch.device import backend_of, resolve_device
from repro_torch.tune.table import TuneRecord, TuneTable, mode_key

DEFAULT_MODES = (Mode.M8, Mode.M16, Mode.M24)

#: kernel block-size grid (bm, bn, bk); the wrappers clamp each to the shape,
#: so oversized entries degrade to the whole-dim block instead of failing.
DEFAULT_BLOCKS = ((128, 128, 128), (128, 128, 512))

#: measured impls per backend: the planner's candidates on that backend
BACKEND_IMPLS = {
    "gpu": ("native", "xla", "pallas", "tile"),
    "cpu": ("native", "xla"),
}


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One execution point of the tuner's search space."""

    mode: Mode
    impl: str
    depth: int
    block: tuple[int, int, int] | None = None

    def label(self) -> str:
        blk = "x".join(map(str, self.block)) if self.block else "-"
        return f"{mode_key(self.mode, self.impl)}/{self.impl}/d{self.depth}/{blk}"


def depth_candidates(m: int, k: int, n: int, max_depth: int, align: int) -> list[int]:
    """Depths whose leaves keep at least one ``align`` tile per side — the
    same gate the planner applies (planner._depth_candidates)."""
    out = [0]
    for d in range(1, max_depth + 1):
        if min(m, k, n) >= align * (2**d):
            out.append(d)
    return out


def candidates(
    m: int,
    k: int,
    n: int,
    backend: str,
    *,
    modes: tuple[Mode, ...] = DEFAULT_MODES,
    impls: tuple[str, ...] | None = None,
    max_depth: int = 1,
    align: int = 128,
    blocks: tuple[tuple[int, int, int], ...] = DEFAULT_BLOCKS,
) -> list[Candidate]:
    """The measurable candidate space for one shape on one backend."""
    if impls is None:
        impls = BACKEND_IMPLS[backend]
    out: list[Candidate] = []
    for depth in depth_candidates(m, k, n, max_depth, align):
        for impl in impls:
            if impl == "native":
                # plain f32 product ignores the mode: measure once per depth
                out.append(Candidate(Mode.M24, "native", depth))
                continue
            for mode in modes:
                if impl == "pallas":
                    if MODE_LIMBS[mode] < 2:
                        continue  # fused extraction needs >= 2 resident limbs
                    for blk in blocks:
                        out.append(Candidate(mode, "pallas", depth, blk))
                elif impl == "tile":
                    # uniform-map tile kernel: same fused datapath, every
                    # f32 mode (a 1-limb map still beats a switch dispatch)
                    for blk in blocks:
                        out.append(Candidate(mode, "tile", depth, blk))
                else:
                    out.append(Candidate(mode, impl, depth))
    return out


def _median_wall_us(fn, device: torch.device, iters: int, warmup: int = 1) -> float:
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
        sync()
    ts = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


@functools.lru_cache(maxsize=4)
def _operands(m: int, k: int, n: int, seed: int):
    """Host operands of one shape and their float64 product."""
    rng = np.random.default_rng((seed, m, k, n))
    a = np.asarray(rng.standard_normal((m, k)), np.float32)
    b = np.asarray(rng.standard_normal((k, n)), np.float32)
    return a, b, a.astype(np.float64) @ b.astype(np.float64)


def measure(
    m: int,
    k: int,
    n: int,
    cand: Candidate,
    *,
    iters: int = 3,
    seed: int = 0,
    device=None,
) -> TuneRecord:
    """Measure one candidate on one shape on ``device`` (None -> the GPU):
    median wall, FLOP/s, f64 error."""
    from repro_torch.core.rmpm import mp_matmul

    dev = resolve_device(device)
    a, b, ref = _operands(m, k, n, seed)
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)

    def fn():
        return mp_matmul(at, bt, cand.mode, impl=cand.impl,
                         strassen_depth=cand.depth, block=cand.block, device=dev)

    wall_us = _median_wall_us(fn, dev, iters)
    out = fn().cpu().numpy().astype(np.float64)
    max_abs = float(np.abs(out - ref).max())
    rel = max_abs / float(np.abs(ref).max())
    return TuneRecord(
        m=m,
        k=k,
        n=n,
        mode=mode_key(cand.mode, cand.impl),
        impl=cand.impl,
        depth=cand.depth,
        wall_us=wall_us,
        flops_per_s=2.0 * m * k * n / (wall_us * 1e-6),
        max_abs_err=max_abs,
        rel_err=rel,
        block=cand.block,
        iters=iters,
    )


def tune(
    sizes: tuple[int, ...],
    *,
    backend: str | None = None,
    modes: tuple[Mode, ...] = DEFAULT_MODES,
    impls: tuple[str, ...] | None = None,
    max_depth: int = 1,
    align: int = 128,
    blocks: tuple[tuple[int, int, int], ...] = DEFAULT_BLOCKS,
    iters: int = 3,
    seed: int = 0,
    progress=None,
) -> TuneTable:
    """Sweep the candidate space over square ``sizes`` -> a TuneTable.

    ``backend``: 'gpu' measures on the GPU, 'cpu' on the CPU; None means the
    GPU, and raises when there is none."""
    if backend is None:
        backend = backend_of(resolve_device(None))
    if backend not in BACKEND_IMPLS:
        raise ValueError(f"unknown backend {backend!r}: want 'gpu' | 'cpu'")
    device = torch.device("cuda" if backend == "gpu" else "cpu")
    records = []
    for size in sizes:
        m = k = n = int(size)
        for cand in candidates(
            m,
            k,
            n,
            backend,
            modes=modes,
            impls=impls,
            max_depth=max_depth,
            align=align,
            blocks=blocks,
        ):
            rec = measure(m, k, n, cand, iters=iters, seed=seed, device=device)
            records.append(rec)
            if progress is not None:
                progress(
                    f"n={size} {cand.label()}: {rec.wall_us:.0f}us "
                    f"({rec.flops_per_s / 1e9:.2f} GFLOP/s, rel={rec.rel_err:.1e})"
                )
    return TuneTable(
        backend=backend,
        records=tuple(records),
        align=align,
        torch_version=torch.__version__,
        iters=iters,
    )
