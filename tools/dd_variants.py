#!/usr/bin/env python3
"""dd_variants.py — build variants of the double-f32 kernel on one GPU, hold
each to the checks of ``chip_smoke.py`` and time the ones that should pass.

Run from the root of a checkout on a machine with an NVIDIA GPU and nvcc:

    python3 tools/dd_variants.py --out build/dd_variants.jsonl

Each variant is a copy of ``src/repro_torch`` in a temporary directory with
textual patches of ``csrc/rmpm_gemm.cuh`` and ``csrc/limb_matmul_dd.cu``,
built into its own directory and run in its own process (the checkout is
never changed):

  shipped          the sources as they are: one K step prefetched in
                   registers, four consecutive elements a thread, peeled
                   with ``peel4``;
  ring             the operands copied by ``cp.async`` into a ring of three
                   (K step 64) or four (K step 32) f32 operand stages in
                   dynamic shared memory, that many K steps ahead, each
                   thread peeling the chunks it copied — the same chunks,
                   peel and arithmetic, another load path;
  mut_reverse      the split pairs folded in the order s = S-1, ..., 0;
  mut_lo_dropped   the reduction ignores lo_s;
  mut_plain_add    hi_s added with a plain add in place of TwoSum;
  mut_ceil_ranges  split s runs [ceil(s*T/S), ceil((s+1)*T/S)).

For each variant it prints one JSON line: whether ``chip_smoke.check_dd``
passes (else the first check that failed), ptxas's registers for the
double-f32 kernels, and at the cases where a mutant can show, every one of
the double-f32 kernel's measures of ``check_dd``.  ``shipped`` and ``ring``
must pass and give the same bits; every mutant must fail.  Then the two
that pass are timed at the serving shapes of ``chip_smoke.DD_CASES``, at the
planned K split and at S = 1, in the order shipped, ring, ring, shipped
(``--no-time`` skips this).  Exits non-zero if any expectation fails.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMM = "rmpm_gemm.cuh"
DD = "limb_matmul_dd.cu"

#: the double-f32 instantiations' load path in the shipped body, replaced
#: as a whole by the ring variant
DD_BLOCK_START = "  if constexpr (DD) {\n    // One K step in registers"
DD_BLOCK_END = "  } else {\n    float ra[T::A_PER_THREAD];"

#: the ring's load path for the DD instantiations, through the cp.async
#: helpers that csrc/rmpm_gemm.cuh ships for its weight-streaming body
RING_BLOCK = r"""  if constexpr (DD) {
    // the cp.async ring: RING_STAGES x (A tile TM x TK, B tile TK x TN), f32
    extern __shared__ __align__(16) float ring[];
    constexpr int STAGES = T::RING_STAGES;
    // 16-byte copies need 16-byte-aligned chunks: an aligned base, and rows
    // and chunk starts (k0 a multiple of bk, col0 of bn) at multiples of 4
    const bool vec_a = ((reinterpret_cast<uintptr_t>(A) & 15) | (K & 3) | (bk & 3)) == 0;
    const bool vec_b = ((reinterpret_cast<uintptr_t>(B) & 15) | (N & 3) | (bn & 3)) == 0;
    // Copy the first `valid` of the four elements at src into dst and zero
    // the rest (`base`, always a valid address, stands in for src when no
    // element is read).
    auto copy4 = [&](float* dst, const float* src, int valid, bool vec, const float* base) {
      if (vec) {
        cp_async16(dst, valid > 0 ? src : base, 4 * valid);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < valid ? src + e : base, e < valid ? 4 : 0);
      }
    };
    // Issue step t's copies into ring stage st: this thread's chunks of four
    // consecutive elements, the same chunks `peel_stage` peels.
    auto issue_step = [&](int t, int st) {
      float* const sa = ring + st * T::STAGE_FLOATS;
      float* const sb = sa + TM * TK;
      const int k0 = step_k0(t), k_end = step_end(t);
#pragma unroll
      for (int i = 0; i < T::A_PER_THREAD / 4; ++i) {
        const int q = (tid + i * THREADS) * 4;  // first element of the chunk
        const int r = row0 + q / TK;
        const int k = k0 + q % TK;
        const int valid = r < row_end ? max(0, min(4, k_end - k)) : 0;
        copy4(sa + q, A + (long long)r * K + k, valid, vec_a, A);
      }
#pragma unroll
      for (int i = 0; i < T::B_PER_THREAD / 4; ++i) {
        const int q = (tid + i * THREADS) * 4;
        const int k = k0 + q / TN;
        const int c = col0 + q % TN;
        const int valid = k < k_end ? max(0, min(4, col_end - c)) : 0;
        copy4(sb + q, B + (long long)k * N + c, valid, vec_b, B);
      }
    };
    // Peel this thread's chunks of ring stage st into the limb planes.
    auto peel_stage = [&](int st) {
      const float* const sa = ring + st * T::STAGE_FLOATS;
      const float* const sb = sa + TM * TK;
#pragma unroll
      for (int i = 0; i < T::A_PER_THREAD / 4; ++i) {
        const int q = (tid + i * THREADS) * 4;
        peel4<KMAX, TM * T::A_LD>(*reinterpret_cast<const float4*>(sa + q),
                                  &As[0][q / TK][q % TK]);
      }
#pragma unroll
      for (int i = 0; i < T::B_PER_THREAD / 4; ++i) {
        const int q = (tid + i * THREADS) * 4;
        peel4<KMAX, TK * T::B_LD>(*reinterpret_cast<const float4*>(sb + q),
                                  &Bs[0][q / TN][q % TN]);
      }
    };

    const int n_steps = t_end - t_begin;
#pragma unroll
    for (int j = 0; j < STAGES; ++j) {
      if (j < n_steps) issue_step(t_begin + j, j);
      cp_async_commit();  // one group per step (empty past the range)
    }
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % STAGES;
      cp_async_wait<STAGES - 1>();  // this thread's copies of step i have landed
      __syncthreads();  // every warp is done with step i-1's limb planes
      peel_stage(st);   // only chunks this thread copied itself
      __syncthreads();  // the limb planes of step i are complete
      if (i + STAGES < n_steps) issue_step(t_begin + i + STAGES, st);  // refill it
      cp_async_commit();
      mma_terms(KMAX);
    }
"""

ALLOW_RING = r"""// Once per instantiation and device: allow the ring's dynamic shared memory
// (limb planes + ring exceed the 48 KB a launch gets unasked) and prefer the
// largest shared-memory carveout, so that two blocks fit an SM.  Setting it
// on every call would add host time to each launch.
template <int KMAX>
cudaError_t allow_ring() {
  static std::atomic<unsigned long long> ready{0};  // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(limb_matmul_dd_kernel<KMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             rmpm::Tiling<KMAX>::RING_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(limb_matmul_dd_kernel<KMAX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

"""

_FOLD = "      two_sum_fold(s, c, ws[p * mn + i]);\n"
_ADD_LO = "      c = __fadd_rn(c, ws_lo[p * mn + i]);\n"
_RANGES = ("  const int t_begin = (int)((long long)blockIdx.z * steps / gridDim.z);\n"
           "  const int t_end = (int)((long long)(blockIdx.z + 1) * steps / gridDim.z);\n")
_CEIL_RANGES = _RANGES.replace(
    "blockIdx.z * steps / gridDim.z", "(blockIdx.z * steps + gridDim.z - 1) / gridDim.z").replace(
    "(blockIdx.z + 1) * steps / gridDim.z", "((blockIdx.z + 1) * steps + gridDim.z - 1) / gridDim.z")
_TILING_END = "  static constexpr int B_PER_THREAD = TK * TN / THREADS;\n};\n"

#: variant -> (file in csrc, old, new) replacements, each of which must match
#: exactly once; old == DD_BLOCK_START replaces the DD load path up to
#: DD_BLOCK_END
PATCHES: dict[str, list[tuple[str, str, str]]] = {
    "shipped": [],
    "ring": [
        (GEMM, _TILING_END, _TILING_END[:-3] + (
            "  static constexpr int RING_STAGES = (TK == 64) ? 3 : 4;\n"
            "  static constexpr int STAGE_FLOATS = TM * TK + TK * TN;\n"
            "  static constexpr int RING_BYTES = RING_STAGES * STAGE_FLOATS * 4;\n};\n")),
        (GEMM, DD_BLOCK_START, RING_BLOCK),
        (DD, '#include "rmpm_gemm.cuh"\n', '#include <atomic>\n\n#include "rmpm_gemm.cuh"\n'),
        (DD, "template <int KMAX>\nint launch(", ALLOW_RING + "template <int KMAX>\nint launch("),
        (DD, "    return (int)cudaErrorInvalidValue;\n  const long long mn",
         "    return (int)cudaErrorInvalidValue;\n  const cudaError_t err = allow_ring<KMAX>();\n"
         "  if (err != cudaSuccess) return (int)err;\n  const long long mn"),
        (DD, "rmpm::THREADS, 0, stream>>>(",
         "rmpm::THREADS, rmpm::Tiling<KMAX>::RING_BYTES,\n                                stream>>>("),
    ],
    "mut_reverse": [
        (GEMM, "    float s = ws[i], c = ws_lo[i];\n    for (int p = 1; p < splits; ++p) {\n",
         "    float s = ws[(splits - 1) * mn + i], c = ws_lo[(splits - 1) * mn + i];\n"
         "    for (int p = splits - 2; p >= 0; --p) {\n"),
    ],
    "mut_lo_dropped": [(GEMM, _ADD_LO, "")],
    "mut_plain_add": [(GEMM, _FOLD, "      s = __fadd_rn(s, ws[p * mn + i]);\n")],
    "mut_ceil_ranges": [(GEMM, _RANGES, _CEIL_RANGES)],
}
PASSING = ("shipped", "ring")
#: cases where the mutants can show: split counts with T % S != 0 (the
#: ceiling ranges differ from the floor ones), planned and forced, ragged
#: and aligned; (M, K, N, limbs), blocks, S
PROBE_CASES = (((4, 1024, 2816, 4), {}, 3), ((4, 2816, 1024, 6), {}, 8),
               ((48, 2816, 1024, 4), {}, 5), ((17, 33, 9, 4), dict(bm=16, bn=16, bk=16), 2),
               ((4, 2816, 1024, 4), dict(bk=720), 7))


def patch_sources(sources: dict[str, str], variant: str) -> dict[str, str]:
    """The csrc files (name -> text) with the variant's replacements applied."""
    out = dict(sources)
    for name, old, new in PATCHES[variant]:
        text = out[name]
        if old == DD_BLOCK_START:
            if text.count(DD_BLOCK_START) != 1 or text.count(DD_BLOCK_END) != 1:
                raise ValueError(f"{variant}: the DD load path is not found exactly once")
            start = text.index(DD_BLOCK_START)
            out[name] = text[:start] + new + text[text.index(DD_BLOCK_END, start):]
            continue
        if text.count(old) != 1:
            raise ValueError(f"{variant}: {old!r} matches {text.count(old)} times in {name}")
        out[name] = text.replace(old, new)
    return out


def read_sources(csrc: str) -> dict[str, str]:
    out = {}
    for name in (GEMM, DD):
        with open(os.path.join(csrc, name)) as fh:
            out[name] = fh.read()
    return out


def make_copy(variant: str, tmp: str) -> dict:
    """A patched copy of the package under tmp; the worker's environment."""
    src = os.path.join(tmp, variant, "src")
    pkg = os.path.join(src, "repro_torch")
    shutil.copytree(os.path.join(_ROOT, "src", "repro_torch"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(pkg, "csrc")
    for name, text in patch_sources(read_sources(csrc), variant).items():
        with open(os.path.join(csrc, name), "w") as fh:
            fh.write(text)
    return dict(os.environ, PYTHONPATH=src,
                REPRO_TORCH_BUILD_DIR=os.path.join(tmp, variant, "build"))


# ---------------------------------------------------------------------------
# the worker: one variant in its own process
# ---------------------------------------------------------------------------


def _worker(variant: str, task: str, tmp: str) -> dict:
    import repro_torch  # the patched copy, first on PYTHONPATH

    if not os.path.abspath(repro_torch.__file__).startswith(os.path.abspath(tmp)):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, not the copy")
    sys.path.insert(1, _ROOT)
    import torch

    import chip_smoke as cs
    from repro_torch.core.limb import limb_product_terms
    from repro_torch.kernels import build
    from repro_torch.kernels.limb_matmul.ops import (
        k_step, limb_matmul_dd, limb_matmul_dd_plain, tile_grid)

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.library(verbose=True)  # ptxas -v to stdout; the result is the last line
    dd_log = build.BUILD_LOG[build.BUILD_LOG.index("== limb_matmul_dd.cu =="):]
    out = dict(variant=variant, task=task, build_s=time.perf_counter() - t0,
               ptxas=[ln.split(":", 1)[-1].strip() for ln in dd_log.splitlines()
                      if "Compiling entry" in ln or "Used" in ln or "spill" in ln])
    if task == "check":
        gen = torch.Generator(device="cuda").manual_seed(0)
        try:
            dd = cs.check_dd(gen)
            out.update(check_dd="passed", max_f64_rel_err=dd["max_f64_rel_err"],
                       max_vs_plain_rel_err=dd["max_rel_err"],
                       max_split_vs_unsplit_rel_err=dd["max_split_vs_unsplit_rel_err"],
                       split_compositions_exact=dd["split_compositions_exact"])
        except AssertionError as exc:
            out.update(check_dd="failed", first_failed_check=str(exc))
        probes, bits = [], {}
        for i, ((m, k, n, limbs), blk, s) in enumerate(PROBE_CASES):
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            a, b = cs._rand(g, m, k), cs._rand(g, k, n)
            hi, lo = limb_matmul_dd(a, b, limbs, splits=s, **blk)
            hi1, lo1 = limb_matmul_dd(a, b, limbs, splits=1, **blk)
            exact = a.double() @ b.double()
            scale = float(exact.abs().max())
            got = hi.double() + lo.double()
            _, (_, _, bk) = tile_grid(m, n, k, **blk)
            p_hi, p_lo = limb_matmul_dd_plain(a, b, limbs, bk=bk, fold=k_step(limbs), splits=s)
            probes.append(dict(
                m=m, k=k, n=n, limbs=limbs, blk=blk, splits=s,
                f64_rel_err=float((got - exact).abs().max()) / scale,
                vs_plain_rel_err=float((got - p_hi.double() - p_lo.double()).abs().max()) / scale,
                lo_over_hi=float(lo.abs().max() / hi.abs().max()),
                split_vs_unsplit_rel_err=cs.split_vs_unsplit(
                    got, hi1.double() + lo1.double(), scale),
                composition_mismatches=cs.split_composition_mismatches(
                    a, b, limbs, s, blk, hi, lo)))
            bits[f"{i}/hi"], bits[f"{i}/lo"] = hi.cpu(), lo.cpu()
            bits[f"{i}/hi1"], bits[f"{i}/lo1"] = hi1.cpu(), lo1.cpu()
        torch.save(bits, os.path.join(tmp, f"{variant}.bits.pt"))
        out["probes"] = probes
    else:
        gen = torch.Generator(device="cuda").manual_seed(1)
        rows = []
        for m, k, n, limbs in cs.DD_CASES:
            if m not in cs.MAIN_M:
                continue
            a = cs._rand(gen, m, k)
            n_rot = min(cs.n_rotations(4 * k * n), 64)
            bs = [cs._rand(gen, k, n) for _ in range(n_rot)]
            s = cs.planned_splits(m, k, n, limbs)
            ms1, _ = cs.time_ms(lambda i: limb_matmul_dd(a, bs[i], limbs, splits=1), n_rot)
            ms, _ = cs.time_ms(lambda i: limb_matmul_dd(a, bs[i], limbs), n_rot)
            bound, _ = cs.gemm_bound_ms(m, k, n, len(limb_product_terms(limbs)), outputs=2)
            rows.append(dict(m=m, k=k, n=n, limbs=limbs, splits=s, ms=ms, ms_splits1=ms1,
                             bound_ms=bound))
            del bs
        out["rows"] = rows
    return out


# ---------------------------------------------------------------------------
# the parent process: copies, workers, expectations
# ---------------------------------------------------------------------------


def _run(variant: str, task: str, tmp: str, env: dict) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", variant, "--task", task,
         "--tmp", tmp], env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        return dict(variant=variant, task=task, error=proc.stderr[-3000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also append every JSON line to this file")
    ap.add_argument("--variants", default=",".join(PATCHES))
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--task", default="check", help=argparse.SUPPRESS)
    ap.add_argument("--tmp", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(_worker(args.worker, args.task, args.tmp)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("dd_variants.py needs an NVIDIA GPU")
    variants = [v for v in args.variants.split(",") if v]
    for v in variants:
        if v not in PATCHES:
            raise SystemExit(f"unknown variant {v!r}")

    def say(obj: dict) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")

    ok = True
    with tempfile.TemporaryDirectory(prefix="dd_variants_") as tmp:
        envs = {v: make_copy(v, tmp) for v in variants}
        for v in variants:
            res = _run(v, "check", tmp, envs[v])
            want = "passed" if v in PASSING else "failed"
            res["expected"] = want
            ok &= res.get("check_dd") == want
            say(res)
        if all(v in variants for v in PASSING):
            a, b = (torch.load(os.path.join(tmp, f"{v}.bits.pt")) for v in PASSING)
            same = sorted(a) == sorted(b) and all(torch.equal(a[key], b[key]) for key in a)
            ok &= same
            say({"ring_bits_equal_shipped": same})
        timed = [v for v in PASSING if v in variants]
        if not args.no_time and timed:
            for v in timed + timed[::-1]:
                say(_run(v, "time", tmp, envs[v]))
    say({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
