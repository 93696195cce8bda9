// limb_matmul_dd — CUDA port of the TPU kernel `limb_matmul_dd_pallas`
// (src/repro/kernels/limb_matmul/limb_matmul.py; body
// `_limb_matmul_dd_kernel`).
//
// a (M,K) f32 @ b (K,N) f32 -> a (hi, lo) pair of (M,N) f32 at k in 1..6
// bf16 limbs (M32 = 4, M48 = 6).  The datapath is the limb kernel's
// (rmpm_gemm.cuh): operand tiles read once and peeled into limbs on chip,
// the k(k+1)/2 retained products on the tensor cores, high-order terms
// first.  What differs is the accumulation: two f32 registers per output
// element, sum and compensation, and every term's partial sum over one K
// step is folded in with Knuth's TwoSum; each split renormalizes its pair
// into hi = s + c and lo = the rounding error of that add.
//
// Grain.  The TPU kernel folds once per (bk slab, term); this kernel folds
// once per (TK step, term), TK = 64 below four limbs and 32 above.  That is
// finer — each partial sums fewer products in plain f32 — so it is at least
// as accurate, but not bit-equal to a slab-grain fold: the plain version
// (`limb_matmul_dd_plain`) takes the fold step as an argument and is held
// against this kernel at TK.
//
// Bound on this card: at the serving shapes (M of a few rows) the weight is
// read once and dominates — bytes over the memory rate; for large M the
// k(k+1)/2 passes over the bf16 tensor-core rate.  Unsplit, 32 thread
// blocks would walk all of K at M = 4 on a 132-SM card, each paying a fixed
// cost per K step and then its TwoSum folds (56 f32 adds a term and a step
// in each thread, in two busy warps a block).  Two things answer that:
//  * deterministic split-K: split s of S (blockIdx.z) walks its contiguous
//    range of the block's K steps and writes its renormalized pair to a
//    workspace of 2 * S * M * N floats (hi halves, then lo halves);
//    `splitk_reduce_dd`, launched next on the same stream, folds the pairs
//    in the order s = 0..S-1 with TwoSum on hi and a plain add on lo, every
//    operation __fadd_rn/__fsub_rn.  No atomics, so the bits do not depend
//    on timing; with S = 1 the body writes hi and lo itself;
//  * a cheaper step: each thread loads and peels chunks of four elements
//    (16-byte loads, `peel4`) in place of one element at a time.
// What is left per step is the barriers, the peel and the folds; bytes in
// flight are not the limit (a cp.async ring of operand tiles timed no
// faster: PERF.md, `tools/dd_variants.py`).
// The wrapper picks S (`split_k`, the limb kernel's rule, at TK of k limbs).
#include "rmpm_gemm.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(rmpm::THREADS)
limb_matmul_dd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ hi, float* __restrict__ lo, int M,
                      int N, int K, int bm, int bn, int bk) {
  rmpm::rmpm_gemm_body<KMAX, true>(A, B, hi, nullptr, 0, M, N, K, bm, bn, bk,
                                   lo);
}

template <int KMAX>
int launch(const float* a, const float* b, float* hi, float* lo, float* ws,
           int m, int n, int k, int bm, int bn, int bk, int splits,
           cudaStream_t stream) {
  if (!rmpm::splits_ok(splits, ws, k, bk, rmpm::Tiling<KMAX>::TK))
    return (int)cudaErrorInvalidValue;
  const long long mn = (long long)m * n;
  const dim3 grid = rmpm::body_grid<rmpm::TM, rmpm::TN>(m, n, bm, bn, splits);
  limb_matmul_dd_kernel<KMAX><<<grid, rmpm::THREADS, 0, stream>>>(
      a, b, splits > 1 ? ws : hi, splits > 1 ? ws + splits * mn : lo, m, n, k,
      bm, bn, bk);
  return rmpm::finish_splits(hi, ws, m, n, splits, stream, lo);
}

}  // namespace

// limbs in [1, 6]; (bm, bn, bk) as clamped by the wrapper's tile_grid;
// splits >= 1, and ws a float32 workspace of 2 * splits * m * n when
// splits > 1 (unused, may be null, when splits == 1).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad argument.
extern "C" int rmpm_limb_matmul_dd(const void* a, const void* b, void* hi,
                                   void* lo, void* ws, int m, int n, int k,
                                   int limbs, int bm, int bn, int bk,
                                   int splits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      hi == nullptr || lo == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* H = (float*)hi;
  float* L = (float*)lo;
  float* W = (float*)ws;
  cudaStream_t s = (cudaStream_t)stream;
  switch (limbs) {
    case 1: return launch<1>(A, B, H, L, W, m, n, k, bm, bn, bk, splits, s);
    case 2: return launch<2>(A, B, H, L, W, m, n, k, bm, bn, bk, splits, s);
    case 3: return launch<3>(A, B, H, L, W, m, n, k, bm, bn, bk, splits, s);
    case 4: return launch<4>(A, B, H, L, W, m, n, k, bm, bn, bk, splits, s);
    case 5: return launch<5>(A, B, H, L, W, m, n, k, bm, bn, bk, splits, s);
    case 6: return launch<6>(A, B, H, L, W, m, n, k, bm, bn, bk, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
