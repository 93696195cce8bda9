// limb_matmul — CUDA port of the TPU kernel `limb_matmul_pallas`
// (src/repro/kernels/limb_matmul/limb_matmul.py; body `_limb_matmul_kernel`,
// helper `_extract_limbs`).
//
// a (M,K) f32 @ b (K,N) f32 -> (M,N) f32 at k in 1..6 bf16 limbs: operand
// tiles are read once, split into limbs on chip, and all k(k+1)/2 retained
// Karatsuba products are accumulated in f32.  Three bodies of rmpm_gemm.cuh
// serve it, chosen by M and by whether k is above three limbs
// (`rmpm::use_skinny`, `rmpm::use_mma`):
//  * M <= 16 at k <= 3 (every decode step): `rmpm_skinny_body`, a
//    weight-streaming body — swap-AB mma.sync, a cp.async ring of raw f32
//    tiles, limbs peeled in registers.  The bound there is the weight's
//    bytes; the ring keeps ~100 KB of them in flight on each SM.
//  * M > 16 at k <= 3 (prefills, encoder frames, patch rows):
//    `rmpm_mma_body`, 64 x 128 tiles of mma.sync fragments fed by a
//    three-stage cp.async ring of raw f32 tiles, each step peeled once into
//    bf16 limb planes in shared memory and read with ldmatrix.  The bound
//    there is the weight's bytes at tens of rows and the retained MMAs at
//    hundreds.
//  * 4-6 limbs at every M: `rmpm_gemm_body`, the tiled wmma body with a
//    one-step register prefetch.
// The mode-map kernel routes the same way, so the two agree bit for bit on
// uniform maps; the datapath, its bound and the design notes are in
// rmpm_gemm.cuh.  The K walk is split S ways across thread blocks
// (deterministic split-K: partial tiles in a workspace, then a fixed-order
// reduction on the same stream); S comes from the wrapper.
#include <initializer_list>

#include "rmpm_gemm.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(rmpm::THREADS)
limb_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int bm, int bn,
                   int bk) {
  rmpm::rmpm_gemm_body<KMAX>(A, B, C, nullptr, 0, M, N, K, bm, bn, bk);
}

template <int KMAX, int NF>
__global__ void __launch_bounds__(rmpm::SK_THREADS, rmpm::SK_BLOCKS_PER_SM)
limb_matmul_skinny_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          float* __restrict__ C, int M, int N, int K, int bm, int bn,
                          int bk) {
  rmpm::rmpm_skinny_body<KMAX, NF>(A, B, C, nullptr, 0, M, N, K, bm, bn, bk);
}

template <int KMAX>
__global__ void __launch_bounds__(rmpm::MM_THREADS, rmpm::MM_BLOCKS_PER_SM)
limb_matmul_mma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, int M, int N, int K, int bm, int bn, int bk) {
  rmpm::rmpm_mma_body<KMAX>(A, B, C, nullptr, 0, M, N, K, bm, bn, bk);
}

template <int KMAX>
int launch(const float* a, const float* b, float* c, float* ws, int m, int n,
           int k, int bm, int bn, int bk, int splits, cudaStream_t stream) {
  if (!rmpm::splits_ok(splits, ws, k, bk, rmpm::Tiling<KMAX>::TK))
    return (int)cudaErrorInvalidValue;
  float* const dst = splits > 1 ? ws : c;
  if constexpr (KMAX <= 3) {
    if (rmpm::use_skinny(m, KMAX)) {
      const dim3 grid = rmpm::body_grid<rmpm::SK_TM, rmpm::SK_TN>(m, n, bm, bn, splits);
      if (m <= 8)
        limb_matmul_skinny_kernel<KMAX, 1><<<grid, rmpm::SK_THREADS, rmpm::SK_SMEM_BYTES,
                                             stream>>>(a, b, dst, m, n, k, bm, bn, bk);
      else
        limb_matmul_skinny_kernel<KMAX, 2><<<grid, rmpm::SK_THREADS, rmpm::SK_SMEM_BYTES,
                                             stream>>>(a, b, dst, m, n, k, bm, bn, bk);
    } else if (rmpm::use_mma(m, KMAX)) {
      const dim3 grid = rmpm::body_grid<rmpm::MM_TM, rmpm::MM_TN>(m, n, bm, bn, splits);
      limb_matmul_mma_kernel<KMAX><<<grid, rmpm::MM_THREADS, rmpm::MM_SMEM_BYTES, stream>>>(
          a, b, dst, m, n, k, bm, bn, bk);
    } else {
      return (int)cudaErrorInvalidValue;  // no body serves it
    }
  } else {
    const dim3 grid = rmpm::body_grid<rmpm::TM, rmpm::TN>(m, n, bm, bn, splits);
    limb_matmul_kernel<KMAX><<<grid, rmpm::THREADS, 0, stream>>>(a, b, dst, m, n, k, bm, bn,
                                                                 bk);
  }
  return rmpm::finish_splits(c, ws, m, n, splits, stream);
}

}  // namespace

// limbs in [1, 6]; (bm, bn, bk) as clamped by the wrapper's tile_grid;
// splits >= 1, and ws a float32 workspace of splits * m * n when splits > 1
// (unused, may be null, when splits == 1).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad argument.
extern "C" int rmpm_limb_matmul(const void* a, const void* b, void* c,
                                void* ws, int m, int n, int k, int limbs,
                                int bm, int bn, int bk, int splits,
                                void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* C = (float*)c;
  float* W = (float*)ws;
  cudaStream_t s = (cudaStream_t)stream;
  switch (limbs) {
    case 1: return launch<1>(A, B, C, W, m, n, k, bm, bn, bk, splits, s);
    case 2: return launch<2>(A, B, C, W, m, n, k, bm, bn, bk, splits, s);
    case 3: return launch<3>(A, B, C, W, m, n, k, bm, bn, bk, splits, s);
    case 4: return launch<4>(A, B, C, W, m, n, k, bm, bn, bk, splits, s);
    case 5: return launch<5>(A, B, C, W, m, n, k, bm, bn, bk, splits, s);
    case 6: return launch<6>(A, B, C, W, m, n, k, bm, bn, bk, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Allow the skinny and tensor-core tile kernels their rings on the current
// device; the wrapper calls it once per device, before the device's first
// launch.  Returns the first error of cudaFuncSetAttribute, or 0.
extern "C" int rmpm_limb_matmul_prepare() {
  using rmpm::allow_smem;
  constexpr int SK = rmpm::SK_SMEM_BYTES, MM = rmpm::MM_SMEM_BYTES;
  cudaError_t err = cudaSuccess;
  for (cudaError_t e : {allow_smem(limb_matmul_skinny_kernel<1, 1>, SK),
                        allow_smem(limb_matmul_skinny_kernel<1, 2>, SK),
                        allow_smem(limb_matmul_skinny_kernel<2, 1>, SK),
                        allow_smem(limb_matmul_skinny_kernel<2, 2>, SK),
                        allow_smem(limb_matmul_skinny_kernel<3, 1>, SK),
                        allow_smem(limb_matmul_skinny_kernel<3, 2>, SK),
                        allow_smem(limb_matmul_mma_kernel<1>, MM),
                        allow_smem(limb_matmul_mma_kernel<2>, MM),
                        allow_smem(limb_matmul_mma_kernel<3>, MM)})
    if (err == cudaSuccess) err = e;
  return (int)err;
}
