// limb_matmul — CUDA port of the TPU kernel `limb_matmul_pallas`
// (src/repro/kernels/limb_matmul/limb_matmul.py; body `_limb_matmul_kernel`,
// helper `_extract_limbs`).
//
// a (M,K) f32 @ b (K,N) f32 -> (M,N) f32 at k in 1..6 bf16 limbs: operand
// tiles are read once, split into limbs on chip, and all k(k+1)/2 retained
// Karatsuba products are accumulated in f32.  The datapath, its bound and
// its design notes are in rmpm_gemm.cuh, which this kernel shares with the
// mode-map kernel so that the two agree bit for bit on uniform maps.
#include "rmpm_gemm.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(rmpm::THREADS)
limb_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, int bm, int bn,
                   int bk) {
  rmpm::rmpm_gemm_body<KMAX>(A, B, C, nullptr, 0, M, N, K, bm, bn, bk);
}

template <int KMAX>
int launch(const float* a, const float* b, float* c, int m, int n, int k,
           int bm, int bn, int bk, cudaStream_t stream) {
  limb_matmul_kernel<KMAX><<<rmpm::gemm_grid(m, n, bm, bn), rmpm::THREADS, 0,
                             stream>>>(a, b, c, m, n, k, bm, bn, bk);
  return (int)cudaGetLastError();
}

}  // namespace

// limbs in [1, 6]; (bm, bn, bk) as clamped by the wrapper's tile_grid.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad argument.
extern "C" int rmpm_limb_matmul(const void* a, const void* b, void* c, int m,
                                int n, int k, int limbs, int bm, int bn, int bk,
                                void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* C = (float*)c;
  cudaStream_t s = (cudaStream_t)stream;
  switch (limbs) {
    case 1: return launch<1>(A, B, C, m, n, k, bm, bn, bk, s);
    case 2: return launch<2>(A, B, C, m, n, k, bm, bn, bk, s);
    case 3: return launch<3>(A, B, C, m, n, k, bm, bn, bk, s);
    case 4: return launch<4>(A, B, C, m, n, k, bm, bn, bk, s);
    case 5: return launch<5>(A, B, C, m, n, k, bm, bn, bk, s);
    case 6: return launch<6>(A, B, C, m, n, k, bm, bn, bk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
