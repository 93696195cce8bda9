// tile_matmul — CUDA port of the TPU kernel `tile_matmul_pallas`
// (src/repro/kernels/tile_matmul/tile_matmul.py; body `_tile_matmul_kernel`).
//
// The limb datapath with the precision decision taken into the kernel as
// DATA: limbs are extracted at kmax (<= 3) and an int32 mode map of shape
// (M/bm, N/bn) or (M/bm, N/bn, K/bk), entries in [1, kmax], says how many
// limbs each tile (and K slab) uses — pass (ti, tj) runs only where
// ti + tj < map[...].  The map lives in device memory and each thread block
// loads its own entry, so changing a mode changes one int32 and builds
// nothing; this is the run-time reconfiguration path of the serving engine.
// Datapath, bound and design notes: rmpm_gemm.cuh (shared with limb_matmul).
#include "rmpm_gemm.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(rmpm::THREADS)
tile_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, const int* __restrict__ map,
                   int map_ndim, int M, int N, int K, int bm, int bn, int bk) {
  rmpm::rmpm_gemm_body<KMAX>(A, B, C, map, map_ndim, M, N, K, bm, bn, bk);
}

template <int KMAX>
int launch(const float* a, const float* b, float* c, const int* map,
           int map_ndim, int m, int n, int k, int bm, int bn, int bk,
           cudaStream_t stream) {
  tile_matmul_kernel<KMAX><<<rmpm::gemm_grid(m, n, bm, bn), rmpm::THREADS, 0,
                             stream>>>(a, b, c, map, map_ndim, m, n, k, bm, bn,
                                       bk);
  return (int)cudaGetLastError();
}

}  // namespace

// kmax in [1, 3]; map_ndim in {2, 3}; map is int32 in device memory.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad argument.
extern "C" int rmpm_tile_matmul(const void* a, const void* b, void* c,
                                const void* map, int map_ndim, int m, int n,
                                int k, int kmax, int bm, int bn, int bk,
                                void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      map == nullptr || (map_ndim != 2 && map_ndim != 3))
    return (int)cudaErrorInvalidValue;
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* C = (float*)c;
  const int* mp = (const int*)map;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kmax) {
    case 1: return launch<1>(A, B, C, mp, map_ndim, m, n, k, bm, bn, bk, s);
    case 2: return launch<2>(A, B, C, mp, map_ndim, m, n, k, bm, bn, bk, s);
    case 3: return launch<3>(A, B, C, mp, map_ndim, m, n, k, bm, bn, bk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
