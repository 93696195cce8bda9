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
// It runs the limb kernel's bodies by the same rule (M only, since kmax <=
// 3): at M <= 16 the weight-streaming body (`rmpm::use_skinny`: swap-AB
// mma.sync, a cp.async ring of raw f32 tiles, limbs peeled in registers;
// bound by the weight's bytes), above it the tensor-core tile body
// (`rmpm::use_mma`: 64 x 128 tiles of mma.sync fragments, a three-stage
// cp.async ring, each step peeled once into limb planes read with
// ldmatrix), which branches on the map entry around the fully unrolled peel
// and terms of 1, 2 or 3 limbs, so a uniform map runs the limb kernel's
// instructions.
// The K walk is split S ways across thread blocks exactly as in the limb
// kernel (each step reads the map entry of its own slab), so uniform maps
// stay bit-identical to it at every S.  Datapath, split-K, bound and design
// notes: rmpm_gemm.cuh (shared with limb_matmul).
#include <initializer_list>

#include "rmpm_gemm.cuh"

namespace {

template <int KMAX, int NF>
__global__ void __launch_bounds__(rmpm::SK_THREADS, rmpm::SK_BLOCKS_PER_SM)
tile_matmul_skinny_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          float* __restrict__ C, const int* __restrict__ map,
                          int map_ndim, int M, int N, int K, int bm, int bn, int bk) {
  rmpm::rmpm_skinny_body<KMAX, NF>(A, B, C, map, map_ndim, M, N, K, bm, bn, bk);
}

template <int KMAX>
__global__ void __launch_bounds__(rmpm::MM_THREADS, rmpm::MM_BLOCKS_PER_SM)
tile_matmul_mma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ C, const int* __restrict__ map, int map_ndim,
                       int M, int N, int K, int bm, int bn, int bk) {
  rmpm::rmpm_mma_body<KMAX>(A, B, C, map, map_ndim, M, N, K, bm, bn, bk);
}

template <int KMAX>
int launch(const float* a, const float* b, float* c, float* ws, const int* map,
           int map_ndim, int m, int n, int k, int bm, int bn, int bk,
           int splits, cudaStream_t stream) {
  if (!rmpm::splits_ok(splits, ws, k, bk, rmpm::Tiling<KMAX>::TK))
    return (int)cudaErrorInvalidValue;
  float* const dst = splits > 1 ? ws : c;
  if (rmpm::use_skinny(m, KMAX)) {
    const dim3 grid = rmpm::body_grid<rmpm::SK_TM, rmpm::SK_TN>(m, n, bm, bn, splits);
    if (m <= 8)
      tile_matmul_skinny_kernel<KMAX, 1><<<grid, rmpm::SK_THREADS, rmpm::SK_SMEM_BYTES,
                                           stream>>>(a, b, dst, map, map_ndim, m, n, k,
                                                     bm, bn, bk);
    else
      tile_matmul_skinny_kernel<KMAX, 2><<<grid, rmpm::SK_THREADS, rmpm::SK_SMEM_BYTES,
                                           stream>>>(a, b, dst, map, map_ndim, m, n, k,
                                                     bm, bn, bk);
  } else if (rmpm::use_mma(m, KMAX)) {
    const dim3 grid = rmpm::body_grid<rmpm::MM_TM, rmpm::MM_TN>(m, n, bm, bn, splits);
    tile_matmul_mma_kernel<KMAX><<<grid, rmpm::MM_THREADS, rmpm::MM_SMEM_BYTES, stream>>>(
        a, b, dst, map, map_ndim, m, n, k, bm, bn, bk);
  } else {
    return (int)cudaErrorInvalidValue;  // no body serves it
  }
  return rmpm::finish_splits(c, ws, m, n, splits, stream);
}

}  // namespace

// kmax in [1, 3]; map_ndim in {2, 3}; map is int32 in device memory;
// splits >= 1, and ws a float32 workspace of splits * m * n when splits > 1
// (unused, may be null, when splits == 1).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad argument.
extern "C" int rmpm_tile_matmul(const void* a, const void* b, void* c,
                                void* ws, const void* map, int map_ndim,
                                int m, int n, int k, int kmax, int bm, int bn,
                                int bk, int splits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || bk <= 0 ||
      map == nullptr || (map_ndim != 2 && map_ndim != 3))
    return (int)cudaErrorInvalidValue;
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* C = (float*)c;
  float* W = (float*)ws;
  const int* mp = (const int*)map;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kmax) {
    case 1: return launch<1>(A, B, C, W, mp, map_ndim, m, n, k, bm, bn, bk, splits, s);
    case 2: return launch<2>(A, B, C, W, mp, map_ndim, m, n, k, bm, bn, bk, splits, s);
    case 3: return launch<3>(A, B, C, W, mp, map_ndim, m, n, k, bm, bn, bk, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Allow the skinny and tensor-core tile kernels their rings on the current
// device; the wrapper calls it once per device, before the device's first
// launch.  Returns the first error of cudaFuncSetAttribute, or 0.
extern "C" int rmpm_tile_matmul_prepare() {
  using rmpm::allow_smem;
  constexpr int SK = rmpm::SK_SMEM_BYTES, MM = rmpm::MM_SMEM_BYTES;
  cudaError_t err = cudaSuccess;
  for (cudaError_t e : {allow_smem(tile_matmul_skinny_kernel<1, 1>, SK),
                        allow_smem(tile_matmul_skinny_kernel<1, 2>, SK),
                        allow_smem(tile_matmul_skinny_kernel<2, 1>, SK),
                        allow_smem(tile_matmul_skinny_kernel<2, 2>, SK),
                        allow_smem(tile_matmul_skinny_kernel<3, 1>, SK),
                        allow_smem(tile_matmul_skinny_kernel<3, 2>, SK),
                        allow_smem(tile_matmul_mma_kernel<1>, MM),
                        allow_smem(tile_matmul_mma_kernel<2>, MM),
                        allow_smem(tile_matmul_mma_kernel<3>, MM)})
    if (err == cudaSuccess) err = e;
  return (int)err;
}
