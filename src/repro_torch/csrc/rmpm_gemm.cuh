// rmpm_gemm.cuh — the limb datapath shared by the limb kernel and the
// mode-map kernel.
//
// One device function, `rmpm_gemm_body<KMAX>`, computes one thread-block
// tile of  C (M,N) f32 = A (M,K) f32 @ B (K,N) f32  at limb precision:
// every operand tile is read ONCE from device memory as f32, peeled into
// KMAX bf16 limbs on the way into shared memory (round-to-nearest cast and
// an f32 subtraction; limbs never touch device memory), and the retained
// Karatsuba products  a_limb[ti] x b_limb[tj],  ti + tj < k_tile,  run as
// bf16 x bf16 -> f32 tensor-core MMAs (nvcuda::wmma 16x16x16), high-order
// (small-magnitude) terms first — the term order of `limb_product_terms`.
//
// `limb_matmul_kernel` calls it with no map (k_tile == KMAX everywhere);
// `tile_matmul_kernel` calls it with the int32 mode map.  Because both run
// the same body, the same K walk and the same term order, a uniform map at
// mode m gives the same bits as the limb kernel at k = m — the contract the
// TPU kernels hold by construction, held here the same way.
//
// What replaces what (TPU -> Hopper):
//  * the sequential K grid with an accumulator carried in scratch memory
//    becomes a loop over K inside the thread block;
//  * `(bm, bn, bk)` no longer sizes the tile that is resident on chip: it is
//    only the granularity of the mode map.  A thread block owns a
//    TM x TN = 32 x 32 piece of ONE map tile (so it has one map entry per K
//    slab), walks K in slabs of bk and, inside a slab, in steps of TK;
//  * the scalar-prefetched map becomes a plain load: each block finds its
//    entry from its own coordinates;
//  * ragged edges are masked here (zero fill on load, guarded store), so
//    the wrapper pads nothing.
//
// Accumulation.  The tensor core adds into its accumulator with truncation,
// which would bias a long chain.  So each term's products over one K step
// (TK/16 MMAs) go into a fresh fragment, and that partial sum is then added
// into the running f32 accumulator by the CUDA cores with round-to-nearest:
// the long chain over K is ordinary f32 summation.
//
// The limb subtraction r - float(bf16(r)) is exact in f32 (the difference
// of a float and its own leading bits is representable), so it cannot be
// changed by contraction; `__fsub_rn` is used anyway because it is never
// fused into an FMA, which keeps the statement true by construction.
// No -use_fast_math: flushing denormals would change limb extraction.
//
// Bound on this card: for decode shapes (M = a few rows) the weight B is
// read once and dominates — the bound is bytes / memory rate; for large M
// it is passes * 2MKN / bf16 tensor-core rate.  This first version keeps
// one TK-deep register prefetch in flight and nothing more (no TMA, no
// wgmma, no split-K): it is written to be right, and its measured times
// stand beside the bound in PERF.md.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace rmpm {

constexpr int TM = 32;       // thread-block tile rows
constexpr int TN = 32;       // thread-block tile cols
constexpr int THREADS = 128;  // 4 warps, 2 x 2 fragments of 16 x 16
constexpr int PAD = 8;        // bf16 elements of row padding (16 bytes)
constexpr int CS_LD = TN + 4; // staging row stride in floats

template <int KMAX>
struct Tiling {
  // K step: deeper for the f32 ladder, shallower for the wide modes so the
  // limb planes still fit the 48 KB of static shared memory.
  static constexpr int TK = (KMAX <= 3) ? 64 : 32;
  static constexpr int A_LD = TK + PAD;
  static constexpr int B_LD = TN + PAD;
  static constexpr int A_PER_THREAD = TM * TK / THREADS;
  static constexpr int B_PER_THREAD = TK * TN / THREADS;
};

// map == nullptr: every tile runs all KMAX-limb terms (the limb kernel).
// map_ndim == 2: map[(i * gn + j)];  map_ndim == 3: map[(i * gn + j) * gk + kk].
template <int KMAX>
__device__ __forceinline__ void rmpm_gemm_body(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, const int* __restrict__ map, int map_ndim, int M,
    int N, int K, int bm, int bn, int bk) {
  using T = Tiling<KMAX>;
  constexpr int TK = T::TK;
  namespace wmma = nvcuda::wmma;

  __shared__ __align__(32) __nv_bfloat16 As[KMAX][TM][T::A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[KMAX][TK][T::B_LD];
  __shared__ __align__(32) float Cs[TM][CS_LD];

  const int sub_m = (bm + TM - 1) / TM;  // thread blocks per map tile, rows
  const int sub_n = (bn + TN - 1) / TN;
  const int gn = (N + bn - 1) / bn;
  const int gk = (K + bk - 1) / bk;
  const int ti_map = blockIdx.y / sub_m;  // map tile row
  const int tj_map = blockIdx.x / sub_n;  // map tile col
  const int row0 = ti_map * bm + (blockIdx.y % sub_m) * TM;
  const int col0 = tj_map * bn + (blockIdx.x % sub_n) * TN;
  // rows/cols this block may touch: inside its map tile and inside C
  const int row_end = min(min(row0 + TM, (ti_map + 1) * bm), M);
  const int col_end = min(min(col0 + TN, (tj_map + 1) * bn), N);
  if (row0 >= row_end || col0 >= col_end) return;  // whole block, uniformly

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = (warp >> 1) * 16;  // fragment origin inside the block tile
  const int wc = (warp & 1) * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);

  float ra[T::A_PER_THREAD];
  float rb[T::B_PER_THREAD];

  // Load one K step (k0 .. k0+TK, valid below k_end) into registers; out of
  // range elements are zero, which adds exact zeros to the products.
  auto load_step = [&](int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < T::A_PER_THREAD; ++i) {
      const int idx = tid + i * THREADS;
      const int r = row0 + idx / TK;
      const int k = k0 + idx % TK;
      ra[i] = (r < row_end && k < k_end) ? A[(long long)r * K + k] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < T::B_PER_THREAD; ++i) {
      const int idx = tid + i * THREADS;
      const int k = k0 + idx / TN;
      const int c = col0 + idx % TN;
      rb[i] = (k < k_end && c < col_end) ? B[(long long)k * N + c] : 0.0f;
    }
  };

  // Peel the registers into KMAX bf16 limb planes in shared memory.
  auto split_step = [&]() {
#pragma unroll
    for (int i = 0; i < T::A_PER_THREAD; ++i) {
      const int idx = tid + i * THREADS;
      float r = ra[i];
#pragma unroll
      for (int l = 0; l < KMAX; ++l) {
        const __nv_bfloat16 limb = __float2bfloat16_rn(r);
        As[l][idx / TK][idx % TK] = limb;
        r = __fsub_rn(r, __bfloat162float(limb));
      }
    }
#pragma unroll
    for (int i = 0; i < T::B_PER_THREAD; ++i) {
      const int idx = tid + i * THREADS;
      float r = rb[i];
#pragma unroll
      for (int l = 0; l < KMAX; ++l) {
        const __nv_bfloat16 limb = __float2bfloat16_rn(r);
        Bs[l][idx / TN][idx % TN] = limb;
        r = __fsub_rn(r, __bfloat162float(limb));
      }
    }
  };

  for (int kk = 0; kk < gk; ++kk) {  // K slabs: the map's third axis
    int k_tile = KMAX;
    if (map != nullptr) {
      const long long e = (long long)ti_map * gn + tj_map;
      k_tile = (map_ndim == 3) ? map[e * gk + kk] : map[e];
    }
    const int k_begin = kk * bk;
    const int k_end = min(k_begin + bk, K);
    load_step(k_begin, k_end);
    for (int k0 = k_begin; k0 < k_end; k0 += TK) {
      split_step();
      __syncthreads();
      if (k0 + TK < k_end) load_step(k0 + TK, k_end);  // in flight during the MMAs
      // retained terms, high order first: s = ti + tj from KMAX-1 down to 0
#pragma unroll
      for (int s = KMAX - 1; s >= 0; --s) {
#pragma unroll
        for (int ti = 0; ti <= s; ++ti) {
          const int tj = s - ti;
          if (s < k_tile) {  // uniform across the block
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> part;
            wmma::fill_fragment(part, 0.0f);
#pragma unroll
            for (int ks = 0; ks < TK; ks += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> fa;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> fb;
              wmma::load_matrix_sync(fa, &As[ti][wr][ks], T::A_LD);
              wmma::load_matrix_sync(fb, &Bs[tj][ks][wc], T::B_LD);
              wmma::mma_sync(part, fa, fb, part);
            }
#pragma unroll
            for (int e = 0; e < acc.num_elements; ++e)
              acc.x[e] = __fadd_rn(acc.x[e], part.x[e]);
          }
        }
      }
      __syncthreads();
    }
  }

  wmma::store_matrix_sync(&Cs[wr][wc], acc, CS_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < TM * TN; idx += THREADS) {
    const int r = row0 + idx / TN;
    const int c = col0 + idx % TN;
    if (r < row_end && c < col_end) C[(long long)r * N + c] = Cs[idx / TN][idx % TN];
  }
}

// Grid of thread blocks covering every map tile of an (M, N) output.
inline dim3 gemm_grid(int M, int N, int bm, int bn) {
  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  const int sub_m = (bm + TM - 1) / TM, sub_n = (bn + TN - 1) / TN;
  return dim3((unsigned)(gn * sub_n), (unsigned)(gm * sub_m), 1);
}

}  // namespace rmpm
