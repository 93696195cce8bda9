// rmpm_gemm.cuh — the limb datapath shared by the limb kernel, the
// mode-map kernel and the double-f32 limb kernel.
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
// `tile_matmul_kernel` calls it with the int32 mode map;
// `limb_matmul_dd_kernel` calls its compile-time double-f32 variant (DD).
// Because the first two run the same body, the same K walk and the same
// term order, a uniform map at mode m gives the same bits as the limb kernel
// at k = m — the contract the TPU kernels hold by construction, held here
// the same way.
//
// What replaces what (TPU -> Hopper):
//  * the sequential K grid with an accumulator carried in scratch memory
//    becomes a loop over K inside the thread block, cut into S splits that
//    run as separate thread blocks (Split-K below);
//  * `(bm, bn, bk)` no longer sizes the tile that is resident on chip: it is
//    only the granularity of the mode map.  A thread block owns a
//    TM x TN = 32 x 32 piece of ONE map tile (so it has one map entry per K
//    slab), walks K in slabs of bk and, inside a slab, in steps of TK;
//  * the scalar-prefetched map becomes a plain load: each block finds its
//    entry from its own coordinates;
//  * ragged edges are masked here (zero fill on load, guarded store), so
//    the wrapper pads nothing.
//
// Split-K.  At the decode shapes (M = a few rows) the (M, N) grid alone is a
// few dozen thread blocks on a 132-SM card, each walking all of K with one
// step's loads in flight.  So the grid has a third dimension of S splits.
// The K walk of a block is one ordered list of steps — for slab kk, the
// steps k0 = kk*bk, kk*bk + TK, ... below min((kk+1)*bk, K) — and split s
// takes its contiguous range [s*T/S, (s+1)*T/S) of the T steps.  Each step
// keeps its slab, so the map entry of slab kk governs exactly its own steps,
// for a ragged last slab and for bk < TK alike.  Split s writes its f32
// partial tile to a workspace [S, M, N]; `splitk_reduce` then adds the
// partials in the fixed order s = 0, 1, ..., S-1 with __fadd_rn and writes C.
// No float atomics and no last-block fixup: the order of every sum is fixed
// by the layout, never by timing, so run-to-run bits, uniform map == limb
// kernel and runtime == static hold at every S.  With S == 1 the body writes
// C directly and nothing else is launched: the bits of the unsplit walk.
// The wrapper picks S (`split_k` in kernels/limb_matmul/ops.py) from the
// problem, the blocks, TK and the SM count — never from the limb count.
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
// it is passes * 2MKN / bf16 tensor-core rate.  Split-K fills the card with
// blocks (about two resident per SM); each block still keeps one TK-deep
// register prefetch in flight and nothing more (no TMA, no wgmma), and at
// M < 32 a warp whose 16 fragment rows lie wholly below the output skips
// its MMAs.  Measured times stand beside the bound in PERF.md.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

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

// Knuth's TwoSum, folded into a (sum, compensation) pair: s + c gains p
// with no rounding error lost.  Every add and subtract is an explicit
// round-to-nearest intrinsic, so the compiler can neither contract it into an
// FMA nor reassociate it away.
__device__ __forceinline__ void two_sum_fold(float& s, float& c, float p) {
  const float t = __fadd_rn(s, p);
  const float bb = __fsub_rn(t, s);
  c = __fadd_rn(c, __fadd_rn(__fsub_rn(s, __fsub_rn(t, bb)), __fsub_rn(p, bb)));
  s = t;
}

struct NoCompensation {};

// Steps of TK in the K walk of one thread block: bk slabs, TK steps in each.
__host__ __device__ inline int k_steps(int K, int bk, int tk) {
  const int gk = (K + bk - 1) / bk;
  const int per_slab = (bk + tk - 1) / tk;
  return (gk - 1) * per_slab + (K - (gk - 1) * bk + tk - 1) / tk;
}

// map == nullptr: every tile runs all KMAX-limb terms (the limb kernel).
// map_ndim == 2: map[(i * gn + j)];  map_ndim == 3: map[(i * gn + j) * gk + kk].
//
// Split s = blockIdx.z of gridDim.z runs its range of the K walk and writes
// its tile to C + s * M * N (C is the workspace when gridDim.z > 1).
//
// DD (compile-time): the double-f32 variant of the limb kernel.  Each
// fragment element carries a second f32 register, the compensation, and
// every term's partial sum over one K step is folded in with TwoSum instead
// of a plain add; at the end C receives hi = s + c and C_lo the rounding
// error of that sum.  With DD == false no compensation exists and the code
// is the plain limb datapath, so the limb and mode-map kernels are unchanged.
// The DD variant runs with gridDim.z == 1 only: C_lo is not split.
template <int KMAX, bool DD = false>
__device__ __forceinline__ void rmpm_gemm_body(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, const int* __restrict__ map, int map_ndim, int M,
    int N, int K, int bm, int bn, int bk, float* __restrict__ C_lo = nullptr) {
  using T = Tiling<KMAX>;
  constexpr int TK = T::TK;
  namespace wmma = nvcuda::wmma;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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
  // a warp whose 16 fragment rows all lie below the output runs no MMA: the
  // rows it would compute are never stored (warp-uniform)
  const bool idle = row0 + wr >= row_end;

  // this split's range [t_begin, t_end) of the block's K walk; step t lies
  // in slab t / per_slab at offset (t % per_slab) * TK
  const int per_slab = (bk + TK - 1) / TK;
  const int steps = k_steps(K, bk, TK);
  const int t_begin = (int)((long long)blockIdx.z * steps / gridDim.z);
  const int t_end = (int)((long long)(blockIdx.z + 1) * steps / gridDim.z);
  float* const out = C + (long long)blockIdx.z * M * N;

  Acc acc;
  wmma::fill_fragment(acc, 0.0f);
  std::conditional_t<DD, Acc, NoCompensation> comp;
  if constexpr (DD) wmma::fill_fragment(comp, 0.0f);

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

  auto step_k0 = [&](int t) { return (t / per_slab) * bk + (t % per_slab) * TK; };
  auto step_end = [&](int t) { return min((t / per_slab + 1) * bk, K); };
  const long long e_map = (long long)ti_map * gn + tj_map;

  if (t_begin < t_end) load_step(step_k0(t_begin), step_end(t_begin));
  for (int t = t_begin; t < t_end; ++t) {
    const int kk = t / per_slab;  // the step's slab: the map's third axis
    int k_tile = KMAX;
    if (map != nullptr) k_tile = (map_ndim == 3) ? map[e_map * gk + kk] : map[e_map];
    split_step();
    __syncthreads();
    if (t + 1 < t_end) load_step(step_k0(t + 1), step_end(t + 1));  // in flight during the MMAs
    if (!idle) {
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
            if constexpr (DD) {
#pragma unroll
              for (int e = 0; e < acc.num_elements; ++e)
                two_sum_fold(acc.x[e], comp.x[e], part.x[e]);
            } else {
#pragma unroll
              for (int e = 0; e < acc.num_elements; ++e)
                acc.x[e] = __fadd_rn(acc.x[e], part.x[e]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  auto store = [&](const Acc& frag, float* __restrict__ dst) {
    wmma::store_matrix_sync(&Cs[wr][wc], frag, CS_LD, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < TM * TN; idx += THREADS) {
      const int r = row0 + idx / TN;
      const int c = col0 + idx % TN;
      if (r < row_end && c < col_end) dst[(long long)r * N + c] = Cs[idx / TN][idx % TN];
    }
  };
  if constexpr (DD) {
    // renormalize: hi = s + c, lo = its rounding error (TwoSum of s and c)
#pragma unroll
    for (int e = 0; e < acc.num_elements; ++e) {
      float hi = acc.x[e], lo = 0.0f;
      two_sum_fold(hi, lo, comp.x[e]);
      acc.x[e] = hi;
      comp.x[e] = lo;
    }
    store(acc, out);
    __syncthreads();  // every thread has read Cs before it is reused
    store(comp, C_lo);
  } else {
    store(acc, out);
  }
}

// Grid of thread blocks covering every map tile of an (M, N) output, once
// for each of `splits` K splits.
inline dim3 gemm_grid(int M, int N, int bm, int bn, int splits = 1) {
  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  const int sub_m = (bm + TM - 1) / TM, sub_n = (bn + TN - 1) / TN;
  return dim3((unsigned)(gn * sub_n), (unsigned)(gm * sub_m), (unsigned)splits);
}

// A split count the entry points accept: 1, or up to the walk's T steps
// (65,535 at most, the grid's z limit) with a workspace to write.
inline bool splits_ok(int splits, const void* ws, int K, int bk, int tk) {
  return splits >= 1 && splits <= 65535 && splits <= k_steps(K, bk, tk) &&
         (splits == 1 || ws != nullptr);
}

namespace {  // one copy per translation unit

// C = ws[0] + ws[1] + ... + ws[splits-1], added in that order.
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, float* __restrict__ C,
              long long mn, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, ws[p * mn + i]);
    C[i] = s;
  }
}

// After the body's launch: its launch error, or the reduction's when the
// body wrote `splits` > 1 partial tiles to ws.  Same stream, no sync.
inline int finish_splits(float* C, const float* ws, int M, int N, int splits,
                         cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  const int blocks = (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  splitk_reduce<<<blocks, 256, 0, stream>>>(ws, C, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace rmpm
