// rmpm_gemm.cuh — the limb datapath shared by the limb kernel, the
// mode-map kernel and the double-f32 limb kernel.
//
// Both kernels compute  C (M,N) f32 = A (M,K) f32 @ B (K,N) f32  at limb
// precision: every operand element is read ONCE from device memory as f32,
// peeled on chip into bf16 limbs (a round-to-nearest cast and an exact f32
// subtraction; limbs never touch device memory), and the retained Karatsuba
// products  a_limb[ti] x b_limb[tj],  ti + tj < k_tile,  run as bf16 x bf16
// -> f32 tensor-core MMAs, high-order (small-magnitude) terms first — the
// term order of `limb_product_terms`.  Three device bodies do it:
//
//  * `rmpm_skinny_body<KMAX, NF>` — the weight-streaming body, for the limb
//    and mode-map kernels at M <= SKINNY_M_MAX (16) and KMAX <= 3: every
//    decode step of the serving path.  Bound: the weight's bytes.
//  * `rmpm_mma_body<KMAX>` — the tensor-core tile body, for the limb and
//    mode-map kernels at M > 16 and KMAX <= 3: every prefill, Whisper's
//    encoder frames and `apply` decoder, InternVL2's patch rows, the
//    planner's and tuner's square shapes.  Bound: the weight's bytes up to
//    M of about a hundred, the retained MMAs above.
//  * `rmpm_gemm_body<KMAX, DD>` — the tiled body, for the limb kernel at
//    4-6 limbs and the double-f32 kernel (DD) at every M.  Bound: a fixed
//    cost per K step and, for DD, the issue of its TwoSum folds.
//
// Which body runs depends on M only (and, for the limb kernel, on whether k
// is above the f32 ladder's three limbs: `use_skinny`, `use_mma`), never on
// the mode: a uniform map at mode m and the limb kernel at k = m run the
// same body, the same K walk and the same term order, so they give the same
// bits — the contract the TPU kernels hold by construction — and so does a
// run-time mode against a static one.
//
// What replaces what (TPU -> Hopper), in every body:
//  * the sequential K grid with an accumulator carried in scratch memory
//    becomes a loop over K inside the thread block, cut into S splits that
//    run as separate thread blocks (Split-K below);
//  * `(bm, bn, bk)` no longer sizes the tile that is resident on chip: it is
//    only the granularity of the mode map.  A thread block owns a piece of
//    ONE map tile (so it has one map entry per K slab), walks K in slabs of
//    bk and, inside a slab, in steps of TK;
//  * the scalar-prefetched map becomes a plain load: each block finds its
//    entry from its own coordinates;
//  * ragged edges are masked here (zero fill on load, guarded store), so
//    the wrapper pads nothing.
//
// Split-K.  At the decode shapes (M = a few rows) the (M, N) grid alone is a
// few dozen thread blocks on a 132-SM card.  So the grid has a third
// dimension of S splits.  The K walk of a block is one ordered list of steps
// — for slab kk, the steps k0 = kk*bk, kk*bk + TK, ... below
// min((kk+1)*bk, K) — and split s takes its contiguous range
// [s*T/S, (s+1)*T/S) of the T steps.  Each step keeps its slab, so the map
// entry of slab kk governs exactly its own steps, for a ragged last slab and
// for bk < TK alike.  Split s writes its f32 partial tile to a workspace
// [S, M, N]; `splitk_reduce` then adds the partials in the fixed order
// s = 0, 1, ..., S-1 with __fadd_rn and writes C (the DD kernel writes
// (hi, lo) pairs and `splitk_reduce_dd` folds them in the same order with
// TwoSum).  No float atomics and no last-block fixup: the order of every sum
// is fixed by the layout, never by timing, so run-to-run bits, uniform map
// == limb kernel and runtime == static hold at every S.  With S == 1 the
// body writes C directly and nothing else is launched.  The wrapper picks S
// (`split_k` in kernels/limb_matmul/ops.py) from the problem, the body's
// thread-block tile and residency, and the SM count — never from the limb
// count or the mode.
//
// Accumulation.  The tensor core adds into its accumulator with truncation,
// which would bias a long chain.  So each term's products over one K step of
// TK = 64 (32 above three limbs) go into a fresh fragment, and that partial
// sum is then added into the running f32 accumulator by the CUDA cores with
// round-to-nearest: the long chain over K is ordinary f32 summation.  Every
// body folds at the same grain, so the plain versions describe them all.
//
// The limb subtraction r - float(bf16(r)) is exact in f32 (the difference
// of a float and its own leading bits is representable), so it cannot be
// changed by contraction; `__fsub_rn` is used anyway because it is never
// fused into an FMA, which keeps the statement true by construction.
// No -use_fast_math: flushing denormals would change limb extraction.
//
// Bound on this card.  At the decode shapes the weight B is read once and
// dominates: the bound is bytes / memory rate, by about 50x (4x1024x2816 at
// k = 2: 3.4 us to read 11.5 MB against 0.07 us of bf16 MMAs).  For large M
// it is passes * 2MKN / bf16 tensor-core rate.
//
// The skinny body serves the bytes.  What held the tiled body back at
// M <= 16 was: a 32 x 32 tile of four 16 x 16 wmma fragments, of which two
// warps had no rows at M = 4 and the others 12 zero rows in 16; one K step
// of B in registers, one element a thread (8 KB in flight a block, about
// two blocks an SM at 255 registers: far below the ~30 KB an SM needs in
// flight at 3.35 TB/s and ~1 us of latency); and a fixed cost per K step —
// the peel into KMAX limb planes in shared memory between two barriers.
// The skinny body instead
//  * computes C^T = B^T A^T with `mma.sync.m16n8k16` (swap-AB): 16 weight
//    columns fill the MMA's 16-row side, the activation's rows its 8-column
//    side (NF = 1 fragment at M <= 8, 2 at M <= 16).  Each of a block's
//    four warps owns 16 of its SK_TN = 64 weight columns, so every warp works
//    at every M;
//  * streams raw f32 tiles of B (SK_TK x SK_TN) and A (16 x SK_TK) into a
//    ring of SK_STAGES = 3 stages in dynamic shared memory with `cp.async`
//    16-byte copies (4-byte copies with zero fill where the operand is not
//    16-byte aligned: base address, row length or block), two steps ahead
//    of the MMAs: 34 KB of weight in flight a block and three blocks an SM
//    (their 64.5 KB rings fit its 228 KB; `__launch_bounds__` holds the
//    registers to 168 a thread so that they fit too), ~100 KB an SM;
//  * peels limbs in registers: each lane reads its fragment elements as f32
//    from the ring (rows padded so those reads hit 32 distinct banks) and
//    peels pairs along K with `__floats2bfloat162_rn` and `__fsub_rn`, as
//    `peel4` does, so the limbs never touch shared memory;
//  * passes one barrier a K step, which both publishes the step's tiles and
//    frees the stage the next copies refill.
//
// The tensor-core tile body serves M > 16.  The tiled body held it at
// 0.03-0.24 of its bound there: its 32 x 32 tile fetched each weight element
// ceil(M/32) times (47 at M = 1500) and each activation element N/32 times,
// left two of four warps idle on a 16-row remainder, loaded one f32 element
// a thread with one K step in flight, and ran the map kernel's terms under a
// run-time count.  The body instead
//  * covers MM_TM x MM_TN = 64 x 128 outputs a block with eight warps of
//    32 x 32, each 2 x 4 `mma.sync.m16n8k16` fragments (bf16 in, f32 out).
//    At M <= 64 one row block covers all of M, so the weight streams once
//    a split, as in the skinny body; at M = 1500 each weight element is
//    fetched 24 times and each activation element N/128 times;
//  * streams raw f32 tiles of A (64 x 64) and B (64 x 128) into a ring of
//    MM_STAGES = 3 stages of dynamic shared memory with the skinny body's
//    `cp.async` copies (16 bytes, or 4 bytes with zero fill where the
//    operand is not 16-byte aligned): two K steps in flight;
//  * peels each step ONCE a block into three bf16 limb planes in shared
//    memory (`peel4`: float4 reads of the ring, 8-byte stores a limb), and
//    the warps read their fragments from the planes with `ldmatrix` (rows
//    padded so that an 8 x 8 read meets no bank conflict).  The ring and
//    the planes take 222 KB of the 227 a block may use: one block an SM.
//    Peeling in registers at fragment load instead, as the skinny body
//    does, with one barrier a step, has each warp peel its own fragments (A
//    four times a block, B twice) and read them as f32: with eight warps an
//    SM that ran at 0.09-0.14 of the bound at M = 1500 (PERF.md);
//  * passes two barriers a K step: one publishes the step's raw tiles and
//    frees the planes and the stage the next copies refill, one publishes
//    the planes.  One barrier would need the planes double-buffered, and
//    two sets of three planes beside a ring with two steps in flight do not
//    fit the 227 KB; with two sets, B's ring cut to one step in flight and
//    A's tile prefetched into registers, a one-barrier variant timed
//    0.98-1.14x this body (PERF.md), slower where the bytes bound it;
//  * reads each limb's fragments once a k16 slice and runs every retained
//    term on them, each term's four k16 MMAs over the step into a fresh
//    fragment that is then folded: the terms' partials of a 32 x 32 warp
//    tile take 96 registers at two limbs, so at three (192) the warp runs
//    its tile as two 32 x 16 halves.  Reloading the fragments for each term
//    (one fragment of partials at a time) would multiply the warps'
//    `ldmatrix` reads, a large share of the step's shared-memory traffic
//    beside the copies and the peel.  The peel and the terms of 1, 2 and 3
//    limbs are fully unrolled (`mma_step<KT>`): the mode-map kernel
//    branches on its map entry around them (`mma_step_upto`), so a uniform
//    map runs the limb kernel's instructions;
//  * stores its fragments straight from registers (float2 where the row
//    and the output allow it).
// `wgmma` is not used: its 64 x 128 accumulator takes 64 registers a thread
// a term, and the fold grain (a fresh accumulator a term and a step, added
// with round-to-nearest) with its asynchronous completion and the async
// proxy's fences is a larger step than this redesign; the planes it would
// read are these.  Measured times stand beside the bound in PERF.md.
//
// The tiled body keeps, for the limb kernel at 4-6 limbs and the double-f32
// kernel: a TM x TN = 32 x 32 thread-block tile of 16 x 16 wmma fragments,
// one TK-deep register prefetch in flight during the MMAs, and the peel
// into limb planes.  There a block's fixed cost per K step (two barriers,
// the peel) and, for the DD variant, the issue of its TwoSum folds (56 f32
// adds a term and a step in each thread) bound it.  A cp.async ring of
// three or four operand stages in place of the DD prefetch timed no faster
// for the DD kernel (PERF.md; `tools/dd_variants.py` rebuilds it as a
// variant), because the TwoSum folds, not the loads, bound it.
//
// The DD load path.  A thread loads and peels chunks of four consecutive
// elements: one 16-byte load when the operand allows it (16-byte aligned
// base, row length and bk or bn multiples of four: `vec_a` / `vec_b`), else
// up to four 4-byte loads, with elements out of range zero; `peel4` turns a
// chunk into its limbs with two bf16x2 conversions and one 8-byte store a
// limb.  The tiled body's limb instantiations (4-6 limbs) keep one element
// a thread.  Same limbs, same terms folded in the same order, so the load
// path changes no bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
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

// The weight-streaming body's geometry (see the top of this file).
constexpr int SKINNY_M_MAX = 16;  // largest M the skinny body serves
constexpr int SK_TM = 16;         // rows a block covers: NF n8 fragments
constexpr int SK_TN = 64;         // weight columns a block streams
constexpr int SK_TK = 64;         // K step: the fold grain, as Tiling<1..3>::TK
constexpr int SK_WARPS = 4;       // each owns 16 weight columns (one m16 tile)
constexpr int SK_THREADS = 32 * SK_WARPS;
constexpr int SK_STAGES = 3;      // ring stages: SK_STAGES - 1 steps in flight
constexpr int SK_BLOCKS_PER_SM = 3;  // resident blocks: ring and registers leave room
// Row strides of a ring stage, in floats: 16-byte multiples for the copies,
// and 2 * SK_B_LD = 8 (mod 32) and SK_A_LD = 8 (mod 32) so that a warp's
// fragment reads (rows 2t, columns g; rows g, columns 2t) hit 32 banks.
constexpr int SK_B_LD = SK_TN + 4;
constexpr int SK_A_LD = SK_TK + 8;
constexpr int SK_STAGE_FLOATS = SK_TK * SK_B_LD + SK_TM * SK_A_LD;
constexpr int SK_SMEM_BYTES = SK_STAGES * SK_STAGE_FLOATS * 4;  // dynamic
static_assert(SK_TN == 16 * SK_WARPS, "a warp owns one m16 tile of columns");
static_assert(SK_TK % 16 == 0 && SK_TM == 16, "k16 MMA steps, two n8 fragments");
// the blocks an SM holds at once: their rings and 1 KB each the runtime keeps
static_assert(SK_BLOCKS_PER_SM * (SK_SMEM_BYTES + 1024) <= 228 * 1024,
              "the ring leaves room for SK_BLOCKS_PER_SM blocks an SM");

// The tensor-core tile body's geometry (see the top of this file).
constexpr int MM_TM = 64;           // rows a block covers
constexpr int MM_TN = 128;          // columns a block covers
constexpr int MM_TK = 64;           // K step: the fold grain, as Tiling<1..3>::TK
constexpr int MM_WARPS_M = 2;       // warps along M, 32 rows each: two m16 fragments
constexpr int MM_WARPS_N = 4;       // warps along N, 32 columns each: four n8 fragments
constexpr int MM_THREADS = 32 * MM_WARPS_M * MM_WARPS_N;
constexpr int MM_STAGES = 3;        // raw ring stages: MM_STAGES - 1 steps in flight
constexpr int MM_LIMBS = 3;         // limb planes: the f32 ladder's most limbs
constexpr int MM_BLOCKS_PER_SM = 1;  // ring and planes take an SM's shared memory
// A ring stage holds A's MM_TM x MM_TK and B's MM_TK x MM_TN raw f32 tiles
// unpadded (the copies and the peel's float4 reads take whole rows).  A limb
// plane holds one limb of both tiles as bf16, rows padded by 8 elements: at
// 144 and 272 bytes a row, the eight rows of an `ldmatrix` 8 x 8 read fall
// in eight distinct 16-byte bank groups.
constexpr int MM_STAGE_FLOATS = MM_TM * MM_TK + MM_TK * MM_TN;
constexpr int MM_A_PL = MM_TK + 8;  // bf16 row stride of A's plane
constexpr int MM_B_PL = MM_TN + 8;  // bf16 row stride of B's plane
constexpr int MM_PLANE_ELEMS = MM_TM * MM_A_PL + MM_TK * MM_B_PL;  // bf16 a limb
// dynamic shared memory: the ring, then the planes
constexpr int MM_SMEM_BYTES = MM_STAGES * MM_STAGE_FLOATS * 4 + MM_LIMBS * MM_PLANE_ELEMS * 2;
static_assert(MM_TM == 32 * MM_WARPS_M && MM_TN == 32 * MM_WARPS_N, "32 x 32 a warp");
static_assert(MM_TK % 16 == 0 && MM_A_PL % 8 == 0 && MM_B_PL % 8 == 0 &&
                  (MM_STAGES * MM_STAGE_FLOATS) % 4 == 0 && MM_PLANE_ELEMS % 8 == 0,
              "k16 MMA steps; 16-byte rows, stages and planes");
// a block may use 227 KB; the blocks an SM holds at once, their rings and
// planes and 1 KB each the runtime keeps, fit its 228 KB
static_assert(MM_SMEM_BYTES <= 227 * 1024, "ring and planes fit one block's shared memory");
static_assert(MM_BLOCKS_PER_SM * (MM_SMEM_BYTES + 1024) <= 228 * 1024,
              "ring and planes leave room for MM_BLOCKS_PER_SM blocks an SM");

// cp.async from global to shared memory: `src_bytes` of the `bytes` are
// read, the rest of the destination is zero filled.  16 bytes go as .cg
// (L2 only), 4 bytes as .ca; the source must be aligned to `bytes`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the first `valid` of the four floats at src to dst and zero the rest:
// one 16-byte copy when `vec` (src then 16-byte aligned), else four 4-byte
// copies; `base`, always a valid address, stands in when none is read.
__device__ __forceinline__ void cp_async_chunk4(float* dst, const float* src, int valid,
                                                bool vec, const float* base) {
  if (vec) {
    cp_async16(dst, valid > 0 ? src : base, 4 * valid);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, e < valid ? src + e : base, e < valid ? 4 : 0);
  }
}

// Whether chunks of four of a row-major operand are 16-byte aligned: an
// aligned base, and rows (`ld`) and chunk starts (multiples of `blk`) at
// multiples of four floats.
__device__ __forceinline__ bool chunks16(const float* p, int ld, int blk) {
  return ((reinterpret_cast<uintptr_t>(p) & 15) | (ld & 3) | (blk & 3)) == 0;
}

// d (16 x 8 f32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, col-major):
// the PTX fragment layouts, lane = 4 * g + t: a holds rows g and g + 8,
// columns 2t, 2t + 1 (+ 8); b rows 2t, 2t + 1 (+ 8), column g; d rows g and
// g + 8, columns 2t, 2t + 1.  In each 32-bit register the lower column (a)
// or row (b) sits in the low half.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four 8 x 8 bf16 matrices whose rows lanes 8j .. 8j + 7 point at: lane
// 4g + t receives row g, elements 2t and 2t + 1 of matrix j in r[j] — with
// `trans`, column g, elements of rows 2t and 2t + 1.  Rows are 16 bytes,
// 16-byte aligned.  The "memory" clobber keeps the reads after the barrier
// that publishes them.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// Peel two f32 values (x at the lower K index) into KMAX bf16x2 limbs,
// limb l into out[l][slot]: the round-to-nearest conversion and exact
// subtraction of `peel4`, so the same limbs.
template <int KMAX, int SLOTS>
__device__ __forceinline__ void peel2(float x, float y, uint32_t (&out)[KMAX][SLOTS],
                                      int slot) {
#pragma unroll
  for (int l = 0; l < KMAX; ++l) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
    out[l][slot] = *reinterpret_cast<const uint32_t*>(&p);
    x = __fsub_rn(x, __low2float(p));
    y = __fsub_rn(y, __high2float(p));
  }
}

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

// Peel four consecutive f32 values into KMAX bf16 limbs: limb l of the four
// goes to dst + l * PLANE as one 8-byte store.  The same round-to-nearest
// conversion and exact subtraction as one value at a time (two values per
// cvt.rn.bf16x2), so the same limbs.
template <int KMAX, int PLANE>
__device__ __forceinline__ void peel4(float4 v, __nv_bfloat16* dst) {
#pragma unroll
  for (int l = 0; l < KMAX; ++l) {
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<const unsigned*>(&p0);
    w.y = *reinterpret_cast<const unsigned*>(&p1);
    *reinterpret_cast<uint2*>(dst + l * PLANE) = w;
    v.x = __fsub_rn(v.x, __low2float(p0));
    v.y = __fsub_rn(v.y, __high2float(p0));
    v.z = __fsub_rn(v.z, __low2float(p1));
    v.w = __fsub_rn(v.w, __high2float(p1));
  }
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
// of a plain add; at the end the split renormalizes its pair to hi = s + c
// and lo = the rounding error of that sum, and writes hi to C + s * M * N
// and lo to C_lo + s * M * N (C and C_lo are the two halves of the workspace
// when gridDim.z > 1; `splitk_reduce_dd` combines them).  Its operands come
// through the four-wide load path described at the top.  With DD == false
// no compensation exists and the load path is one element a thread, so the
// limb and mode-map kernels are unchanged.
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

  // The retained terms of one K step (those with ti + tj < k_tile), high
  // order first, each folded into the accumulator.
  auto mma_terms = [&](int k_tile) {
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
  };

  auto step_k0 = [&](int t) { return (t / per_slab) * bk + (t % per_slab) * TK; };
  auto step_end = [&](int t) { return min((t / per_slab + 1) * bk, K); };

  if constexpr (DD) {
    // One K step in registers, in chunks of four (the DD load path at the
    // top); 16-byte loads need an aligned base and rows and chunk starts
    // (k0 a multiple of bk, col0 of bn) at multiples of four.
    constexpr int A4 = T::A_PER_THREAD / 4;
    constexpr int B4 = T::B_PER_THREAD / 4;
    float4 ra4[A4];
    float4 rb4[B4];
    const bool vec_a = ((reinterpret_cast<uintptr_t>(A) & 15) | (K & 3) | (bk & 3)) == 0;
    const bool vec_b = ((reinterpret_cast<uintptr_t>(B) & 15) | (N & 3) | (bn & 3)) == 0;
    auto ld4 = [&](const float* src, int valid, bool vec) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vec && valid == 4) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        if (valid > 0) v.x = src[0];
        if (valid > 1) v.y = src[1];
        if (valid > 2) v.z = src[2];
        if (valid > 3) v.w = src[3];
      }
      return v;
    };
    auto load_step4 = [&](int t) {
      const int k0 = step_k0(t), k_end = step_end(t);
#pragma unroll
      for (int i = 0; i < A4; ++i) {
        const int q = (tid + i * THREADS) * 4;  // first element of the chunk
        const int r = row0 + q / TK;
        const int k = k0 + q % TK;
        const int valid = r < row_end ? max(0, min(4, k_end - k)) : 0;
        ra4[i] = ld4(A + (long long)r * K + k, valid, vec_a);
      }
#pragma unroll
      for (int i = 0; i < B4; ++i) {
        const int q = (tid + i * THREADS) * 4;
        const int k = k0 + q / TN;
        const int c = col0 + q % TN;
        const int valid = k < k_end ? max(0, min(4, col_end - c)) : 0;
        rb4[i] = ld4(B + (long long)k * N + c, valid, vec_b);
      }
    };
    // Peel the registers into the limb planes, four elements at a time.
    auto peel_regs = [&]() {
#pragma unroll
      for (int i = 0; i < A4; ++i) {
        const int q = (tid + i * THREADS) * 4;
        peel4<KMAX, TM * T::A_LD>(ra4[i], &As[0][q / TK][q % TK]);
      }
#pragma unroll
      for (int i = 0; i < B4; ++i) {
        const int q = (tid + i * THREADS) * 4;
        peel4<KMAX, TK * T::B_LD>(rb4[i], &Bs[0][q / TN][q % TN]);
      }
    };
    if (t_begin < t_end) load_step4(t_begin);
    for (int t = t_begin; t < t_end; ++t) {
      peel_regs();
      __syncthreads();
      if (t + 1 < t_end) load_step4(t + 1);  // in flight during the MMAs
      mma_terms(KMAX);
      __syncthreads();
    }
  } else {
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

    const long long e_map = (long long)ti_map * gn + tj_map;
    if (t_begin < t_end) load_step(step_k0(t_begin), step_end(t_begin));
    for (int t = t_begin; t < t_end; ++t) {
      const int kk = t / per_slab;  // the step's slab: the map's third axis
      int k_tile = KMAX;
      if (map != nullptr) k_tile = (map_ndim == 3) ? map[e_map * gk + kk] : map[e_map];
      split_step();
      __syncthreads();
      if (t + 1 < t_end) load_step(step_k0(t + 1), step_end(t + 1));  // in flight during the MMAs
      mma_terms(k_tile);
      __syncthreads();
    }
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
    store(comp, C_lo + (long long)blockIdx.z * M * N);
  } else {
    store(acc, out);
  }
}

// The weight-streaming body: the limb and mode-map kernels at M <=
// SKINNY_M_MAX and KMAX <= 3 (the design is at the top of this file).  The
// same arguments, K walk, split ranges, map lookup, terms, term order and
// fold grain as `rmpm_gemm_body`; a block covers SK_TM x SK_TN of ONE map
// tile, and its SK_THREADS threads run with SK_SMEM_BYTES of dynamic shared
// memory (allowed once per kernel by `allow_smem`).  NF = 1 serves
// M <= 8 with one n8 activation fragment, NF = 2 serves M <= 16.
template <int KMAX, int NF>
__device__ __forceinline__ void rmpm_skinny_body(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, const int* __restrict__ map, int map_ndim, int M,
    int N, int K, int bm, int bn, int bk) {
  static_assert(KMAX >= 1 && KMAX <= 3 && (NF == 1 || NF == 2), "f32 ladder, M <= 16");
  constexpr int TERMS = KMAX * (KMAX + 1) / 2;
  extern __shared__ __align__(16) float sk_ring[];

  const int sub_m = (bm + SK_TM - 1) / SK_TM;  // thread blocks per map tile, rows
  const int sub_n = (bn + SK_TN - 1) / SK_TN;
  const int gn = (N + bn - 1) / bn;
  const int gk = (K + bk - 1) / bk;
  const int ti_map = blockIdx.y / sub_m;
  const int tj_map = blockIdx.x / sub_n;
  const int row0 = ti_map * bm + (blockIdx.y % sub_m) * SK_TM;
  const int col0 = tj_map * bn + (blockIdx.x % sub_n) * SK_TN;
  const int row_end = min(min(row0 + SK_TM, (ti_map + 1) * bm), M);
  const int col_end = min(min(col0 + SK_TN, (tj_map + 1) * bn), N);
  if (row0 >= row_end || col0 >= col_end) return;  // whole block, uniformly

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;  // the fragments' group and thread
  const int wn = (tid >> 5) * 16;          // this warp's columns in the block
  const bool idle = col0 + wn >= col_end;  // warp-uniform: no column to store

  // this split's range [t_begin, t_end) of the block's K walk
  const int per_slab = (bk + SK_TK - 1) / SK_TK;
  const int steps = k_steps(K, bk, SK_TK);
  const int t_begin = (int)((long long)steps * blockIdx.z / gridDim.z);
  const int t_end = (int)((long long)steps * (blockIdx.z + 1) / gridDim.z);
  float* const out = C + (long long)blockIdx.z * M * N;
  const long long e_map = (long long)ti_map * gn + tj_map;

  // 16-byte copies need 16-byte-aligned chunks (k0 a multiple of bk, col0
  // of bn)
  const bool vec_a = chunks16(A, K, bk);
  const bool vec_b = chunks16(B, N, bn);
  // Issue step t's copies into ring stage st: B's SK_TK x SK_TN tile, then
  // A's SK_TM x SK_TK tile, in chunks of four; out of range is zero, which
  // adds exact zeros to the products.
  auto issue = [&](int t, int st) {
    float* const sb = sk_ring + st * SK_STAGE_FLOATS;
    float* const sa = sb + SK_TK * SK_B_LD;
    const int k0 = (t / per_slab) * bk + (t % per_slab) * SK_TK;
    const int k_end = min((t / per_slab + 1) * bk, K);
#pragma unroll
    for (int i = 0; i < SK_TK * SK_TN / 4 / SK_THREADS; ++i) {
      const int q = tid + i * SK_THREADS;
      const int r = q / (SK_TN / 4), c = (q % (SK_TN / 4)) * 4;
      const int k = k0 + r;
      const int valid = k < k_end ? max(0, min(4, col_end - (col0 + c))) : 0;
      cp_async_chunk4(sb + r * SK_B_LD + c, B + (long long)k * N + col0 + c, valid, vec_b, B);
    }
#pragma unroll
    for (int i = 0; i < SK_TM * SK_TK / 4 / SK_THREADS; ++i) {
      const int q = tid + i * SK_THREADS;
      const int r = q / (SK_TK / 4), c = (q % (SK_TK / 4)) * 4;
      const int valid = row0 + r < row_end ? max(0, min(4, k_end - (k0 + c))) : 0;
      cp_async_chunk4(sa + r * SK_A_LD + c, A + (long long)(row0 + r) * K + k0 + c, valid, vec_a,
                      A);
    }
  };

  // acc[f] is C^T's 16 x 8 fragment: columns wn + g (+ 8), rows 8f + 2tq (+ 1)
  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;

  // One K step on ring stage st: every retained term's products over the
  // step go into a fresh fragment of their own (k16 MMAs in K order), which
  // is then folded into acc with round-to-nearest, high order first.
  auto run_step = [&](int st, int k_tile) {
    const float* const sb = sk_ring + st * SK_STAGE_FLOATS;
    const float* const sa = sb + SK_TK * SK_B_LD;
    float part[TERMS][NF][4];
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[p][f][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < SK_TK; ks += 16) {
      // the weight's fragment (B^T: rows = columns wn + g (+ 8) of B, columns
      // = K ks + 2tq (+ 1) (+ 8)), peeled into limbs
      const float* const w = sb + (ks + 2 * tq) * SK_B_LD + wn + g;
      uint32_t wl[KMAX][4];
      peel2<KMAX, 4>(w[0], w[SK_B_LD], wl, 0);
      peel2<KMAX, 4>(w[8], w[SK_B_LD + 8], wl, 1);
      peel2<KMAX, 4>(w[8 * SK_B_LD], w[9 * SK_B_LD], wl, 2);
      peel2<KMAX, 4>(w[8 * SK_B_LD + 8], w[9 * SK_B_LD + 8], wl, 3);
      // the activation's fragments (A^T: K ks + 2tq (+ 1) (+ 8), row 8f + g)
      uint32_t xl[NF][KMAX][2];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float* const x = sa + (8 * f + g) * SK_A_LD + ks + 2 * tq;
        const float2 lo = *reinterpret_cast<const float2*>(x);
        const float2 hi = *reinterpret_cast<const float2*>(x + 8);
        peel2<KMAX, 2>(lo.x, lo.y, xl[f], 0);
        peel2<KMAX, 2>(hi.x, hi.y, xl[f], 1);
      }
      int p = 0;
#pragma unroll
      for (int s = KMAX - 1; s >= 0; --s) {
#pragma unroll
        for (int ti = 0; ti <= s; ++ti, ++p) {
          if (s < k_tile) {  // uniform across the block
#pragma unroll
            for (int f = 0; f < NF; ++f) mma_16816(part[p][f], wl[s - ti], xl[f][ti]);
          }
        }
      }
    }
    int p = 0;
#pragma unroll
    for (int s = KMAX - 1; s >= 0; --s) {
#pragma unroll
      for (int ti = 0; ti <= s; ++ti, ++p) {
        if (s < k_tile) {
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[f][e] = __fadd_rn(acc[f][e], part[p][f][e]);
        }
      }
    }
  };

  // The ring: steps i + 1 .. i + SK_STAGES - 1 are in flight while step i
  // runs.  One barrier a step: after it, step i's tiles are visible to every
  // thread, and every thread is done with step i - 1, whose stage the next
  // copies refill.
  // The map entry of step t: its slab's (the map's third axis), KMAX
  // without a map.  Each is loaded a step ahead of its use.
  auto tile_k = [&](int t) {
    if (map == nullptr) return KMAX;
    return (map_ndim == 3) ? map[e_map * gk + t / per_slab] : map[e_map];
  };
  const int n_steps = t_end - t_begin;
  int k_tile = n_steps > 0 ? tile_k(t_begin) : KMAX;
#pragma unroll
  for (int j = 0; j < SK_STAGES - 1; ++j) {
    if (j < n_steps) issue(t_begin + j, j);
    cp_async_commit();  // one group a step (empty past the range)
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<SK_STAGES - 2>();  // this thread's copies of step i have landed
    __syncthreads();
    const int j = i + SK_STAGES - 1;
    if (j < n_steps) issue(t_begin + j, j % SK_STAGES);
    cp_async_commit();
    const int k_next = i + 1 < n_steps ? tile_k(t_begin + i + 1) : KMAX;
    if (!idle) run_step(i % SK_STAGES, k_tile);
    k_tile = k_next;
  }
  cp_async_wait<0>();  // no copy outlives the block (only empty groups remain)

  // C^T's fragment stored transposed: element e of acc[f] is C[m][n] with
  // m = 8f + 2tq + (e & 1), n = wn + g + 8 * (e >> 1)
  if (!idle) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 8 * f + 2 * tq + (e & 1);
        const int c = col0 + wn + g + 8 * (e >> 1);
        if (r < row_end && c < col_end) out[(long long)r * N + c] = acc[f][e];
      }
  }
}

// One K step of the tensor-core tile body at KT limbs.  First the block
// peels the step's raw tiles (ring stage `raw`) into KT limb planes
// (`planes`), each thread four consecutive elements at a time (`peel4`),
// and passes a barrier; then every warp that has outputs runs the retained
// terms.  Each term's products over the step go into a fresh fragment of
// their own (k16 MMAs in K order, operands by `ldmatrix` from the planes),
// and the fragments are then folded into acc with round-to-nearest, high
// order first.  acc[mi][nj] is the m16 x n8 fragment at rows wm + 16 mi + g
// (+ 8), columns wn + 8 nj + 2t (+ 1) of the block.
template <int KT>
__device__ __forceinline__ void mma_step(const float* __restrict__ raw,
                                         __nv_bfloat16* __restrict__ planes,
                                         float (&acc)[2][4][4], bool idle, int wm, int wn) {
  const int tid = threadIdx.x, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < MM_TM * MM_TK / 4 / MM_THREADS; ++i) {
    const int q = tid + i * MM_THREADS;
    const int r = q / (MM_TK / 4), c = (q % (MM_TK / 4)) * 4;
    peel4<KT, MM_PLANE_ELEMS>(*reinterpret_cast<const float4*>(raw + r * MM_TK + c),
                              planes + r * MM_A_PL + c);
  }
#pragma unroll
  for (int i = 0; i < MM_TK * MM_TN / 4 / MM_THREADS; ++i) {
    const int q = tid + i * MM_THREADS;
    const int r = q / (MM_TN / 4), c = (q % (MM_TN / 4)) * 4;
    peel4<KT, MM_PLANE_ELEMS>(
        *reinterpret_cast<const float4*>(raw + MM_TM * MM_TK + r * MM_TN + c),
        planes + MM_TM * MM_A_PL + r * MM_B_PL + c);
  }
  __syncthreads();  // the planes are published
  if (idle) return;
  // The terms' partials of the warp's 32 x 32 tile take TERMS x 32
  // registers: 96 at two limbs; at three (192) the tile runs as two 32 x 16
  // halves.  Each limb's fragments are read once a k16 slice (and half).
  constexpr int TERMS = KT * (KT + 1) / 2;
  constexpr int NH = (KT == 3) ? 2 : 1;  // column halves
  constexpr int NJ = 4 / NH;             // n8 fragments a half
  // this lane's ldmatrix rows: A's rows wm + 16 mi + (lane % 16), K
  // (lane / 16) * 8; B's rows (K) lane % 8 + 8 ((lane / 8) % 2), columns
  // wn + 16 np + (lane / 16) * 8
  const int a_off = (wm + (lane & 15)) * MM_A_PL + (lane >> 4) * 8;
  const int b_off = MM_TM * MM_A_PL + ((lane & 7) + ((lane >> 3) & 1) * 8) * MM_B_PL + wn +
                    (lane >> 4) * 8;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float part[TERMS][2][NJ][4];
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[p][mi][nj][e] = 0.0f;
    // one k16 slice at a time: unrolled, ptxas hoists the slices' ldmatrix
    // reads and runs out of registers at two and three limbs
#pragma unroll 1
    for (int ks = 0; ks < MM_TK; ks += 16) {
      uint32_t a[KT][2][4], b[KT][NJ][2];
#pragma unroll
      for (int l = 0; l < KT; ++l) {
        const __nv_bfloat16* const pl = planes + l * MM_PLANE_ELEMS;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(a[l][mi], pl + a_off + 16 * mi * MM_A_PL + ks);
#pragma unroll
        for (int np = 0; np < NJ / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, pl + b_off + ks * MM_B_PL + 16 * (h * NJ / 2 + np));
          b[l][2 * np][0] = r[0];
          b[l][2 * np][1] = r[1];
          b[l][2 * np + 1][0] = r[2];
          b[l][2 * np + 1][1] = r[3];
        }
      }
      int p = 0;
#pragma unroll
      for (int s = KT - 1; s >= 0; --s)
#pragma unroll
        for (int ti = 0; ti <= s; ++ti, ++p)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int nj = 0; nj < NJ; ++nj) mma_16816(part[p][mi][nj], a[ti][mi], b[s - ti][nj]);
    }
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][h * NJ + nj][e] = __fadd_rn(acc[mi][h * NJ + nj][e], part[p][mi][nj][e]);
  }
}

// The step at a map entry of k_tile limbs (KMAX without a map): the fully
// unrolled peel and terms of min(k_tile, KMAX) limbs, nothing at k_tile < 1
// (block-uniform, so every thread passes the same barriers).  The limb
// kernel's k_tile is the constant KMAX, so it runs mma_step<KMAX> alone.
template <int KMAX>
__device__ __forceinline__ void mma_step_upto(int k_tile, const float* __restrict__ raw,
                                              __nv_bfloat16* __restrict__ planes,
                                              float (&acc)[2][4][4], bool idle, int wm,
                                              int wn) {
  if (k_tile >= KMAX) {
    mma_step<KMAX>(raw, planes, acc, idle, wm, wn);
  } else if constexpr (KMAX > 1) {
    mma_step_upto<KMAX - 1>(k_tile, raw, planes, acc, idle, wm, wn);
  }
}

// The tensor-core tile body: the limb and mode-map kernels at M >
// SKINNY_M_MAX and KMAX <= 3 (the design is at the top of this file).  The
// same arguments, K walk, split ranges, map lookup, terms, term order and
// fold grain as the other bodies; a block covers MM_TM x MM_TN of ONE map
// tile, and its MM_THREADS threads run with MM_SMEM_BYTES of dynamic shared
// memory (allowed once per kernel by `allow_smem`).
template <int KMAX>
__device__ __forceinline__ void rmpm_mma_body(
    const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ C, const int* __restrict__ map, int map_ndim, int M,
    int N, int K, int bm, int bn, int bk) {
  static_assert(KMAX >= 1 && KMAX <= 3, "the f32 ladder");
  extern __shared__ __align__(16) float mm_ring[];

  const int sub_m = (bm + MM_TM - 1) / MM_TM;  // thread blocks per map tile, rows
  const int sub_n = (bn + MM_TN - 1) / MM_TN;
  const int gn = (N + bn - 1) / bn;
  const int gk = (K + bk - 1) / bk;
  const int ti_map = blockIdx.y / sub_m;
  const int tj_map = blockIdx.x / sub_n;
  const int row0 = ti_map * bm + (blockIdx.y % sub_m) * MM_TM;
  const int col0 = tj_map * bn + (blockIdx.x % sub_n) * MM_TN;
  const int row_end = min(min(row0 + MM_TM, (ti_map + 1) * bm), M);
  const int col_end = min(min(col0 + MM_TN, (tj_map + 1) * bn), N);
  if (row0 >= row_end || col0 >= col_end) return;  // whole block, uniformly

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the fragments' group and thread
  __nv_bfloat16* const planes =
      reinterpret_cast<__nv_bfloat16*>(mm_ring + MM_STAGES * MM_STAGE_FLOATS);
  const int wm = (warp / MM_WARPS_N) * 32;  // this warp's tile in the block
  const int wn = (warp % MM_WARPS_N) * 32;
  // warp-uniform: no row or no column of the warp's tile is stored
  const bool idle = row0 + wm >= row_end || col0 + wn >= col_end;

  // this split's range [t_begin, t_end) of the block's K walk
  const int per_slab = (bk + MM_TK - 1) / MM_TK;
  const int steps = k_steps(K, bk, MM_TK);
  const int t_begin = (int)((long long)steps * blockIdx.z / gridDim.z);
  const int t_end = (int)((long long)steps * (blockIdx.z + 1) / gridDim.z);
  float* const out = C + (long long)blockIdx.z * M * N;
  const long long e_map = (long long)ti_map * gn + tj_map;

  const bool vec_a = chunks16(A, K, bk);
  const bool vec_b = chunks16(B, N, bn);
  // Issue step t's copies into ring stage st: A's MM_TM x MM_TK tile, then
  // B's MM_TK x MM_TN tile, in chunks of four; out of range is zero, which
  // adds exact zeros to the products.
  auto issue = [&](int t, int st) {
    float* const sa = mm_ring + st * MM_STAGE_FLOATS;
    float* const sb = sa + MM_TM * MM_TK;
    const int k0 = (t / per_slab) * bk + (t % per_slab) * MM_TK;
    const int k_end = min((t / per_slab + 1) * bk, K);
#pragma unroll
    for (int i = 0; i < MM_TM * MM_TK / 4 / MM_THREADS; ++i) {
      const int q = tid + i * MM_THREADS;
      const int r = q / (MM_TK / 4), c = (q % (MM_TK / 4)) * 4;
      const int valid = row0 + r < row_end ? max(0, min(4, k_end - (k0 + c))) : 0;
      cp_async_chunk4(sa + r * MM_TK + c, A + (long long)(row0 + r) * K + k0 + c, valid,
                      vec_a, A);
    }
#pragma unroll
    for (int i = 0; i < MM_TK * MM_TN / 4 / MM_THREADS; ++i) {
      const int q = tid + i * MM_THREADS;
      const int r = q / (MM_TN / 4), c = (q % (MM_TN / 4)) * 4;
      const int k = k0 + r;
      const int valid = k < k_end ? max(0, min(4, col_end - (col0 + c))) : 0;
      cp_async_chunk4(sb + r * MM_TN + c, B + (long long)k * N + col0 + c, valid, vec_b, B);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;

  // The ring: steps i + 1 .. i + MM_STAGES - 1 are in flight while step i
  // is peeled and run.  Two barriers a step: the first publishes step i's
  // raw tiles and frees both the planes (every warp is done with step
  // i - 1's MMAs) and the stage of step i - 1, which the next copies refill;
  // the second, in mma_step, publishes the planes.
  // The map entry of step t is its slab's (the map's third axis), KMAX
  // without a map, each loaded a step ahead of its use.
  auto tile_k = [&](int t) {
    if (map == nullptr) return KMAX;
    return (map_ndim == 3) ? map[e_map * gk + t / per_slab] : map[e_map];
  };
  const int n_steps = t_end - t_begin;
  int k_tile = n_steps > 0 ? tile_k(t_begin) : KMAX;
#pragma unroll
  for (int j = 0; j < MM_STAGES - 1; ++j) {
    if (j < n_steps) issue(t_begin + j, j);
    cp_async_commit();  // one group a step (empty past the range)
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<MM_STAGES - 2>();  // this thread's copies of step i have landed
    __syncthreads();
    const int j = i + MM_STAGES - 1;
    if (j < n_steps) issue(t_begin + j, j % MM_STAGES);
    cp_async_commit();
    const int k_next = i + 1 < n_steps ? tile_k(t_begin + i + 1) : KMAX;
    mma_step_upto<KMAX>(k_tile, mm_ring + (i % MM_STAGES) * MM_STAGE_FLOATS, planes, acc,
                        idle, wm, wn);
    k_tile = k_next;
  }
  cp_async_wait<0>();  // no copy outlives the block (only empty groups remain)

  // the fragments stored from registers: rows g and g + 8 of each, columns
  // 2tq and 2tq + 1 as one float2 where the output allows it
  if (!idle) {
    const bool vec_c = ((reinterpret_cast<uintptr_t>(out) & 7) | (N & 1) | (bn & 1)) == 0;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + wm + 16 * mi + g + 8 * hh;
          const int c = col0 + wn + 8 * nj + 2 * tq;
          if (r >= row_end) continue;
          float* const dst = out + (long long)r * N + c;
          const float x = acc[mi][nj][2 * hh], y = acc[mi][nj][2 * hh + 1];
          if (vec_c && c + 1 < col_end) {
            *reinterpret_cast<float2*>(dst) = make_float2(x, y);
          } else {
            if (c < col_end) dst[0] = x;
            if (c + 1 < col_end) dst[1] = y;
          }
        }
  }
}

// Grid of a body whose blocks cover BM_ x BN_ outputs: one block per
// BM_ x BN_ piece of each map tile, once for each of `splits` K splits.
template <int BM_, int BN_>
inline dim3 body_grid(int M, int N, int bm, int bn, int splits) {
  const int gm = (M + bm - 1) / bm, gn = (N + bn - 1) / bn;
  const int sub_m = (bm + BM_ - 1) / BM_, sub_n = (bn + BN_ - 1) / BN_;
  return dim3((unsigned)(gn * sub_n), (unsigned)(gm * sub_m), (unsigned)splits);
}

// Allow a kernel the `bytes` of dynamic shared memory of its ring (more than
// the 48 KB a launch gets unasked) and prefer the largest shared-memory
// carveout, so that its blocks an SM fit.  Once per kernel and device,
// before the first launch (and so before any capture): never per launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// The body a limb or mode-map launch of M rows at `limbs` (kmax) runs: the
// skinny body, the tensor-core tile body, or else (4-6 limbs) the tiled one.
inline bool use_skinny(int M, int limbs) { return M <= SKINNY_M_MAX && limbs <= 3; }
inline bool use_mma(int M, int limbs) { return M > SKINNY_M_MAX && limbs <= 3; }

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

// hi, lo = the double-f32 kernel's split pairs combined in the order
// s = 0, 1, ..., S-1: (s, c) = (hi_0, lo_0); each later hi_s is folded in
// with TwoSum and lo_s added to c; the pair is renormalized at the end.
// ws holds the hi halves [S, M, N], then the lo halves [S, M, N].
__global__ void __launch_bounds__(256)
splitk_reduce_dd(const float* __restrict__ ws, float* __restrict__ hi,
                 float* __restrict__ lo, long long mn, int splits) {
  const float* __restrict__ ws_lo = ws + splits * mn;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i], c = ws_lo[i];
    for (int p = 1; p < splits; ++p) {
      two_sum_fold(s, c, ws[p * mn + i]);
      c = __fadd_rn(c, ws_lo[p * mn + i]);
    }
    float h = s, l = 0.0f;
    two_sum_fold(h, l, c);
    hi[i] = h;
    lo[i] = l;
  }
}

inline int reduce_blocks(long long mn) {
  return (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
}

// After the body's launch: its launch error, or the reduction's when the
// body wrote `splits` > 1 partial tiles to ws.  Same stream, no sync.  With
// `lo` (the double-f32 kernel) ws holds (hi, lo) pairs, which
// `splitk_reduce_dd` folds into C and lo; else `splitk_reduce` adds them.
inline int finish_splits(float* C, const float* ws, int M, int N, int splits,
                         cudaStream_t stream, float* lo = nullptr) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  if (lo == nullptr)
    splitk_reduce<<<reduce_blocks(mn), 256, 0, stream>>>(ws, C, mn, splits);
  else
    splitk_reduce_dd<<<reduce_blocks(mn), 256, 0, stream>>>(ws, C, lo, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace rmpm
