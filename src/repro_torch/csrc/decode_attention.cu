// decode_attention — one query a row (Sq = 1) over a bf16 KV cache: the
// scores q.K and the values p.V of `models/layers.py::flash_attention` at
// the precision of their modes, in one pass over the cache.
//
// It replaces no TPU kernel.  The reference's attention is plain limb algebra
// (`repro/models/layers.py::flash_attention`: a chunk loop of limb einsums),
// which the port ran as it is: for every 1,024-row chunk of every slot's
// whole cache, an f32 copy of the chunk, its limbs split by elementwise ops,
// and one permuted f32 product per retained term, for q.K and again for p.V.
// At decode that loop read the cache many times over and took most of the
// step (PERF.md).  This kernel was added to compute the same thing at the
// cost of one read of the cache's valid rows.
//
// What it computes.  q (f32, after RoPE) is scaled by hd^-0.5 in f32 and
// split on chip into the attn_qk mode's `lq` bf16 limbs; each score is the sum
// over that mode's retained limb products, each exact in f32, folded in the
// term order of `limb_product_terms` (high-order first).  A bf16 cache value
// is its own first limb and its later limbs are exactly 0, so only the terms
// (i, 0) are nonzero: score = t_{lq-1} + ... + t_0, t_i = sum_d q_i[d] k[d].
// A site's mode is static (its limb count an argument) or bound at run time:
// an int32 device scalar the kernel reads, as an adaptive engine's captured
// step binds it, so a mode change between replays needs no new launch.
// A key is valid where its position is >= 0, at most the query's (causal),
// and above the query's minus `window` (when set), read on the device from
// the positions, so a captured graph needs no host value.  The softmax is
// taken in f32 per partition of DA_PART columns against the partition's
// max; p is split into the attn_av mode's `lv` limbs and sum_c p_i[c] v[c]
// folded in term order the same way.  A second kernel combines the
// partitions' (max, sum, acc) in f32, as the chunk loop combines its chunks.
//
// What bounds it on this card: bytes.  Each valid K and V row is read once
// (hd bf16 each); the operations are (lq + lv) FMAs a key element per query
// head, far below the FMA rate at G <= 16 query heads a KV head, so CUDA
// cores do them and tensor cores are not needed.  The design follows:
//   * flash-decoding: the grid is (column partition, slot x KV head), so
//     even 16 slots x 8 KV heads give hundreds of blocks, and one block reads
//     each K/V tile once for all G query heads of its KV head;
//   * a partition reads its columns' positions first (4 bytes a column
//     against 2 x hd x 2 bytes of K/V) and skips every 64-column tile with
//     no valid key; a partition with none reads no K/V at all and is marked
//     empty for the combine.  The decision is made on the device because the
//     decode step is a CUDA graph whose grid is fixed at capture;
//   * K and V tiles stream through a two-stage `cp.async` ring of 16-byte
//     copies; an invalid row is zero filled and not read;
//   * tile rows are padded by 16 bytes, so the 16-byte reads of eight rows
//     at one offset fall in eight distinct bank groups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// cp.async of 16 bytes from global to shared memory (L2 only); with
// `src_bytes` 0 nothing is read and the destination is zero filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
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

constexpr int DA_THREADS = 128;
constexpr int DA_PART = 256;  // cache columns a block covers
constexpr int DA_TILE = 64;   // columns a ring stage holds
constexpr int DA_TILES = DA_PART / DA_TILE;
constexpr int DA_GMAX = 16;   // query heads a KV head
constexpr int DA_HDMAX = 256;
constexpr int DA_LIMBS = 3;   // the f32 ladder's most limbs

struct Args {
  const float* q;  // (B, Hkv * G, hd) f32
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long k_sb, k_sr, v_sb, v_sr;  // batch and row strides, in elements
  const int* q_pos;                  // (B,)
  const int* kv_pos;                 // row b at b * pos_sb
  long long pos_sb;
  float* ws_acc;  // (B * Hkv, np, G, hd)
  float* ws_ml;   // (B * Hkv, np, G, 2): the partition's max and sum
  float* out;     // (B, Hkv * G, hd)
  // the sites' modes bound at run time (int32 device scalars, read by the
  // kernel), or null where the mode is static
  const int* qk_mode;
  const int* av_mode;
  int B, S, Hkv, G, hd, np;
  int lq, lv, rounding, causal, window;  // lq, lv: static limbs, or 3 where bound
  float scale;
};

// A site's limbs: the static count, or a bound mode's: 1 for M8 (and
// below), 2 for M16, 3 for M24 (and above), clamped to the ladder as
// `core.rmpm._mode_select` clamps (`limbs` is then the ladder's top), so a
// device scalar and the same mode given as a host int run the same sums.
__device__ __forceinline__ int bound_limbs(const int* mode, int limbs) {
  return mode == nullptr ? limbs : min(max(*mode, 1), limbs);
}

// Floats of shared memory ahead of the tile ring: q's limbs [lq][G][hd], the
// scores then p's limbs [lv][G][DA_PART], the validity of each column, the
// valid columns of each tile, and each head's max and sum; rounded up to 16
// bytes.
__host__ __device__ inline int head_floats(int lq, int lv, int G, int hd) {
  const int n = lq * G * hd + lv * G * DA_PART + DA_PART + DA_TILES + 2 * G;
  return (n + 3) & ~3;
}

__host__ __device__ inline int tile_pitch(int hd) { return hd + 8; }  // bf16 a row

__host__ __device__ inline int smem_bytes(int lq, int lv, int G, int hd) {
  return head_floats(lq, lv, G, hd) * 4 + 2 * DA_TILE * tile_pitch(hd) * 2;
}

// The next bf16 limb of r, returned as f32 (exact): round to nearest even
// (rounding 2, the hardware cast), or keep 7 mantissa bits by truncation (0)
// or the paper's G & (R | T | E) (1), as `core.rounding.quantize_mantissa`
// does before its exact cast; non-finite values pass through.
__device__ __forceinline__ float bf16_limb(float r, int rounding) {
  if (rounding == 2) return __bfloat162float(__float2bfloat16_rn(r));
  const unsigned xi = __float_as_uint(r);
  if (((xi >> 23) & 0xFFu) == 0xFFu) return __bfloat162float(__float2bfloat16_rn(r));
  const unsigned kept = xi & 0xFFFF0000u;
  if (rounding == 0) return __uint_as_float(kept);
  const unsigned g = (xi >> 15) & 1u, rr = (xi >> 14) & 1u, e = (xi >> 13) & 1u;
  const unsigned t = (xi & 0x1FFFu) != 0u ? 1u : 0u;
  return __uint_as_float(kept + (g & (rr | t | e)) * 0x10000u);
}

__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Issue the copies of one tile (DA_TILE rows of hd bf16) of K or V into a
// ring stage: rows past the cache or without a valid key are zero filled and
// not read.
__device__ __forceinline__ void load_tile(const Args& a, const __nv_bfloat16* base, long long sb,
                                          long long sr, int b, int h, int col0,
                                          const int* valid, __nv_bfloat16* dst) {
  const int chunks = a.hd / 8;
  const int pitch = tile_pitch(a.hd);
  for (int i = threadIdx.x; i < DA_TILE * chunks; i += DA_THREADS) {
    const int r = i / chunks, ch = i - r * chunks;
    const bool ok = valid[r] != 0;
    const __nv_bfloat16* src =
        ok ? base + b * sb + (long long)(col0 + r) * sr + (long long)h * a.hd + ch * 8 : base;
    cp_async16(dst + r * pitch + ch * 8, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// One block: one (slot, KV head) over one partition of DA_PART columns.
// OPT: the pairs of output columns a thread owns in the value phase,
// ceil(G * hd / 2 / DA_THREADS) rounded up to a power of two.
template <int OPT>
__global__ void __launch_bounds__(DA_THREADS)
    decode_attn_partial_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int part = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int G = a.G, hd = a.hd, tid = threadIdx.x;
  const int lq = bound_limbs(a.qk_mode, a.lq), lv = bound_limbs(a.av_mode, a.lv);
  const int c0 = part * DA_PART;
  const int ncols = min(DA_PART, a.S - c0);
  float* qs = reinterpret_cast<float*>(smem);  // [lq][G][hd]
  float* pl = qs + a.lq * G * hd;              // [lv][G][DA_PART]
  int* valid = reinterpret_cast<int*>(pl + a.lv * G * DA_PART);  // [DA_PART]
  int* tcount = valid + DA_PART;                                   // [DA_TILES]
  float* red = reinterpret_cast<float*>(tcount + DA_TILES);        // max [G], sum [G]
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(qs + head_floats(a.lq, a.lv, G, hd));
  const int pitch = tile_pitch(hd);
  float* ml = a.ws_ml + ((long long)bh * a.np + part) * G * 2;

  // which columns hold a key this row's query may see
  const int qp = a.q_pos[b];
  if (tid < DA_TILES) tcount[tid] = 0;
  __syncthreads();
  for (int c = tid; c < DA_PART; c += DA_THREADS) {
    int ok = 0;
    if (c < ncols) {
      const int p = a.kv_pos[b * a.pos_sb + c0 + c];
      ok = p >= 0 && (!a.causal || p <= qp) && (a.window == 0 || p > qp - a.window);
    }
    valid[c] = ok;
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, ok);
    if ((tid & 31) == 0 && votes) atomicAdd(&tcount[c / DA_TILE], __popc(votes));
  }
  __syncthreads();
  int tiles[DA_TILES];
  int nt = 0;
#pragma unroll
  for (int t = 0; t < DA_TILES; ++t)
    if (tcount[t] > 0) tiles[nt++] = t;
  if (nt == 0) {  // no valid key: read nothing, mark the partition empty
    if (tid < G) {
      ml[2 * tid] = -INFINITY;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  // the first tile's copies overlap the q limbs
  load_tile(a, a.k, a.k_sb, a.k_sr, b, h, c0 + tiles[0] * DA_TILE, valid + tiles[0] * DA_TILE,
            ring);
  for (int i = tid; i < G * hd; i += DA_THREADS) {
    const int g = i / hd, d = i - g * hd;
    float r = __fmul_rn(a.q[((long long)b * a.Hkv * G + (long long)h * G + g) * hd + d], a.scale);
#pragma unroll
    for (int l = 0; l < DA_LIMBS; ++l) {
      if (l < lq) {
        const float li = bf16_limb(r, a.rounding);
        qs[(l * G + g) * hd + d] = li;
        r = __fsub_rn(r, li);
      }
    }
  }

  float acc[DA_LIMBS][OPT][2];
#pragma unroll
  for (int l = 0; l < DA_LIMBS; ++l)
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[l][j][0] = acc[l][j][1] = 0.f;
  const int hd2 = hd / 2;

  // 2 * nt ring steps: K tiles, then V tiles; step s + 1 is in flight while
  // step s is consumed
  for (int s = 0; s < 2 * nt; ++s) {
    if (s + 1 < 2 * nt) {
      const int t = tiles[(s + 1) % nt];
      const bool is_k = s + 1 < nt;
      load_tile(a, is_k ? a.k : a.v, is_k ? a.k_sb : a.v_sb, is_k ? a.k_sr : a.v_sr, b, h,
                c0 + t * DA_TILE, valid + t * DA_TILE, ring + ((s + 1) & 1) * DA_TILE * pitch);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tile = ring + (s & 1) * DA_TILE * pitch;
    const int col0 = tiles[s % nt] * DA_TILE;
    if (s < nt) {
      // scores of the tile's valid columns, one (column, head) a thread
      for (int i = tid; i < DA_TILE * G; i += DA_THREADS) {
        const int g = i / DA_TILE, r = i - g * DA_TILE;
        if (!valid[col0 + r]) continue;
        float t[DA_LIMBS] = {0.f, 0.f, 0.f};
        const __nv_bfloat16* krow = tile + r * pitch;
        for (int d = 0; d < hd; d += 8) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(krow + d), kf);
#pragma unroll
          for (int l = 0; l < DA_LIMBS; ++l) {
            if (l < lq) {
              const float* qq = qs + (l * G + g) * hd + d;
              const float4 q0 = *reinterpret_cast<const float4*>(qq);
              const float4 q1 = *reinterpret_cast<const float4*>(qq + 4);
              // each product of two bf16 values is exact in f32
              t[l] = fmaf(q0.x, kf[0], t[l]);
              t[l] = fmaf(q0.y, kf[1], t[l]);
              t[l] = fmaf(q0.z, kf[2], t[l]);
              t[l] = fmaf(q0.w, kf[3], t[l]);
              t[l] = fmaf(q1.x, kf[4], t[l]);
              t[l] = fmaf(q1.y, kf[5], t[l]);
              t[l] = fmaf(q1.z, kf[6], t[l]);
              t[l] = fmaf(q1.w, kf[7], t[l]);
            }
          }
        }
        float sc = 0.f;  // high-order terms first
#pragma unroll
        for (int l = DA_LIMBS - 1; l >= 0; --l)
          if (l < lq) sc = l == lq - 1 ? t[l] : __fadd_rn(sc, t[l]);
        pl[g * DA_PART + col0 + r] = sc;
      }
      if (s == nt - 1) {
        // every score is in: each head's max, p = exp(s - max), its sum and
        // limbs (an invalid column's p is 0), one warp a head
        __syncthreads();
        const int lane = tid & 31;
        for (int g = tid >> 5; g < G; g += DA_THREADS / 32) {
          float m = -INFINITY;
          for (int c = lane; c < DA_PART; c += 32)
            if (valid[c]) m = fmaxf(m, pl[g * DA_PART + c]);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
          float sum = 0.f;
          for (int c = lane; c < DA_PART; c += 32) {
            float r = valid[c] ? expf(__fsub_rn(pl[g * DA_PART + c], m)) : 0.f;
            sum += r;
#pragma unroll
            for (int l = 0; l < DA_LIMBS; ++l) {
              if (l < lv) {
                const float li = bf16_limb(r, a.rounding);
                pl[(l * G + g) * DA_PART + c] = li;
                r = __fsub_rn(r, li);
              }
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
          if (lane == 0) {
            red[g] = m;
            red[G + g] = sum;
          }
        }
      }
    } else {
      // values: each thread owns OPT (head, column pair)s of the output
#pragma unroll
      for (int j = 0; j < OPT; ++j) {
        const int o = tid + j * DA_THREADS;
        if (o < G * hd2) {
          const int g = o / hd2, d = 2 * (o - g * hd2);
          for (int r = 0; r < DA_TILE; ++r) {
            const float2 vv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(tile + r * pitch + d));
#pragma unroll
            for (int l = 0; l < DA_LIMBS; ++l) {
              if (l < lv) {
                const float p = pl[(l * G + g) * DA_PART + col0 + r];
                acc[l][j][0] = fmaf(p, vv.x, acc[l][j][0]);
                acc[l][j][1] = fmaf(p, vv.y, acc[l][j][1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copies of step s + 2
  }

  float* wacc = a.ws_acc + ((long long)bh * a.np + part) * G * hd;
#pragma unroll
  for (int j = 0; j < OPT; ++j) {
    const int o = tid + j * DA_THREADS;
    if (o < G * hd2) {
      const int g = o / hd2, d = 2 * (o - g * hd2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sum = 0.f;  // high-order terms first
#pragma unroll
        for (int l = DA_LIMBS - 1; l >= 0; --l)
          if (l < lv) sum = l == lv - 1 ? acc[l][j][e] : __fadd_rn(sum, acc[l][j][e]);
        wacc[g * hd + d + e] = sum;
      }
    }
  }
  if (tid < G) {
    ml[2 * tid] = red[tid];
    ml[2 * tid + 1] = red[G + tid];
  }
}

// One block a (slot, KV head): out = sum_p w_p acc_p / max(sum_p w_p l_p,
// 1e-30) with w_p = exp(m_p - max_p m_p) over the non-empty partitions (0
// where every partition is empty, which a decode step never gives: the
// query's own key is in the cache).
__global__ void __launch_bounds__(DA_THREADS) decode_attn_combine_kernel(const Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.Hkv, h = bh - b * a.Hkv;
  const int G = a.G, hd = a.hd;
  const float* ml = a.ws_ml + (long long)bh * a.np * G * 2;
  const float* wacc = a.ws_acc + (long long)bh * a.np * G * hd;
  for (int o = threadIdx.x; o < G * hd; o += DA_THREADS) {
    const int g = o / hd, d = o - g * hd;
    float m = -INFINITY;
    for (int p = 0; p < a.np; ++p) m = fmaxf(m, ml[(p * G + g) * 2]);
    float l = 0.f, acc = 0.f;
    if (m > -INFINITY) {
      for (int p = 0; p < a.np; ++p) {
        const float mp = ml[(p * G + g) * 2];
        if (mp > -INFINITY) {
          const float w = expf(mp - m);
          l += w * ml[(p * G + g) * 2 + 1];
          acc += w * wacc[(p * G + g) * hd + d];
        }
      }
    }
    a.out[((long long)b * a.Hkv * G + (long long)h * G + g) * hd + d] =
        m > -INFINITY ? acc / fmaxf(l, 1e-30f) : 0.f;
  }
}

template <int OPT>
cudaError_t launch_partial(const Args& a, dim3 grid, int smem, cudaStream_t s) {
  decode_attn_partial_kernel<OPT><<<grid, DA_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

constexpr int DA_SMEM_MAX = (DA_LIMBS * DA_GMAX * DA_HDMAX + DA_LIMBS * DA_GMAX * DA_PART +
                             DA_PART + DA_TILES + 2 * DA_GMAX + 3) / 4 * 4 * 4 +
                            2 * DA_TILE * (DA_HDMAX + 8) * 2;
static_assert(DA_SMEM_MAX <= 227 * 1024, "the largest instantiation fits one block");

}  // namespace

// q (B, Hkv * G, hd) f32 contiguous; k, v bf16 with row (b, c, h) at
// b * sb + c * sr + h * hd and hd contiguous elements (16-byte aligned);
// q_pos (B,) and kv_pos (row b at b * pos_sb, S columns) int32; ws a float32
// workspace of B * Hkv * np * G * (hd + 2), np = ceil(S / 256); out (B, Hkv *
// G, hd) f32.  lq, lv in [1, 3]; qk_mode, av_mode null, or an int32 device
// scalar that holds the site's bound mode (its lq or lv is then not read);
// rounding 0 trunc, 1 grte, 2 rne; window 0 is unbounded.  Returns
// cudaGetLastError() of the first failed launch, or cudaErrorInvalidValue
// for a bad argument.
extern "C" int rmpm_decode_attention(const void* q, const void* k, const void* v,
                                     long long k_sb, long long k_sr, long long v_sb,
                                     long long v_sr, const void* q_pos, const void* kv_pos,
                                     long long pos_sb, void* ws, void* out,
                                     const void* qk_mode, const void* av_mode, int B, int S,
                                     int Hkv, int G, int hd, int lq, int lv, int rounding,
                                     int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || G > DA_GMAX || hd <= 0 || hd > DA_HDMAX ||
      hd % 16 != 0 || lq < 1 || lq > DA_LIMBS || lv < 1 || lv > DA_LIMBS || rounding < 0 ||
      rounding > 2 || window < 0 || (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const float*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.k_sb = k_sb;
  a.k_sr = k_sr;
  a.v_sb = v_sb;
  a.v_sr = v_sr;
  a.q_pos = (const int*)q_pos;
  a.kv_pos = (const int*)kv_pos;
  a.pos_sb = pos_sb;
  a.B = B;
  a.S = S;
  a.Hkv = Hkv;
  a.G = G;
  a.hd = hd;
  a.np = (S + DA_PART - 1) / DA_PART;
  a.ws_acc = (float*)ws;
  a.ws_ml = a.ws_acc + (long long)B * Hkv * a.np * G * hd;
  a.out = (float*)out;
  a.qk_mode = (const int*)qk_mode;
  a.av_mode = (const int*)av_mode;
  a.lq = qk_mode ? DA_LIMBS : lq;
  a.lv = av_mode ? DA_LIMBS : lv;
  a.rounding = rounding;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(a.np, B * Hkv);
  const int smem = smem_bytes(a.lq, a.lv, G, hd);
  const int pairs = (G * hd / 2 + DA_THREADS - 1) / DA_THREADS;
  cudaError_t err;
  if (pairs <= 1) err = launch_partial<1>(a, grid, smem, s);
  else if (pairs <= 2) err = launch_partial<2>(a, grid, smem, s);
  else if (pairs <= 4) err = launch_partial<4>(a, grid, smem, s);
  else if (pairs <= 8) err = launch_partial<8>(a, grid, smem, s);
  else err = launch_partial<16>(a, grid, smem, s);
  if (err != cudaSuccess) return (int)err;
  decode_attn_combine_kernel<<<B * Hkv, DA_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Allow the partition kernels the shared memory of the largest shape (G = 16,
// hd = 256, three limbs each); the wrapper calls it once per device, before
// the device's first launch.  Returns the first error, or 0.
extern "C" int rmpm_decode_attention_prepare() {
  const cudaFuncAttribute max_smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaSuccess;
  for (cudaError_t e : {cudaFuncSetAttribute(decode_attn_partial_kernel<1>, max_smem, DA_SMEM_MAX),
                        cudaFuncSetAttribute(decode_attn_partial_kernel<2>, max_smem, DA_SMEM_MAX),
                        cudaFuncSetAttribute(decode_attn_partial_kernel<4>, max_smem, DA_SMEM_MAX),
                        cudaFuncSetAttribute(decode_attn_partial_kernel<8>, max_smem, DA_SMEM_MAX),
                        cudaFuncSetAttribute(decode_attn_partial_kernel<16>, max_smem,
                                             DA_SMEM_MAX)})
    if (err == cudaSuccess) err = e;
  return (int)err;
}
