// quantize_mantissa — CUDA port of the TPU kernel `quantize_mantissa_pallas`
// (src/repro/kernels/quantize_mantissa/quantize_mantissa.py).
//
// What it computes: elementwise on the uint32 view of f32 data, keep `keep`
// explicit mantissa bits with one of three roundings
//     trunc : mask the dropped field
//     grte  : add G & (R | T | E) to the kept LSB          (paper Eq. 10)
//     rne   : add G & (rest | lsb) to the kept LSB
// A carry out of the mantissa renormalizes into the exponent (plain integer
// add), and non-finite values pass through untouched.
//
// Bound on this card: bytes.  One 4-byte read and one 4-byte write per
// element and a handful of integer operations, so the least time is
// 8 * n / memory rate.  Design: a flat grid-stride loop over the contiguous
// buffer, neighbouring threads on neighbouring words (coalesced); the
// wrapper flattens any rank, so there is no 2-D blocking and no padding.
#include <cuda_runtime.h>

namespace {

__global__ void quantize_mantissa_kernel(const unsigned* __restrict__ x,
                                         unsigned* __restrict__ out,
                                         long long n, int drop, int rounding) {
  const unsigned one = 1u;
  const unsigned lsb_unit = one << drop;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += stride) {
    const unsigned xi = x[idx];
    const unsigned kept = xi & ~(lsb_unit - one);
    unsigned q;
    if (rounding == 0) {  // trunc
      q = kept;
    } else if (rounding == 1) {  // grte
      const unsigned g = (xi >> (drop - 1)) & one;
      const unsigned r = drop >= 2 ? (xi >> (drop - 2)) & one : 0u;
      const unsigned e = drop >= 3 ? (xi >> (drop - 3)) & one : 0u;
      const unsigned t =
          drop >= 4 ? ((xi & ((one << (drop - 3)) - one)) != 0u ? one : 0u) : 0u;
      q = kept + (g & (r | t | e)) * lsb_unit;
    } else {  // rne
      const unsigned g = (xi >> (drop - 1)) & one;
      const unsigned rest = (xi & ((one << (drop - 1)) - one)) != 0u ? one : 0u;
      const unsigned lsb = (xi >> drop) & one;
      q = kept + (g & (rest | lsb)) * lsb_unit;
    }
    const bool finite = ((xi >> 23) & 0xFFu) != 0xFFu;
    out[idx] = finite ? q : xi;
  }
}

}  // namespace

// keep in [1, 22]; rounding: 0 trunc, 1 grte, 2 rne.  Returns cudaGetLastError().
extern "C" int rmpm_quantize_mantissa(const void* x, void* out, long long n,
                                      int keep, int rounding, void* stream) {
  if (n <= 0) return 0;
  const int drop = 23 - keep;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // a few waves; the loop strides
  if (blocks > max_blocks) blocks = max_blocks;
  quantize_mantissa_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)x, (unsigned*)out, n, drop, rounding);
  return (int)cudaGetLastError();
}

extern "C" const char* rmpm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
