// Sort-free robust combine of K arrival wires for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel `_robust_agg_kernel` (with
// `_survivor_mask`) of src/repro/kernels/robust_agg.py (entry point
// `robust_agg_flat`): the trimmed mean, coordinate median and norm-clip
// combine of the engine rounds and of the scheduler's apply.  Per
// coordinate i of the (R, C) output, over a (K, R, C) stack:
//
//   xs_k  = scales[k] * x_k[i]
//   drop `trim` largest and `trim` smallest xs_k, one per pass: trim
//        argmax passes over xs, then trim over -xs, each over the
//        survivors with removed entries filled with -FLT_MAX
//   wm_k  = survivor ? w[k] : 0
//   num   = ((0 + xs_0*wm_0) + xs_1*wm_1) + ...      (all k, ascending)
//   out   = normalize ? num / (((0 + wm_0) + wm_1) + ...) : num
//
// The argmax is jnp.argmax's: the first index among equal maxima, and a
// NaN counts as the maximum (the first NaN wins).  A surviving -inf loses
// to the -FLT_MAX fill, so such a pass hits an entry already removed and
// removes nothing, as in the reference.  A removed inf or NaN makes its
// term 0*inf = NaN, as in the reference.
//
// What bounds it on this card: operations.  Each wire element is read
// once (4, 2 or 1 bytes), but the 2*trim passes compare every survivor:
// about 3*K*2*trim + 4*K fp32 operations per coordinate.  At K=32,
// trim=8 that is ~900 operations against 132 bytes, ~7 per byte, and at
// the median's trim 15 ~1,600 (~12 per byte); both sit below the fp32
// ridge (~20 flops/byte), so bytes still set the least time, but only
// narrowly; the trim-0 norm-clip combine is plainly bound by bytes.  The
// design keeps the K scaled values of a coordinate in registers (one
// thread per coordinate, the loops over k unrolled over a compile-time
// bucket KMAX of 16, 32 or 64 chosen by K, so the array never lands in
// local memory) with a survivor bitmask, and makes the passes there:
// nothing is re-read and nothing is sorted.  Past 64 arrivals a second
// form re-reads the values from global memory (L2) on each pass and
// keeps the survivor bits in a scratch buffer the wrapper allocates.
//
// Bits: built with -fmad=false and IEEE division, so the kernel is
// bitwise its plain version (kernels/ref.py: robust_agg_ref) on the card.
// Wires carry a runtime dtype code (dtype_io.cuh); weights, scales and
// the output are fp32.
#include <float.h>

#include "dtype_io.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 128;

// argmax's replacement rule for a candidate c against the best so far
// (scanned in ascending k): strictly greater, or the first NaN.
__device__ __forceinline__ bool beats(float c, float best) {
  return c > best || (c != c && best == best);
}

template <int KMAX>
struct MaskWord {
  using type = unsigned int;
};
template <>
struct MaskWord<64> {
  using type = unsigned long long;
};

template <int KMAX>
__global__ void __launch_bounds__(kThreads) robust_agg_reg_kernel(
    float* __restrict__ out, const void* x, const float* __restrict__ w,
    const float* __restrict__ scales, int code, int K, int trim,
    int normalize, int64_t n) {
  using Word = typename MaskWord<KMAX>::type;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float v[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      v[k] = k < K ? scales[k] * to_f32(x, static_cast<int64_t>(k) * n + i,
                                        code)
                   : 0.0f;
    }
    Word alive = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) alive |= static_cast<Word>(1) << k;
    }
    for (int pass = 0; pass < 2 * trim; ++pass) {
      const float sign = pass < trim ? 1.0f : -1.0f;
      float best = 0.0f;
      int hit = 0;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          const float c =
              (alive >> k) & 1 ? sign * v[k] : -FLT_MAX;
          if (k == 0 || beats(c, best)) {
            best = c;
            hit = k;
          }
        }
      }
      alive &= ~(static_cast<Word>(1) << hit);
    }
    float num = 0.0f;
    float den = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float wm = (alive >> k) & 1 ? w[k] : 0.0f;
        num = num + v[k] * wm;
        den = den + wm;
      }
    }
    out[i] = normalize ? num / den : num;
  }
}

// Any K: the values are re-read on each pass, the survivor bits live in
// `mask` ((K + 31) / 32 words per coordinate, word j of coordinate i at
// j * n + i, so neighbouring threads touch neighbouring words).
__global__ void __launch_bounds__(kThreads) robust_agg_any_kernel(
    float* __restrict__ out, const void* x, const float* __restrict__ w,
    const float* __restrict__ scales, unsigned int* __restrict__ mask,
    int code, int K, int trim, int normalize, int64_t n) {
  const int words = (K + 31) / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    for (int j = 0; j < words; ++j) {
      const int left = K - 32 * j;
      mask[j * n + i] = left >= 32 ? 0xFFFFFFFFu : ((1u << left) - 1u);
    }
    for (int pass = 0; pass < 2 * trim; ++pass) {
      const float sign = pass < trim ? 1.0f : -1.0f;
      float best = 0.0f;
      int hit = 0;
      unsigned int word = 0;
      for (int k = 0; k < K; ++k) {
        if ((k & 31) == 0) word = mask[(k >> 5) * n + i];
        const float xs =
            scales[k] * to_f32(x, static_cast<int64_t>(k) * n + i, code);
        const float c = (word >> (k & 31)) & 1u ? sign * xs : -FLT_MAX;
        if (k == 0 || beats(c, best)) {
          best = c;
          hit = k;
        }
      }
      mask[(hit >> 5) * n + i] &= ~(1u << (hit & 31));
    }
    float num = 0.0f;
    float den = 0.0f;
    unsigned int word = 0;
    for (int k = 0; k < K; ++k) {
      if ((k & 31) == 0) word = mask[(k >> 5) * n + i];
      const float xs =
          scales[k] * to_f32(x, static_cast<int64_t>(k) * n + i, code);
      const float wm = (word >> (k & 31)) & 1u ? w[k] : 0.0f;
      num = num + xs * wm;
      den = den + wm;
    }
    out[i] = normalize ? num / den : num;
  }
}

}  // namespace

// The register bucket the wrapper uses for K (0: the any-K form, which
// needs `mask`).
extern "C" int robust_agg_bucket(int K) {
  return K <= 16 ? 16 : K <= 32 ? 32 : K <= 64 ? 64 : 0;
}

// Launches on `stream` (PyTorch's current stream); allocates nothing and
// does not synchronise.  `mask` is read only by the any-K form.  Returns
// cudaGetLastError() after the launch.
extern "C" int robust_agg_launch(float* out, const void* x, const float* w,
                                 const float* scales, unsigned int* mask,
                                 int code, int K, int trim, int normalize,
                                 int64_t n, int blocks, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (robust_agg_bucket(K)) {
    case 16:
      robust_agg_reg_kernel<16><<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, code, K, trim, normalize, n);
      break;
    case 32:
      robust_agg_reg_kernel<32><<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, code, K, trim, normalize, n);
      break;
    case 64:
      robust_agg_reg_kernel<64><<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, code, K, trim, normalize, n);
      break;
    default:
      robust_agg_any_kernel<<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, mask, code, K, trim, normalize, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int robust_agg_threads() { return kThreads; }
