// Robust combine of K arrival wires for Hopper (sm_90a), with a
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
// What bounds it on this card.  Each wire element is read once (4, 2 or 1
// bytes) and the least work for the selection is far below the fp32
// ridge (~20 flops/byte), so bytes set the least time.  What held the
// pass form back was instructions: 2*trim argmax passes over all K
// candidates, about ten instructions each (bit extract, fill select, sign
// multiply, the two NaN tests of `beats`, two selects), every pass one
// serial chain through `best` and `hit` with no instruction-level
// parallelism: ~5,000 instructions a coordinate at K=32 trim 8, ~9,600 at
// trim 15.  And the K loads went through the runtime dtype switch one by
// one, each behind a branch, so they did not overlap.
//
// The design: one thread per coordinate, its K scaled values in registers
// (the loops over k unrolled over a compile-time bucket KMAX of 16, 32 or
// 64 chosen by K, so the array never lands in local memory), loaded with
// the wire dtype fixed at compile time (one switch per coordinate, not one
// per load, so all K loads are in flight together), and two forms of the
// selection, chosen per thread:
//
// - The sort form, for a coordinate whose K values all satisfy |v| <
//   FLT_MAX (no NaN, no inf, no +-FLT_MAX: the -FLT_MAX fill of the
//   passes could tie with -FLT_MAX).  There the 2*trim passes remove
//   exactly this set, with s the values sorted ascending and t = trim:
//     top:    hi = s[K-t]; every v > hi, then the t - #{v > hi} entries
//             == hi of lowest k;
//     bottom: lo = s[t-1]; every v < lo, then among the entries still
//             alive the t - #{v < lo} entries == lo of lowest k
//   (compares treat -0 and +0 as equal, as `beats` does; the top removes
//   only entries >= hi >= lo, so enough entries == lo stay for the
//   bottom, also when hi == lo).  hi and lo come from a bitonic sorting
//   network over a register copy padded with +inf (240 min/max pairs at
//   KMAX=32, in independent layers, whatever the trim).  The mask is then
//   built from four bit words (v > hi, v < lo, v == hi, v == lo, one bit
//   per k) and their popcounts, taking the lowest set bits of the tie
//   words: no chain through k.
// - The pass form, for every other coordinate: the 2*trim argmax passes
//   above, unchanged, over a survivor bitmask.
//
// Both are parts of the one kernel; a warp whose coordinates mix them
// runs both.  trim == 0 selects nothing and launches an instantiation
// without either form (fewer registers).  The sums do not change: num and
// den over all k in ascending order, so the output is bitwise as long as
// the mask is.  Past 64 arrivals a third form re-reads the values from
// global memory (L2) on each pass and keeps the survivor bits in a
// scratch buffer the wrapper allocates.
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

// One layer of the bitonic network over s[0, N): blocks of width W sorted
// ascending or descending by the bit W of the index, pairs J apart.  All
// indices are compile-time, so s stays in registers.
template <int N, int W, int J>
__device__ __forceinline__ void bitonic_layer(float (&s)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int l = i ^ J;
    if (l > i) {
      const float a = s[i];
      const float b = s[l];
      const bool up = (i & W) == 0;
      s[i] = up ? fminf(a, b) : fmaxf(a, b);
      s[l] = up ? fmaxf(a, b) : fminf(a, b);
    }
  }
  if constexpr (J > 1) bitonic_layer<N, W, J / 2>(s);
}

// Sorts s[0, N) ascending (N a power of two; no NaN).
template <int N, int W = 2>
__device__ __forceinline__ void bitonic_sort(float (&s)[N]) {
  bitonic_layer<N, W, W / 2>(s);
  if constexpr (W < N) bitonic_sort<N, W * 2>(s);
}

// Sorts s (the K values, padded with +inf) and returns hi = s[K-trim] and
// lo = s[trim-1].
template <int KMAX>
__device__ __forceinline__ void sort_bounds(float (&s)[KMAX], int K,
                                            int trim, float& hi, float& lo) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    s[k] = k < K ? s[k] : __int_as_float(0x7f800000);  // +inf
  }
  bitonic_sort<KMAX>(s);
  hi = 0.0f;
  lo = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    hi = j == K - trim ? s[j] : hi;
    lo = j == trim - 1 ? s[j] : lo;
  }
}

// The lowest `count` set bits of m (none for count <= 0).
template <typename Word>
__device__ __forceinline__ Word lowest_bits(Word m, int count) {
  Word out = 0;
  for (int c = 0; c < count; ++c) {
    const Word b = m & (~m + 1);
    out |= b;
    m ^= b;
  }
  return out;
}

// The survivors of the sort form given hi and lo.
template <int KMAX, typename Word>
__device__ __forceinline__ Word bounded_survivors(const float (&v)[KMAX],
                                                  int K, int trim, float hi,
                                                  float lo) {
  // bit k of each word: v[k] against hi and lo
  Word all = 0, gt = 0, lt = 0, eq_hi = 0, eq_lo = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k < K) {
      const Word b = static_cast<Word>(1) << k;
      all |= b;
      gt |= v[k] > hi ? b : 0;
      lt |= v[k] < lo ? b : 0;
      eq_hi |= v[k] == hi ? b : 0;
      eq_lo |= v[k] == lo ? b : 0;
    }
  }
  // the top removes every v > hi, then the lowest-k entries == hi; the
  // bottom every v < lo, then the lowest-k entries == lo it left alive
  const Word top = lowest_bits(eq_hi, trim - __popcll(gt));
  const Word bottom = lowest_bits(eq_lo & ~top, trim - __popcll(lt));
  return all & ~(gt | lt | top | bottom);
}

// The survivors of the 2*trim argmax passes themselves: the pass form.
template <int KMAX, typename Word>
__device__ __forceinline__ Word pass_survivors(const float (&v)[KMAX],
                                               int K, int trim, Word alive) {
  for (int pass = 0; pass < 2 * trim; ++pass) {
    const float sign = pass < trim ? 1.0f : -1.0f;
    float best = 0.0f;
    int hit = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) {
        const float c = (alive >> k) & 1 ? sign * v[k] : -FLT_MAX;
        if (k == 0 || beats(c, best)) {
          best = c;
          hit = k;
        }
      }
    }
    alive &= ~(static_cast<Word>(1) << hit);
  }
  return alive;
}

// v[k] = scales[k] * x_k[i] for k < K (0 past K), the wire dtype CODE
// known at compile time: no branch between the K loads, so all of them are
// in flight at once.
template <int KMAX, int CODE>
__device__ __forceinline__ void load_scaled(float (&v)[KMAX], const void* x,
                                            const float* __restrict__ scales,
                                            int K, int64_t n, int64_t i) {
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    v[k] = k < K ? scales[k] * to_f32(x, static_cast<int64_t>(k) * n + i,
                                      CODE)
                 : 0.0f;
  }
}

// The combine with the values in registers.  SELECT: trim > 0 (trim == 0,
// the norm-clip combine, selects nothing and carries neither selection
// form).
template <int KMAX, bool SELECT>
__device__ __forceinline__ void reg_combine(
    float* __restrict__ out, const void* x, const float* __restrict__ w,
    const float* __restrict__ scales, int code, int K, int trim,
    int normalize, int64_t n) {
  using Word = typename MaskWord<KMAX>::type;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float v[KMAX];
    switch (code) {
      case kBF16:
        load_scaled<KMAX, kBF16>(v, x, scales, K, n, i);
        break;
      case kE4M3:
        load_scaled<KMAX, kE4M3>(v, x, scales, K, n, i);
        break;
      case kE5M2:
        load_scaled<KMAX, kE5M2>(v, x, scales, K, n, i);
        break;
      default:
        load_scaled<KMAX, kF32>(v, x, scales, K, n, i);
    }
    Word alive = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < K) alive |= static_cast<Word>(1) << k;
    }
    if constexpr (SELECT) {
      bool sortable = true;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) sortable = sortable && fabsf(v[k]) < FLT_MAX;
      }
      if (sortable) {
        float s[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) s[k] = v[k];
        float hi, lo;
        sort_bounds<KMAX>(s, K, trim, hi, lo);
        alive = bounded_survivors<KMAX, Word>(v, K, trim, hi, lo);
      } else {
        alive = pass_survivors<KMAX, Word>(v, K, trim, alive);
      }
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

template <int KMAX, bool SELECT>
__global__ void __launch_bounds__(kThreads) robust_agg_reg_kernel(
    float* __restrict__ out, const void* x, const float* __restrict__ w,
    const float* __restrict__ scales, int code, int K, int trim,
    int normalize, int64_t n) {
  reg_combine<KMAX, SELECT>(out, x, w, scales, code, K, trim, normalize, n);
}

// The 16 bucket with selection, held to 64 registers so that eight blocks
// fit on an SM and the (116, 1024) output's 928 blocks run in one wave (at
// the 66 it takes unbounded, seven fit: 924 blocks).  The other
// instantiations spill under such a bound and keep the default.
__global__ void __launch_bounds__(kThreads, 8) robust_agg_reg16_select_kernel(
    float* __restrict__ out, const void* x, const float* __restrict__ w,
    const float* __restrict__ scales, int code, int K, int trim,
    int normalize, int64_t n) {
  reg_combine<16, true>(out, x, w, scales, code, K, trim, normalize, n);
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

namespace {

template <int KMAX>
void launch_reg(float* out, const void* x, const float* w,
                const float* scales, int code, int K, int trim, int normalize,
                int64_t n, int blocks, cudaStream_t s) {
  if (trim > 0) {
    if constexpr (KMAX == 16) {
      robust_agg_reg16_select_kernel<<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, code, K, trim, normalize, n);
    } else {
      robust_agg_reg_kernel<KMAX, true><<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, code, K, trim, normalize, n);
    }
  } else {
    robust_agg_reg_kernel<KMAX, false><<<blocks, kThreads, 0, s>>>(
        out, x, w, scales, code, K, trim, normalize, n);
  }
}

}  // namespace

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
      launch_reg<16>(out, x, w, scales, code, K, trim, normalize, n, blocks,
                     s);
      break;
    case 32:
      launch_reg<32>(out, x, w, scales, code, K, trim, normalize, n, blocks,
                     s);
      break;
    case 64:
      launch_reg<64>(out, x, w, scales, code, K, trim, normalize, n, blocks,
                     s);
      break;
    default:
      robust_agg_any_kernel<<<blocks, kThreads, 0, s>>>(
          out, x, w, scales, mask, code, K, trim, normalize, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int robust_agg_threads() { return kThreads; }
