// Staleness-weighted accumulate of K arrival wires for Hopper (sm_90a),
// with a plain C interface.
//
// Replaces the Pallas TPU kernel `_stale_accum_kernel` of
// src/repro/kernels/stale_accum.py (entry point `stale_accum_flat`), the
// aggregation of the virtual-time scheduler.  Per coordinate i of the
// (R, C) output, over a (K, R, C) stack of wires:
//
//   out[i] = inv_norm * (((0 + w_0*x_0[i]) + w_1*x_1[i]) + ... )
//
// with fp32 adds in ascending k (inv_norm = 1/sum(w) for the semisync
// weighted mean, 1 for the async apply).
//
// What bounds it on this card: bytes.  Two fp32 operations per wire
// element (multiply, add) against 4, 2 or 1 bytes read: at fp32 that is
// half an operation per byte, far below the H100's ~20 flops/byte ridge,
// so the least time is (K*R*C*itemsize + 4*R*C) / (3.35 TB/s).  The
// design reads each wire element once and keeps every load it can in
// flight: a thread per output item (a float4 group of four coordinates
// when the wires are fp32, 16-byte aligned and R*C is a multiple of 4,
// else one coordinate), no grid-stride loop, the grid sized to the items
// so that every SM has work.  The wires are read in compile-time batches
// of kBatch loads, each with its weight (one address for the whole warp),
// all issued before the first add of the batch, so no weight load sits on
// the multiply's dependency chain and no barrier waits for one; then they
// are folded into a register accumulator in ascending k.  The K % kBatch
// arrivals past the last whole batch take straight-line batches of 8, 4,
// 2 and 1 (at K=1 the launch is the floor; a batch of 16 predicated on
// k < K was slower there).  Neighbouring threads read neighbouring
// addresses of each wire, so every warp's loads coalesce; the fp32 form
// reads the wires with the evict-first hint (each element is read exactly
// once) and stores plainly (the caller reads the result next).  What held
// back the grid-stride form this replaces, at (116, 1024): a grid of 116
// blocks of 256 threads (16 of the 132 SMs idle), a runtime loop over k
// that reloaded w[k] from global memory on every trip, no cache hint.
// The TPU kernel walks k as a sequential grid axis with the tile
// revisited in VMEM; on the GPU the loop over k inside the thread takes
// that axis's place, with the same add order.  The block size is a
// launch argument, chosen from chip_smoke.py's sweep_stale_grid.
//
// Bits: built with -fmad=false, so the multiply and the add stay two
// rounded operations and the kernel is bitwise its plain version
// (kernels/ref.py: stale_accum_ref) on the card.  The weights arrive by
// device pointer, inv_norm by value or as a one-element device tensor,
// so the host never reads the device.  Narrow wires (bf16, e4m3, e5m2)
// take the one-coordinate form with the dtype fixed at compile time (one
// instantiation per dtype code, dtype_io.cuh); the output is fp32.
#include "dtype_io.cuh"

namespace {

using namespace repro_torch;

// the most threads a block may take
constexpr int kMaxThreads = 256;
// wire loads (and their weights) in flight per thread
constexpr int kBatch = 16;

// fp32 wires: an item is a float4 group of four coordinates.
struct F32x4 {
  using V = float4;
  static __device__ __forceinline__ V load(const void* x, int64_t i) {
    return __ldcs(static_cast<const float4*>(x) + i);
  }
  static __device__ __forceinline__ void fold(V& acc, float w, const V& v) {
    acc.x = acc.x + w * v.x;
    acc.y = acc.y + w * v.y;
    acc.z = acc.z + w * v.z;
    acc.w = acc.w + w * v.w;
  }
  static __device__ __forceinline__ V zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void store(float* out, int64_t i,
                                               float s, const V& acc) {
    reinterpret_cast<float4*>(out)[i] =
        make_float4(s * acc.x, s * acc.y, s * acc.z, s * acc.w);
  }
};

// Any wire dtype, one coordinate an item, the dtype code fixed at compile
// time (to_f32's switch folds away).
template <int kCode>
struct Scalar {
  using V = float;
  static __device__ __forceinline__ V load(const void* x, int64_t i) {
    return to_f32(x, i, kCode);
  }
  static __device__ __forceinline__ void fold(V& acc, float w, const V& v) {
    acc = acc + w * v;
  }
  static __device__ __forceinline__ V zero() { return 0.0f; }
  static __device__ __forceinline__ void store(float* out, int64_t i,
                                               float s, const V& acc) {
    out[i] = s * acc;
  }
};

// Folds arrivals k .. k + kN - 1 of item j into acc: every wire and
// weight load of the batch is issued before the first add.
template <int kN, class Wire>
__device__ __forceinline__ void fold_batch(typename Wire::V& acc,
                                           const void* x, const float* w,
                                           int k, int64_t items, int64_t j) {
  typename Wire::V v[kN];
  float wk[kN];
#pragma unroll
  for (int b = 0; b < kN; ++b) {
    v[b] = Wire::load(x, static_cast<int64_t>(k + b) * items + j);
    wk[b] = __ldg(w + k + b);
  }
#pragma unroll
  for (int b = 0; b < kN; ++b) Wire::fold(acc, wk[b], v[b]);
}

// `items` items per wire; wire k's item j at k * items + j.  A thread per
// item: whole batches of kBatch arrivals, then the K % kBatch others in
// batches of 8, 4, 2 and 1, each straight-line code.  The launch bound of
// one block an SM lets ptxas spend the registers a batch needs: under the
// default it interleaved the batch's loads with its adds, two in flight.
template <class Wire>
__global__ void __launch_bounds__(kMaxThreads, 1) stale_accum_kernel(
    float* __restrict__ out, const void* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ inv_norm_ptr,
    float inv_norm, int K, int64_t items) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= items) return;
  const float s = inv_norm_ptr != nullptr ? __ldg(inv_norm_ptr) : inv_norm;
  typename Wire::V acc = Wire::zero();
  int k = 0;
  for (; k + kBatch <= K; k += kBatch) {
    fold_batch<kBatch, Wire>(acc, x, w, k, items, j);
  }
  if (K - k >= 8) {
    fold_batch<8, Wire>(acc, x, w, k, items, j);
    k += 8;
  }
  if (K - k >= 4) {
    fold_batch<4, Wire>(acc, x, w, k, items, j);
    k += 4;
  }
  if (K - k >= 2) {
    fold_batch<2, Wire>(acc, x, w, k, items, j);
    k += 2;
  }
  if (K > k) fold_batch<1, Wire>(acc, x, w, k, items, j);
  Wire::store(out, j, s, acc);
}

template <class Wire>
void launch(float* out, const void* x, const float* w,
            const float* inv_norm_ptr, float inv_norm, int K, int64_t items,
            int threads, cudaStream_t s) {
  const int64_t blocks = (items + threads - 1) / threads;
  stale_accum_kernel<Wire>
      <<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          out, x, w, inv_norm_ptr, inv_norm, K, items);
}

}  // namespace

// `inv_norm_ptr` may be null (then `inv_norm` is the scale).  `vec4`
// selects the fp32 float4 form (fp32 wires, n % 4 == 0, 16-byte aligned
// pointers; the wrapper checks).  `threads` a block (32 to 256), a thread
// per item.  Launches on `stream` (PyTorch's current stream); allocates
// nothing and does not synchronise.  Returns cudaGetLastError() after the
// launch.
extern "C" int stale_accum_launch(float* out, const void* x, const float* w,
                                  const float* inv_norm_ptr, float inv_norm,
                                  int code, int K, int64_t n, int vec4,
                                  int threads, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (K < 1 || threads < 32 || threads > kMaxThreads ||
      (vec4 && (code != kF32 || n % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    launch<F32x4>(out, x, w, inv_norm_ptr, inv_norm, K, n / 4, threads, s);
  } else {
    switch (code) {
      case kBF16:
        launch<Scalar<kBF16>>(out, x, w, inv_norm_ptr, inv_norm, K, n,
                              threads, s);
        break;
      case kE4M3:
        launch<Scalar<kE4M3>>(out, x, w, inv_norm_ptr, inv_norm, K, n,
                              threads, s);
        break;
      case kE5M2:
        launch<Scalar<kE5M2>>(out, x, w, inv_norm_ptr, inv_norm, K, n,
                              threads, s);
        break;
      default:
        launch<Scalar<kF32>>(out, x, w, inv_norm_ptr, inv_norm, K, n,
                             threads, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
