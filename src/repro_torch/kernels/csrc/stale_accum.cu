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
// design reads each wire element once: one thread per output coordinate
// (four neighbouring ones with 16-byte loads when the wires are fp32 and
// R*C is a multiple of 4), a loop over k into a register accumulator,
// one store; a grid-stride loop over blocks sized from the SM count.
// Neighbouring threads read neighbouring addresses of each wire, so
// every warp's loads coalesce.  The TPU kernel walks k as a sequential
// grid axis with the tile revisited in VMEM; on the GPU the loop over k
// inside the thread takes that axis's place, with the same add order.
//
// Bits: built with -fmad=false, so the multiply and the add stay two
// rounded operations and the kernel is bitwise its plain version
// (kernels/ref.py: stale_accum_ref) on the card.  The weights arrive by
// device pointer, inv_norm by value or as a one-element device tensor,
// so the host never reads the device.  Wires carry a runtime dtype code
// (dtype_io.cuh); the output is fp32.
#include "dtype_io.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;

__device__ __forceinline__ float scale_of(const float* inv_norm_ptr,
                                          float inv_norm) {
  return inv_norm_ptr != nullptr ? *inv_norm_ptr : inv_norm;
}

__global__ void __launch_bounds__(kThreads) stale_accum_kernel(
    float* __restrict__ out, const void* x, const float* __restrict__ w,
    const float* __restrict__ inv_norm_ptr, float inv_norm, int code, int K,
    int64_t n) {
  const float s = scale_of(inv_norm_ptr, inv_norm);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      acc = acc + w[k] * to_f32(x, static_cast<int64_t>(k) * n + i, code);
    }
    out[i] = s * acc;
  }
}

// fp32 wires with n % 4 == 0: four coordinates per thread, 16-byte loads
// and stores.  Each lane's arithmetic is the scalar kernel's.
__global__ void __launch_bounds__(kThreads) stale_accum_f32x4_kernel(
    float4* __restrict__ out, const float4* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ inv_norm_ptr,
    float inv_norm, int K, int64_t n4) {
  const float s = scale_of(inv_norm_ptr, inv_norm);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n4; i += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < K; ++k) {
      const float wk = w[k];
      const float4 v = x[static_cast<int64_t>(k) * n4 + i];
      acc.x = acc.x + wk * v.x;
      acc.y = acc.y + wk * v.y;
      acc.z = acc.z + wk * v.z;
      acc.w = acc.w + wk * v.w;
    }
    out[i] = make_float4(s * acc.x, s * acc.y, s * acc.z, s * acc.w);
  }
}

}  // namespace

// `inv_norm_ptr` may be null (then `inv_norm` is the scale).  `vec4`
// selects the 16-byte path (fp32 wires, n % 4 == 0, 16-byte aligned
// pointers; the wrapper checks).  Launches on `stream` (PyTorch's current
// stream); allocates nothing and does not synchronise.  Returns
// cudaGetLastError() after the launch.
extern "C" int stale_accum_launch(float* out, const void* x, const float* w,
                                  const float* inv_norm_ptr, float inv_norm,
                                  int code, int K, int64_t n, int vec4,
                                  int blocks, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    stale_accum_f32x4_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<float4*>(out), static_cast<const float4*>(x), w,
        inv_norm_ptr, inv_norm, K, n / 4);
  } else {
    stale_accum_kernel<<<blocks, kThreads, 0, s>>>(out, x, w, inv_norm_ptr,
                                                   inv_norm, code, K, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stale_accum_threads() { return kThreads; }
