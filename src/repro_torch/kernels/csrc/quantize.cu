// Stochastic quantize -> dequantize round-trips for Hopper (sm_90a), with
// a plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   quant_roundtrip_kernel     <- _quant_kernel     (quant_roundtrip_flat,
//                                                    quant_roundtrip_batched)
//   uplink_roundtrip_kernel    <- _uplink_kernel    (uplink_roundtrip_flat,
//                                                    uplink_roundtrip_batched)
//   broadcast_roundtrip_kernel <- _broadcast_kernel (broadcast_roundtrip_flat,
//                                                    broadcast_roundtrip_batched)
// Per coordinate, with s the row's scale and u the streamed U[0,1) noise:
//
//   quant:      out = clip(floor(x / safe + u), -qmax, qmax) * s,
//               safe = s > 0 ? s : 1
//   uplink:     d = (theta - start) + ef; xhat = quant(d); out xhat, d - xhat
//   broadcast:  d = (theta - ref) + ef;   xhat = quant(d); out ref + xhat,
//               d - xhat
//
// What bounds it on this card: bytes.  About six to ten fp32 operations per
// coordinate against 12 (quant) or 20 (uplink, broadcast) bytes moved, far
// below the H100's ~20 flops/byte ridge, so the least time is (bytes moved)
// / (3.35 TB/s).  The design moves each byte once: the buffers are walked
// as N*R rows of C contiguous elements (the flat entry is N=1); a block
// takes one row at a time (grid-stride over rows, grid sized from the SM
// count), loads the row's scale once, and its threads stride over the
// row's columns, so neighbouring threads touch neighbouring addresses and
// no element needs an integer division to find its scale.  A shared
// (R, C) operand (uplink's `start` when every client trained from one
// model, broadcast's server `theta`) is read at row % R, never
// materialised per client.  Vectorised 16-byte loads, in-kernel Philox
// noise and a fused per-row max are later work.
//
// Bits: built with -fmad=false and IEEE division, so each kernel is
// bitwise the op-by-op PyTorch version (kernels/ref.py) on the card.  The
// clip is written as compares that let NaN through, as jnp.clip /
// torch.clamp do (fminf/fmaxf would swallow it).  State operands carry a
// runtime dtype code (dtype_io.cuh); noise and scales are fp32.  Both
// outputs of uplink and broadcast are stored in theta's dtype, as the
// Pallas kernels' out_shape declares.
#include "dtype_io.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;

__device__ __forceinline__ float quant(float x, float s, float safe,
                                       float u, float qmax) {
  float q = floorf(x / safe + u);
  q = q < -qmax ? -qmax : q;
  q = q > qmax ? qmax : q;
  return q * s;
}

__global__ void __launch_bounds__(kThreads) quant_roundtrip_kernel(
    void* out, const void* x, const float* __restrict__ u,
    const float* __restrict__ scale, int c_x, int64_t rows, int cols,
    float qmax) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const float s = scale[r];
    const float safe = s > 0.0f ? s : 1.0f;
    const int64_t base = r * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int64_t i = base + c;
      from_f32(out, i, c_x, quant(to_f32(x, i, c_x), s, safe, u[i], qmax));
    }
  }
}

// `start` holds start_rows rows (R when shared by every client, N*R when
// stacked); row r of the stack reads its row r % start_rows.
__global__ void __launch_bounds__(kThreads) uplink_roundtrip_kernel(
    void* xhat_out, void* resid_out, const void* theta, const void* start,
    const void* ef, const float* __restrict__ u,
    const float* __restrict__ scale, int c_theta, int c_start, int c_ef,
    int64_t rows, int cols, int64_t start_rows, float qmax) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const float s = scale[r];
    const float safe = s > 0.0f ? s : 1.0f;
    const int64_t base = r * cols;
    const int64_t sbase = (r % start_rows) * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int64_t i = base + c;
      const float d = (to_f32(theta, i, c_theta) -
                       to_f32(start, sbase + c, c_start)) +
                      to_f32(ef, i, c_ef);
      const float xhat = quant(d, s, safe, u[i], qmax);
      from_f32(xhat_out, i, c_theta, xhat);
      from_f32(resid_out, i, c_theta, d - xhat);
    }
  }
}

// `theta` holds theta_rows rows (R for the one shared server model, N*R
// when stacked); the outputs are in theta's dtype.
__global__ void __launch_bounds__(kThreads) broadcast_roundtrip_kernel(
    void* model_out, void* resid_out, const void* theta, const void* ref,
    const void* ef, const float* __restrict__ u,
    const float* __restrict__ scale, int c_theta, int c_ref, int c_ef,
    int64_t rows, int cols, int64_t theta_rows, float qmax) {
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const float s = scale[r];
    const float safe = s > 0.0f ? s : 1.0f;
    const int64_t base = r * cols;
    const int64_t tbase = (r % theta_rows) * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const int64_t i = base + c;
      const float rv = to_f32(ref, i, c_ref);
      const float d = (to_f32(theta, tbase + c, c_theta) - rv) +
                      to_f32(ef, i, c_ef);
      const float xhat = quant(d, s, safe, u[i], qmax);
      from_f32(model_out, i, c_theta, rv + xhat);
      from_f32(resid_out, i, c_theta, d - xhat);
    }
  }
}

}  // namespace

// Each launcher runs on `stream` (PyTorch's current stream), allocates
// nothing and does not synchronise; it returns cudaGetLastError() after
// the launch.  Outputs must not alias inputs.  `rows` is N*R, `cols` C.
extern "C" int quant_roundtrip_launch(void* out, const void* x,
                                      const float* u, const float* scale,
                                      int c_x, int64_t rows, int cols,
                                      float qmax, int blocks, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  quant_roundtrip_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      out, x, u, scale, c_x, rows, cols, qmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uplink_roundtrip_launch(
    void* xhat_out, void* resid_out, const void* theta, const void* start,
    const void* ef, const float* u, const float* scale, int c_theta,
    int c_start, int c_ef, int64_t rows, int cols, int64_t start_rows,
    float qmax, int blocks, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  uplink_roundtrip_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      xhat_out, resid_out, theta, start, ef, u, scale, c_theta, c_start,
      c_ef, rows, cols, start_rows, qmax);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int broadcast_roundtrip_launch(
    void* model_out, void* resid_out, const void* theta, const void* ref,
    const void* ef, const float* u, const float* scale, int c_theta,
    int c_ref, int c_ef, int64_t rows, int cols, int64_t theta_rows,
    float qmax, int blocks, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  broadcast_roundtrip_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      model_out, resid_out, theta, ref, ef, u, scale, c_theta, c_ref, c_ef,
      rows, cols, theta_rows, qmax);
  return static_cast<int>(cudaGetLastError());
}
