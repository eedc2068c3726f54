// Fused Sophia update for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `_sophia_kernel` of
// src/repro/kernels/sophia_update.py (entry points `sophia_update_flat`
// and `sophia_update_batched`).  Per coordinate:
//
//   m'  = b1*m + (1-b1)*g                              (Eq. 9)
//   h'  = do_h*(b2*h + (1-b2)*h_hat) + (1-do_h)*h      (Eq. 10)
//   th' = (th - (lr*wd)*th) - lr*clip(m'/max(h',eps), -rho, rho)
//
// What bounds it on this card: bytes.  Five loads and three stores per
// coordinate against about fifteen flops: at fp32 that is 32 bytes for
// 15 flops, far below the H100's ~20 flops/byte ridge, so the least time
// is (bytes moved) / (3.35 TB/s).  The design moves each byte once: one
// pass over the N*R*C contiguous elements (the flat entry is N=1, the
// client-batched entry the whole (N, R, C) stack), nothing staged in
// shared memory, no second pass.  A grid-stride loop over blocks sized
// from the SM count keeps every SM streaming; neighbouring threads touch
// neighbouring addresses so each warp's loads coalesce.  Vectorised
// 16-byte loads and TMA are later work.
//
// Bits: built with -fmad=false and IEEE division, so the kernel is
// bitwise the op-by-op PyTorch version (kernels/ref.py) on the card.
// (1-b1), (1-b2) arrive precomputed in double and rounded to fp32 once,
// as the Python-double expressions of the JAX body are.  max() and the
// clip are written as compares that let NaN through, as jnp.maximum /
// jnp.clip / torch.clamp do (fmaxf would swallow it).
//
// Each of th, m, h, g, h_hat carries a runtime dtype code; loads and
// stores go through dtype_io.cuh.
#include "dtype_io.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;

// Outputs may alias their inputs (theta_out == theta for an in-place
// update): each element is read and then written by the same thread.
__global__ void __launch_bounds__(kThreads) sophia_update_kernel(
    void* theta_out, void* m_out, void* h_out, const void* theta,
    const void* m, const void* h, const void* g, const void* h_hat,
    int c_theta, int c_m, int c_h, int c_g, int c_hh, int64_t n,
    float do_h, float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float rho, float eps, float weight_decay) {
  const float lr_wd = lr * weight_decay;
  const float keep_h = 1.0f - do_h;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float gi = to_f32(g, i, c_g);
    const float h0 = to_f32(h, i, c_h);
    const float mi = beta1 * to_f32(m, i, c_m) + one_minus_beta1 * gi;
    const float h_new = beta2 * h0 + one_minus_beta2 * to_f32(h_hat, i, c_hh);
    const float hi = do_h * h_new + keep_h * h0;
    float th = to_f32(theta, i, c_theta);
    th = th - lr_wd * th;
    const float denom = hi < eps ? eps : hi;
    float step = mi / denom;
    step = step < -rho ? -rho : step;
    step = step > rho ? rho : step;
    from_f32(theta_out, i, c_theta, th - lr * step);
    from_f32(m_out, i, c_m, mi);
    from_f32(h_out, i, c_h, hi);
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); allocates nothing and
// does not synchronise.  Returns cudaGetLastError() after the launch.
extern "C" int sophia_update_launch(
    void* theta_out, void* m_out, void* h_out, const void* theta,
    const void* m, const void* h, const void* g, const void* h_hat,
    int c_theta, int c_m, int c_h, int c_g, int c_hh, int64_t n,
    float do_h, float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float rho, float eps, float weight_decay,
    int blocks, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  sophia_update_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      theta_out, m_out, h_out, theta, m, h, g, h_hat, c_theta, c_m, c_h,
      c_g, c_hh, n, do_h, lr, beta1, one_minus_beta1, beta2,
      one_minus_beta2, rho, eps, weight_decay);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sophia_update_threads() { return kThreads; }
