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
// is (bytes moved) / (3.35 TB/s).  One pass over the N*R*C contiguous
// elements (the flat entry is N=1, the client-batched entry the whole
// (N, R, C) stack), nothing staged in shared memory, no second pass.
//
// Two forms of the one pass, with the same arithmetic per coordinate
// (`sophia_coord`):
//
// - The fp32 form, taken when all five operands are fp32 and all eight
//   pointers are 16-byte aligned (every launch of the round engine,
//   whose resident state is fp32).  A thread owns kUnroll float4 groups
//   per trip, spaced one grid apart: it issues all 5*kUnroll 16-byte
//   loads before the first use, then computes and stores.  Loads and
//   stores carry the evict-first hint (ld.global.cs / st.global.cs): each
//   byte is touched once.  The grid is a thread per float4 group up to a
//   cap of blocks per SM (the wrapper's `F32X4_BLOCKS_PER_SM`, chosen from
//   `chip_smoke.py`'s sweep): at the main path's shapes every group has
//   its own thread; past the cap each thread walks several.  The n % 4
//   tail is scalar.  What held the old one-element-per-thread kernel
//   back was per-element work, not bytes: a 4-byte access and a dtype
//   switch per operand, and the address arithmetic, for every coordinate.
// - The runtime-dtype form, for any other dtype combination or a pointer
//   that is not 16-byte aligned (a contiguous view at an odd storage
//   offset): one coordinate per thread, each of th, m, h, g, h_hat with
//   its own dtype code, loads and stores through dtype_io.cuh.
//
// In place: theta_out may be theta (and m_out m, h_out h), so the aliased
// pairs carry no __restrict__.  Each element is read and then written by
// the same thread, and a thread's loads precede its stores.
//
// The pytree form (`sophia_leaves_kernel`; replaces the pack, the flat
// launch and the unpack of `kernels/ops.py: sophia_fused_step`, the port
// of src/repro/kernels/ops.py:32): one launch over up to kMaxLeaves leaves
// of the five parameter trees, read where they lie, the three results
// written to fresh leaves.  The leaf table (8 pointers, n, 6 dtype codes
// and the float4 flag per leaf, plus each leaf's first block) rides in the
// kernel's parameters as a __grid_constant__ struct, inside the classic
// 4 KB: no copy to the device, no allocation.  Each leaf owns a run of
// blocks; a block finds its leaf by a uniform scan over the first-block
// entries, and each thread owns four consecutive coordinates of it.  A
// leaf whose operands are all fp32 and whose eight pointers are 16-byte
// aligned takes the fp32 form's body (float4 loads issued before use and
// stores, evict-first); any other leaf, and the n % 4 tail, the
// runtime-dtype loads and stores.  All three results are stored in the
// params leaf's dtype, as the unpack of the packed route stores them.
//
// Bits: built with -fmad=false and IEEE division, so every form is
// bitwise the op-by-op PyTorch version (kernels/ref.py) on the card.
// (1-b1), (1-b2) arrive precomputed in double and rounded to fp32 once,
// as the Python-double expressions of the JAX body are.  max() and the
// clip are written as compares that let NaN through, as jnp.maximum /
// jnp.clip / torch.clamp do (fmaxf would swallow it).
#include "dtype_io.cuh"

namespace {

using namespace repro_torch;

constexpr int kThreads = 256;
// float4 groups per thread per trip of the fp32 form's grid-stride loop
constexpr int kUnroll = 2;

struct Hyper {
  float do_h, lr, beta1, one_minus_beta1, beta2, one_minus_beta2, rho, eps,
      weight_decay;
  // lr*wd and 1-do_h, rounded to fp32 on the card as the plain version
  // rounds them
  __device__ __forceinline__ float lr_wd() const { return lr * weight_decay; }
  __device__ __forceinline__ float keep_h() const { return 1.0f - do_h; }
};

__device__ __forceinline__ void sophia_coord(const Hyper& p, float th,
                                             float m, float h0, float g,
                                             float h_hat, float& th_out,
                                             float& m_out, float& h_out) {
  const float mi = p.beta1 * m + p.one_minus_beta1 * g;
  const float h_new = p.beta2 * h0 + p.one_minus_beta2 * h_hat;
  const float hi = p.do_h * h_new + p.keep_h() * h0;
  th = th - p.lr_wd() * th;
  const float denom = hi < p.eps ? p.eps : hi;
  float step = mi / denom;
  step = step < -p.rho ? -p.rho : step;
  step = step > p.rho ? p.rho : step;
  th_out = th - p.lr * step;
  m_out = mi;
  h_out = hi;
}

__device__ __forceinline__ void sophia_quad(const Hyper& p, float4 th,
                                            float4 m, float4 h, float4 g,
                                            float4 hh, float4& th_out,
                                            float4& m_out, float4& h_out) {
  sophia_coord(p, th.x, m.x, h.x, g.x, hh.x, th_out.x, m_out.x, h_out.x);
  sophia_coord(p, th.y, m.y, h.y, g.y, hh.y, th_out.y, m_out.y, h_out.y);
  sophia_coord(p, th.z, m.z, h.z, g.z, hh.z, th_out.z, m_out.z, h_out.z);
  sophia_coord(p, th.w, m.w, h.w, g.w, hh.w, th_out.w, m_out.w, h_out.w);
}

__global__ void __launch_bounds__(kThreads) sophia_update_f32x4_kernel(
    float* theta_out, float* m_out, float* h_out, const float* theta,
    const float* m, const float* h, const float* __restrict__ g,
    const float* __restrict__ h_hat, int64_t n, Hyper p) {
  const int64_t n4 = n >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* th4 = reinterpret_cast<const float4*>(theta);
  const float4* m4 = reinterpret_cast<const float4*>(m);
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* hh4 = reinterpret_cast<const float4*>(h_hat);
  for (int64_t base = first; base < n4; base += kUnroll * stride) {
    float4 th[kUnroll], mm[kUnroll], hv[kUnroll], gv[kUnroll], hh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * stride;
      if (j < n4) {
        th[u] = __ldcs(th4 + j);
        mm[u] = __ldcs(m4 + j);
        hv[u] = __ldcs(h4 + j);
        gv[u] = __ldcs(g4 + j);
        hh[u] = __ldcs(hh4 + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * stride;
      if (j < n4) {
        float4 t, mo, ho;
        sophia_quad(p, th[u], mm[u], hv[u], gv[u], hh[u], t, mo, ho);
        __stcs(reinterpret_cast<float4*>(theta_out) + j, t);
        __stcs(reinterpret_cast<float4*>(m_out) + j, mo);
        __stcs(reinterpret_cast<float4*>(h_out) + j, ho);
      }
    }
  }
  // the n % 4 coordinates past the last group
  if (first < n - 4 * n4) {
    const int64_t i = 4 * n4 + first;
    sophia_coord(p, theta[i], m[i], h[i], g[i], h_hat[i], theta_out[i],
                 m_out[i], h_out[i]);
  }
}

__global__ void __launch_bounds__(kThreads) sophia_update_kernel(
    void* theta_out, void* m_out, void* h_out, const void* theta,
    const void* m, const void* h, const void* g, const void* h_hat,
    int c_theta, int c_m, int c_h, int c_g, int c_hh, int64_t n, Hyper p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float th, mo, ho;
    sophia_coord(p, to_f32(theta, i, c_theta), to_f32(m, i, c_m),
                 to_f32(h, i, c_h), to_f32(g, i, c_g),
                 to_f32(h_hat, i, c_hh), th, mo, ho);
    from_f32(theta_out, i, c_theta, th);
    from_f32(m_out, i, c_m, mo);
    from_f32(h_out, i, c_h, ho);
  }
}

// Leaves per launch of the pytree form (the wrapper's `ops.MAX_LEAVES`;
// the launcher refuses more): the table below stays inside the
// classic 4 KB of kernel parameters (2,696 bytes of table at 32 leaves,
// 80 a leaf)
constexpr int kMaxLeaves = 32;

struct Leaf {
  void* out[3];        // theta_out, m_out, h_out
  const void* in[5];   // theta, m, h, g, h_hat
  int64_t n;
  int8_t code[6];      // dtype codes: the outputs', then the five inputs'
  int8_t f32x4;        // every operand fp32, every pointer 16-byte aligned
};

struct LeafTable {
  int leaves;
  int first_block[kMaxLeaves + 1];   // [leaves]: the grid's size
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(LeafTable) + sizeof(Hyper) <= 4096,
              "the leaf table must fit the classic 4 KB of parameters");

__global__ void __launch_bounds__(kThreads) sophia_leaves_kernel(
    const __grid_constant__ LeafTable t, Hyper p) {
  // the block's leaf: the last whose first block is at or before it (a
  // leaf of no blocks is never chosen); uniform across the block
  int l = 0;
  for (int k = 1; k < t.leaves; ++k) {
    l = static_cast<int>(blockIdx.x) >= t.first_block[k] ? k : l;
  }
  const Leaf& d = t.leaf[l];
  const int64_t i0 =
      4 * (static_cast<int64_t>(blockIdx.x - t.first_block[l]) * kThreads +
           threadIdx.x);
  if (i0 >= d.n) return;
  if (d.f32x4 && i0 + 4 <= d.n) {
    const int64_t j = i0 >> 2;
    const float4 th = __ldcs(static_cast<const float4*>(d.in[0]) + j);
    const float4 mm = __ldcs(static_cast<const float4*>(d.in[1]) + j);
    const float4 hv = __ldcs(static_cast<const float4*>(d.in[2]) + j);
    const float4 gv = __ldcs(static_cast<const float4*>(d.in[3]) + j);
    const float4 hh = __ldcs(static_cast<const float4*>(d.in[4]) + j);
    float4 to, mo, ho;
    sophia_quad(p, th, mm, hv, gv, hh, to, mo, ho);
    __stcs(static_cast<float4*>(d.out[0]) + j, to);
    __stcs(static_cast<float4*>(d.out[1]) + j, mo);
    __stcs(static_cast<float4*>(d.out[2]) + j, ho);
    return;
  }
  // runtime-dtype loads of up to four coordinates, all issued before use
  const int cnt = d.n - i0 < 4 ? static_cast<int>(d.n - i0) : 4;
  float v[5][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < cnt) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        v[k][u] = to_f32(d.in[k], i0 + u, d.code[k + 1]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < cnt) {
      float th, mo, ho;
      sophia_coord(p, v[0][u], v[1][u], v[2][u], v[3][u], v[4][u], th, mo,
                   ho);
      from_f32(d.out[0], i0 + u, d.code[0], th);
      from_f32(d.out[1], i0 + u, d.code[0], mo);
      from_f32(d.out[2], i0 + u, d.code[0], ho);
    }
  }
}

}  // namespace

// Both launches run on `stream` (PyTorch's current stream), allocate
// nothing and do not synchronise; each returns cudaGetLastError() after
// the launch.

// The runtime-dtype form: any dtype code per operand, any alignment.
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
      c_g, c_hh, n,
      Hyper{do_h, lr, beta1, one_minus_beta1, beta2, one_minus_beta2, rho,
            eps, weight_decay});
  return static_cast<int>(cudaGetLastError());
}

// The fp32 form: every operand fp32, every pointer 16-byte aligned.
extern "C" int sophia_update_f32x4_launch(
    float* theta_out, float* m_out, float* h_out, const float* theta,
    const float* m, const float* h, const float* g, const float* h_hat,
    int64_t n, float do_h, float lr, float beta1, float one_minus_beta1,
    float beta2, float one_minus_beta2, float rho, float eps,
    float weight_decay, int blocks, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  sophia_update_f32x4_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      theta_out, m_out, h_out, theta, m, h, g, h_hat, n,
      Hyper{do_h, lr, beta1, one_minus_beta1, beta2, one_minus_beta2, rho,
            eps, weight_decay});
  return static_cast<int>(cudaGetLastError());
}

// The pytree form over `leaves` (1..kMaxLeaves) leaves: per leaf l, the
// pointers ptrs[8l..8l+7] (theta_out, m_out, h_out, theta, m, h, g,
// h_hat), n[l], codes[6l..6l+5] (the outputs' dtype code, then the five
// inputs'), f32x4[l] and first_block[l]; first_block[leaves] is the grid.
// Copies the table into the launch's parameters; keeps no pointer to the
// host arrays.
extern "C" int sophia_leaves_launch(
    void* const* ptrs, const int64_t* n, const int* codes, const int* f32x4,
    const int* first_block, int leaves, float do_h, float lr, float beta1,
    float one_minus_beta1, float beta2, float one_minus_beta2, float rho,
    float eps, float weight_decay, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (first_block[leaves] <= 0) return static_cast<int>(cudaSuccess);
  LeafTable t{};
  t.leaves = leaves;
  for (int l = 0; l < leaves; ++l) {
    Leaf& d = t.leaf[l];
    for (int k = 0; k < 3; ++k) d.out[k] = ptrs[8 * l + k];
    for (int k = 0; k < 5; ++k) d.in[k] = ptrs[8 * l + 3 + k];
    d.n = n[l];
    for (int k = 0; k < 6; ++k) {
      d.code[k] = static_cast<int8_t>(codes[6 * l + k]);
    }
    d.f32x4 = static_cast<int8_t>(f32x4[l] != 0);
    t.first_block[l] = first_block[l];
  }
  t.first_block[leaves] = first_block[leaves];
  sophia_leaves_kernel<<<first_block[leaves], kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      t, Hyper{do_h, lr, beta1, one_minus_beta1, beta2, one_minus_beta2,
               rho, eps, weight_decay});
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sophia_update_threads() { return kThreads; }
