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
// The leaf-boundary form (`sophia_boundary_kernel`; the round engine's
// step on its leaf route, `kernels/sophia_update.py:
// sophia_update_leaves`): th, m and h are the fp32 (clients, rows, cols)
// resident buffers, read and written in place; g and h_hat are read
// where autograd and the GNB estimate left them, one tensor a leaf of
// its own dtype (h_hat may also be one resident-shaped buffer); the new
// th is also stored, rounded to nearest even, into a per-leaf tensor of
// the leaf's dtype, the tensor the next forward reads.  That replaces
// the unpack of th into leaves and the fp32 pack of g and h_hat around
// the flat step: at bf16 leaves the launch moves 30-32 bytes a
// coordinate where pack, step and unpack moved 44-56.  The table has a
// row per leaf (at most kBoundaryLeaves a launch, in the large kernel
// parameter space of CUDA 12.1 and later); the grid's y index is
// the client, whose run of a leaf starts at c*padded + off in th, m and
// h and at c*cs in g and h_hat.  A block owns 2048 coordinates of one
// (client, leaf) run and finds its leaf by a binary search over the
// first-block entries.  Two bodies:
//
// - the run body, for leaves whose g and h_hat are contiguous runs: each
//   thread owns two groups of four coordinates and issues all their
//   loads before it computes; on a leaf whose operands are aligned a
//   group is four consecutive coordinates, th, m, h loaded as float4 and
//   a bf16 operand as 8 bytes (evict-first, as the fp32 form); on any
//   other leaf its coordinates lie a block's width apart, loaded
//   elementwise by dtype, so that a warp's access is one contiguous run;
// - the tile body, for a leaf whose g or h_hat has its last two axes
//   swapped (a tied embedding's grad comes back as the transpose of its
//   head's GEMM): the block issues its th, m, h loads, stages a 64 x 32
//   tile of each swapped operand in shared memory, read along its own
//   contiguous axis four elements a thread, then walks the tile in th's
//   order as the run body does.
//
// The pad tail of th, m and h past the leaves is left as it is: zero in
// every resident buffer, and zero is a fixed point of the step.
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

// Leaves per launch of the leaf-boundary form (the wrapper's
// `BOUNDARY_MAX_LEAVES`; the launcher refuses more): every model of the
// zoo at the depths the port runs has at most 113 leaves (xlstm-1.3b),
// so a step is one launch; the table rides in the 32 KB of kernel
// parameters that CUDA 12.1 and later give sm_70 and up
constexpr int kBoundaryLeaves = 128;
// 4-coordinate groups per thread, and so coordinates per block
constexpr int kGroups = 2;
constexpr int kBlockCoords = 4 * kGroups * kThreads;
// the tile body's tile: kTileR rows of the swapped operand's contiguous
// axis (a 128-byte line of bf16) by kTileK of th's (a line of fp32)
constexpr int kTileR = 64;
constexpr int kTileK = 32;
static_assert(kTileR * kTileK == kBlockCoords, "a tile is a block's work");

struct BoundaryLeaf {
  int64_t off;        // the leaf's first coordinate in a client's rows
  int64_t n;          // its coordinates a client
  int64_t mats, r, k; // as mats stacked r x k matrices (the tile body)
  const void* in[2];  // g, h_hat: client c's run starts c*cs[i] in
  int64_t cs[2];
  void* out;          // the leaf's th store, client c at c*n; null: none
  int8_t code[3];     // dtype codes of g, h_hat, out
  int8_t swapped[2];  // g, h_hat stored with the last two axes swapped
  int8_t vec;         // every operand aligned for the vector accesses
  int8_t tiled;       // some input swapped: the tile body
};

struct BoundaryTable {
  float* th;
  float* m;
  float* h;
  int64_t padded;     // coordinates a client in th, m, h
  int leaves;
  int first_block[kBoundaryLeaves + 1];  // [leaves]: blocks a client
  BoundaryLeaf leaf[kBoundaryLeaves];
};
static_assert(sizeof(BoundaryTable) + sizeof(Hyper) <= 32764,
              "the leaf table must fit the 32 KB of kernel parameters");

// four consecutive elements of an fp32 or bf16 operand at element i
// (aligned), upcast: a bf16 widens exactly by a 16-bit shift
__device__ __forceinline__ void load4(const void* p, int64_t i, int code,
                                      float* v) {
  if (code == kBF16) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
    const float4 f =
        __ldcs(reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                               i));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void store4(void* p, int64_t i, int code,
                                       const float* v) {
  if (code == kBF16) {
    uint2 u;
    u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i), u);
  } else {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(p) + i),
           make_float4(v[0], v[1], v[2], v[3]));
  }
}

__device__ __forceinline__ float4 ld_f4(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

// th, m, h of `cnt` (1..4) consecutive coordinates from flat index f:
// float4 when `vec` and cnt == 4
__device__ __forceinline__ void load_state(const BoundaryTable& t,
                                           int64_t f, int cnt, bool vec,
                                           float (&v)[5][4]) {
  if (vec && cnt == 4) {
    const float4 a = ld_f4(t.th + f), b = ld_f4(t.m + f), c = ld_f4(t.h + f);
    v[0][0] = a.x; v[0][1] = a.y; v[0][2] = a.z; v[0][3] = a.w;
    v[1][0] = b.x; v[1][1] = b.y; v[1][2] = b.z; v[1][3] = b.w;
    v[2][0] = c.x; v[2][1] = c.y; v[2][2] = c.z; v[2][3] = c.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < cnt) {
      v[0][q] = t.th[f + q];
      v[1][q] = t.m[f + q];
      v[2][q] = t.h[f + q];
    }
  }
}

// input k (0: g, 1: h_hat) of a leaf's run, `cnt` consecutive
// coordinates from element i of the run
__device__ __forceinline__ void load_input(const BoundaryLeaf& d, int k,
                                           int64_t i, int cnt, bool vec,
                                           float* v) {
  if (vec && cnt == 4) {
    load4(d.in[k], i, d.code[k], v);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < cnt) v[q] = to_f32(d.in[k], i + q, d.code[k]);
  }
}

// the step of `cnt` consecutive coordinates from flat index f (element
// o of the leaf store), from the loaded v, and its stores
__device__ __forceinline__ void step_group(const BoundaryTable& t,
                                           const BoundaryLeaf& d,
                                           const Hyper& p, int64_t f,
                                           int64_t o, int cnt, bool vec,
                                           const float (&v)[5][4]) {
  float th[4], mo[4], ho[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < cnt) {
      sophia_coord(p, v[0][q], v[1][q], v[2][q], v[3][q], v[4][q], th[q],
                   mo[q], ho[q]);
    }
  }
  if (vec && cnt == 4) {
    __stcs(reinterpret_cast<float4*>(t.th + f),
           make_float4(th[0], th[1], th[2], th[3]));
    __stcs(reinterpret_cast<float4*>(t.m + f),
           make_float4(mo[0], mo[1], mo[2], mo[3]));
    __stcs(reinterpret_cast<float4*>(t.h + f),
           make_float4(ho[0], ho[1], ho[2], ho[3]));
    if (d.out != nullptr) store4(d.out, o, d.code[2], th);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < cnt) {
      t.th[f + q] = th[q];
      t.m[f + q] = mo[q];
      t.h[f + q] = ho[q];
      if (d.out != nullptr) from_f32(d.out, o + q, d.code[2], th[q]);
    }
  }
}

// at most 64 registers a thread, four blocks an SM: at the 92 it takes
// unbounded (the groups' loads in flight across the tile's staging), two
// blocks an SM held a step over minicpm-2b's leaves (its tied embedding
// in the tile body) to 65-72% of the bytes bound on an H100, four reach
// 79-85%; five or six spill and fall to 60-71%
__global__ void __launch_bounds__(kThreads, 4) sophia_boundary_kernel(
    const __grid_constant__ BoundaryTable t, Hyper p) {
  // the block's leaf: the last whose first block is at or before it
  // (every leaf owns at least one block); uniform across the block
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const BoundaryLeaf& d = t.leaf[lo];
  const int64_t c = blockIdx.y;
  const int64_t tile = b - t.first_block[lo];
  const int64_t flat0 = c * t.padded + d.off;  // the run's coordinate 0
  const int64_t in0[2] = {c * d.cs[0], c * d.cs[1]};
  const int64_t out0 = c * d.n;
  const bool vec = d.vec != 0;
  float v[kGroups][5][4];
  int64_t at[kGroups];  // each group's first element of the run
  int cnt[kGroups];
  if (!d.tiled) {
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      at[u] = tile * kBlockCoords + 4 * (u * kThreads + threadIdx.x);
      // the group's coordinates left in the run (a prefix of the four)
      const int64_t left = d.n - at[u];
      cnt[u] = left <= 0 ? 0 : (left < 4 ? static_cast<int>(left) : 4);
      if (cnt[u] > 0) {
        load_state(t, flat0 + at[u], cnt[u], vec, v[u]);
        load_input(d, 0, in0[0] + at[u], cnt[u], vec, v[u][3]);
        load_input(d, 1, in0[1] + at[u], cnt[u], vec, v[u][4]);
      }
    }
  } else {
    // tile (a, r0, k0) of the mats stacked r x k matrices
    __shared__ float staged[2][kTileK][kTileR + 1];
    const int64_t tiles_k = (d.k + kTileK - 1) / kTileK;
    const int64_t tiles_r = (d.r + kTileR - 1) / kTileR;
    const int64_t a = tile / (tiles_r * tiles_k);
    const int64_t r0 = (tile / tiles_k) % tiles_r * kTileR;
    const int64_t k0 = tile % tiles_k * kTileK;
    const int64_t mat0 = a * d.r * d.k;
    // th, m, h and an unswapped input first: their loads are in flight
    // while the swapped tiles are staged
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int e = u * kThreads + threadIdx.x;
      const int64_t row = r0 + e / (kTileK / 4);
      const int64_t col = k0 + 4 * (e % (kTileK / 4));
      at[u] = mat0 + row * d.k + col;
      const int64_t left = d.k - col;
      cnt[u] = (row >= d.r || left <= 0) ? 0
               : (left < 4 ? static_cast<int>(left) : 4);
      if (cnt[u] > 0) {
        load_state(t, flat0 + at[u], cnt[u], vec, v[u]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (!d.swapped[k]) {
            load_input(d, k, in0[k] + at[u], cnt[u], vec, v[u][3 + k]);
          }
        }
      }
    }
    // a swapped operand holds (row, col) at col*r + row: each thread
    // reads four consecutive rows of a column
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (d.swapped[k]) {
        for (int e = threadIdx.x; e < kTileR * kTileK / 4; e += kThreads) {
          const int kk = e / (kTileR / 4), rq = 4 * (e % (kTileR / 4));
          const int64_t row = r0 + rq, col = k0 + kk;
          if (col < d.k) {
            const int64_t left = d.r - row;
            const int n = left <= 0 ? 0 : (left < 4 ? static_cast<int>(left)
                                                    : 4);
            float w[4];
            load_input(d, k, in0[k] + mat0 + col * d.r + row, n, vec, w);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (q < n) staged[k][kk][rq + q] = w[q];
            }
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int e = u * kThreads + threadIdx.x;
      const int rr = e / (kTileK / 4), kk = 4 * (e % (kTileK / 4));
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (d.swapped[k] && cnt[u] > 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q < cnt[u]) v[u][3 + k][q] = staged[k][kk + q][rr];
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kGroups; ++u) {
    if (cnt[u] > 0) {
      step_group(t, d, p, flat0 + at[u], out0 + at[u], cnt[u], vec, v[u]);
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

// The leaf-boundary form over `leaves` (1..kBoundaryLeaves) leaves of
// `clients` clients' th, m, h (fp32, `padded` coordinates a client, in
// place): per leaf l, dims[5l..5l+4] (off, n, mats, r, k), ptrs[3l..3l+2]
// (g, h_hat, out; out may be null), cs[2l..2l+1] (g's and h_hat's client
// strides), flags[7l..7l+6] (the dtype codes of g, h_hat and out, g and
// h_hat swapped, vec, tiled) and first_block[l]; first_block[leaves] is
// the grid's width.  Copies the table into the launch's parameters;
// keeps no pointer to the host arrays.
extern "C" int sophia_boundary_launch(
    float* theta, float* m, float* h, int64_t padded, int clients,
    const int64_t* dims, void* const* ptrs, const int64_t* cs,
    const int* flags, const int* first_block, int leaves, float do_h,
    float lr, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float rho, float eps, float weight_decay,
    void* stream) {
  if (leaves < 1 || leaves > kBoundaryLeaves || clients < 1 ||
      clients > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (first_block[leaves] <= 0) return static_cast<int>(cudaSuccess);
  BoundaryTable t{};
  t.th = theta;
  t.m = m;
  t.h = h;
  t.padded = padded;
  t.leaves = leaves;
  for (int l = 0; l < leaves; ++l) {
    BoundaryLeaf& d = t.leaf[l];
    d.off = dims[5 * l];
    d.n = dims[5 * l + 1];
    d.mats = dims[5 * l + 2];
    d.r = dims[5 * l + 3];
    d.k = dims[5 * l + 4];
    for (int k = 0; k < 2; ++k) {
      d.in[k] = ptrs[3 * l + k];
      d.cs[k] = cs[2 * l + k];
      d.swapped[k] = static_cast<int8_t>(flags[7 * l + 3 + k] != 0);
    }
    d.out = ptrs[3 * l + 2];
    for (int k = 0; k < 3; ++k) {
      d.code[k] = static_cast<int8_t>(flags[7 * l + k]);
    }
    d.vec = static_cast<int8_t>(flags[7 * l + 5] != 0);
    d.tiled = static_cast<int8_t>(flags[7 * l + 6] != 0);
    t.first_block[l] = first_block[l];
  }
  t.first_block[leaves] = first_block[leaves];
  const dim3 grid(first_block[leaves], clients);
  const Hyper hp{do_h,  lr,  beta1, one_minus_beta1, beta2, one_minus_beta2,
                 rho,   eps, weight_decay};
  sophia_boundary_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(t, hp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sophia_update_threads() { return kThreads; }

// coordinates a block of the leaf-boundary form owns, and its tile
extern "C" int sophia_boundary_block_coords() { return kBlockCoords; }
extern "C" int sophia_boundary_tile_rows() { return kTileR; }
extern "C" int sophia_boundary_tile_cols() { return kTileK; }
