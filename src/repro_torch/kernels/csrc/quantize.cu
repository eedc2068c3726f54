// The compressors' round-trip kernels for Hopper (sm_90a), with a plain C
// interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   quant_roundtrip_kernel     <- _quant_kernel     (quant_roundtrip_flat,
//                                                    quant_roundtrip_batched)
//   quant_roundtrip_f32x4_kernel  its fp32 form      (both entries)
//   uplink_roundtrip_kernel    <- _uplink_kernel    (uplink_roundtrip_flat,
//                                                    uplink_roundtrip_batched)
//   uplink_roundtrip_f32x4_kernel its fp32 form      (both entries)
//   broadcast_roundtrip_kernel <- _broadcast_kernel (broadcast_roundtrip_flat,
//                                                    broadcast_roundtrip_batched)
//   broadcast_roundtrip_f32x4_kernel its fp32 form   (both entries)
//   per_client_kernel<SignOp>   <- _sign_kernel, _sign_kernel_batched
//     (sign_roundtrip_flat, sign_roundtrip_batched)
//   per_client_kernel<ThreshOp> <- _thresh_kernel, _thresh_kernel_batched
//     (topk_threshold_flat, topk_threshold_batched)
//   per_client_f32x4_kernel<SignOp|ThreshOp> their fp32 form (all four)
//
// The stochastic quantizers (int8/int4), per coordinate, with s the row's
// scale and u the streamed U[0,1) noise:
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
// materialised per client.  In-kernel Philox noise and a fused per-row
// max are later work.
//
// The quant round-trip has a second, fp32 form
// (quant_roundtrip_f32x4_kernel), taken per launch when x and out are fp32,
// x, u and out are 16-byte aligned and C % 4 == 0: no dtype switch, a
// thread per float4 group of x (a group never straddles two rows), one
// float4 of x and one of u issued before use with the evict-first hint,
// the group's row scale by one load that the warp's threads share.  What
// held the row-per-block form back was latency, not bytes: at (116, 1024)
// 116 blocks, each thread walking its four columns one by one, every
// element behind a runtime dtype switch and a separate 4-byte noise load.
// Its block size is chosen from chip_smoke.py's sweep_quant_grid.
//
// The uplink round-trip has the same kind of fp32 form
// (uplink_roundtrip_f32x4_kernel), taken per launch when theta, start, ef
// and both outputs are fp32, those five and u are 16-byte aligned and
// C % 4 == 0: a thread per float4 group, the four float4 loads (theta,
// start, ef, u) issued before use, the two outputs by float4 stores, all
// with the evict-first hint but a shared start, which every client of a
// stack reads again and so keeps the default caching.  A shared start is
// read at group j % (R * C / 4), the row-per-block form's row % R.  The
// row-per-block form it replaces on fp32 ran at 9% of the byte bound at
// (116, 1024): every element behind three runtime dtype switches on its
// loads and two on its stores, each thread walking its four columns one
// by one.  Its block size is chosen from chip_smoke.py's
// sweep_uplink_grid.
//
// The broadcast round-trip has that form too
// (broadcast_roundtrip_f32x4_kernel), taken per launch when theta, ref, ef
// and both outputs are fp32, those five and u are 16-byte aligned and
// C % 4 == 0.  theta keeps the default caching in both entries: the flat
// entry's theta is the one server model that each client's launch of a
// sequential round reads again (475 KB at MLP-128, L2-resident), the
// batched entry's is read by every client of the stack; ref, ef and u,
// read once, take the evict-first hint.  The stores are plain: the new
// replica and residual are read again in the next round.  Its block size
// is chosen from chip_smoke.py's sweep_broadcast_grid.
//
// The biased compressors, one fp32 scalar v per client (the flat entry is
// one client), computed outside the kernel as the JAX package does:
//
//   sign:       out = v * sign(x), sign as jnp.sign: NaN and +-0 pass
//               through, else copysign(1, x)         (v = mean |x|)
//   threshold:  out = |x| >= v ? x : 0               (v = the k-th largest
//               |x|; NaN compares false and becomes 0, -0 is kept)
//
// Bytes bound these too (one compare or multiply per coordinate, one load
// and one store).  One grid-stride elementwise pass over chunks of
// kThreads elements that never straddle two clients: a chunk finds its
// client with one division, and every thread of it reads the same scalar
// (one broadcast load).  Their fp32 form (per_client_f32x4_kernel),
// taken per launch when x and out are fp32 and 16-byte aligned and each
// client holds a multiple of 4 elements: a thread per float4 group (a
// group never straddles two clients), no loop, no dtype switch, the load
// of x with the evict-first hint and the client's scalar by one load
// that the warp's threads share; the same functors per lane.  What held
// the chunked form back: one 4-byte load a thread per trip, each behind
// a runtime dtype switch, and the chunk's client by a 64-bit division on
// the scalar's dependency chain.  Its block size is chosen from
// chip_smoke.py's sweep_biased_grid.
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
// the most threads a block of an fp32 form may take
constexpr int kMaxF32x4Threads = 512;

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

// `groups` float4 groups of x, `groups_per_row` of them a row (C / 4);
// a thread per group.
__global__ void __launch_bounds__(kMaxF32x4Threads)
    quant_roundtrip_f32x4_kernel(float* __restrict__ out,
                                 const float* __restrict__ x,
                                 const float* __restrict__ u,
                                 const float* __restrict__ scale,
                                 int64_t groups, int64_t groups_per_row,
                                 float qmax) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= groups) return;
  const float4 xv = __ldcs(reinterpret_cast<const float4*>(x) + j);
  const float4 uv = __ldcs(reinterpret_cast<const float4*>(u) + j);
  const float s = __ldg(scale + j / groups_per_row);
  const float safe = s > 0.0f ? s : 1.0f;
  float4 o;
  o.x = quant(xv.x, s, safe, uv.x, qmax);
  o.y = quant(xv.y, s, safe, uv.y, qmax);
  o.z = quant(xv.z, s, safe, uv.z, qmax);
  o.w = quant(xv.w, s, safe, uv.w, qmax);
  __stcs(reinterpret_cast<float4*>(out) + j, o);
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

// `groups` float4 groups of theta, `groups_per_row` of them a row (C / 4);
// `start` holds start_groups groups (R * C / 4 when shared by every
// client, `groups` when stacked); a thread per group.
__global__ void __launch_bounds__(kMaxF32x4Threads)
    uplink_roundtrip_f32x4_kernel(float* __restrict__ xhat_out,
                                  float* __restrict__ resid_out,
                                  const float* __restrict__ theta,
                                  const float* __restrict__ start,
                                  const float* __restrict__ ef,
                                  const float* __restrict__ u,
                                  const float* __restrict__ scale,
                                  int64_t groups, int64_t groups_per_row,
                                  int64_t start_groups, float qmax) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= groups) return;
  const float4 tv = __ldcs(reinterpret_cast<const float4*>(theta) + j);
  const float4 sv =
      start_groups == groups
          ? __ldcs(reinterpret_cast<const float4*>(start) + j)
          : __ldg(reinterpret_cast<const float4*>(start) + j % start_groups);
  const float4 ev = __ldcs(reinterpret_cast<const float4*>(ef) + j);
  const float4 uv = __ldcs(reinterpret_cast<const float4*>(u) + j);
  const float s = __ldg(scale + j / groups_per_row);
  const float safe = s > 0.0f ? s : 1.0f;
  const float4 d = make_float4((tv.x - sv.x) + ev.x, (tv.y - sv.y) + ev.y,
                               (tv.z - sv.z) + ev.z, (tv.w - sv.w) + ev.w);
  float4 xh;
  xh.x = quant(d.x, s, safe, uv.x, qmax);
  xh.y = quant(d.y, s, safe, uv.y, qmax);
  xh.z = quant(d.z, s, safe, uv.z, qmax);
  xh.w = quant(d.w, s, safe, uv.w, qmax);
  __stcs(reinterpret_cast<float4*>(xhat_out) + j, xh);
  __stcs(reinterpret_cast<float4*>(resid_out) + j,
         make_float4(d.x - xh.x, d.y - xh.y, d.z - xh.z, d.w - xh.w));
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

// `groups` float4 groups of ref, `groups_per_row` of them a row (C / 4);
// `theta` holds theta_groups groups (R * C / 4 for the one shared server
// model, `groups` when stacked); a thread per group.
__global__ void __launch_bounds__(kMaxF32x4Threads)
    broadcast_roundtrip_f32x4_kernel(float* __restrict__ model_out,
                                     float* __restrict__ resid_out,
                                     const float* __restrict__ theta,
                                     const float* __restrict__ ref,
                                     const float* __restrict__ ef,
                                     const float* __restrict__ u,
                                     const float* __restrict__ scale,
                                     int64_t groups, int64_t groups_per_row,
                                     int64_t theta_groups, float qmax) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= groups) return;
  const float4 tv = __ldg(reinterpret_cast<const float4*>(theta) +
                          (theta_groups == groups ? j : j % theta_groups));
  const float4 rv = __ldcs(reinterpret_cast<const float4*>(ref) + j);
  const float4 ev = __ldcs(reinterpret_cast<const float4*>(ef) + j);
  const float4 uv = __ldcs(reinterpret_cast<const float4*>(u) + j);
  const float s = __ldg(scale + j / groups_per_row);
  const float safe = s > 0.0f ? s : 1.0f;
  const float4 d = make_float4((tv.x - rv.x) + ev.x, (tv.y - rv.y) + ev.y,
                               (tv.z - rv.z) + ev.z, (tv.w - rv.w) + ev.w);
  float4 xh;
  xh.x = quant(d.x, s, safe, uv.x, qmax);
  xh.y = quant(d.y, s, safe, uv.y, qmax);
  xh.z = quant(d.z, s, safe, uv.z, qmax);
  xh.w = quant(d.w, s, safe, uv.w, qmax);
  reinterpret_cast<float4*>(model_out)[j] =
      make_float4(rv.x + xh.x, rv.y + xh.y, rv.z + xh.z, rv.w + xh.w);
  reinterpret_cast<float4*>(resid_out)[j] =
      make_float4(d.x - xh.x, d.y - xh.y, d.z - xh.z, d.w - xh.w);
}

struct SignOp {
  __device__ __forceinline__ float operator()(float x, float v) const {
    const float sg = (x == 0.0f || x != x) ? x : copysignf(1.0f, x);
    return v * sg;
  }
};

struct ThreshOp {
  __device__ __forceinline__ float operator()(float x, float v) const {
    return fabsf(x) >= v ? x : 0.0f;
  }
};

// `x` is `clients` contiguous runs of `per_client` elements; run n uses
// scalar[n].  Work item c is chunk c % chunks_per_client of client
// c / chunks_per_client.
template <class Op>
__global__ void __launch_bounds__(kThreads) per_client_kernel(
    void* out, const void* x, const float* __restrict__ scalar, int c_x,
    int64_t per_client, int64_t chunks_per_client, int64_t chunks, Op op) {
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int64_t client = c / chunks_per_client;
    const int64_t j =
        (c - client * chunks_per_client) * kThreads + threadIdx.x;
    if (j < per_client) {
      const int64_t i = client * per_client + j;
      from_f32(out, i, c_x, op(to_f32(x, i, c_x), scalar[client]));
    }
  }
}

// `groups` float4 groups of x, `groups_per_client` of them a client
// (per_client / 4); group j uses scalar[j / groups_per_client].  A thread
// per group.
template <class Op>
__global__ void __launch_bounds__(kMaxF32x4Threads) per_client_f32x4_kernel(
    float* __restrict__ out, const float* __restrict__ x,
    const float* __restrict__ scalar, int64_t groups,
    int64_t groups_per_client, Op op) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= groups) return;
  const float4 xv = __ldcs(reinterpret_cast<const float4*>(x) + j);
  const float v = __ldg(scalar + j / groups_per_client);
  reinterpret_cast<float4*>(out)[j] =
      make_float4(op(xv.x, v), op(xv.y, v), op(xv.z, v), op(xv.w, v));
}

template <class Op>
int per_client_launch(void* out, const void* x, const float* scalar,
                      int c_x, int64_t clients, int64_t per_client,
                      int blocks, void* stream) {
  if (clients <= 0 || per_client <= 0) return static_cast<int>(cudaSuccess);
  const int64_t cpc = (per_client + kThreads - 1) / kThreads;
  per_client_kernel<Op><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      out, x, scalar, c_x, per_client, cpc, clients * cpc, Op());
  return static_cast<int>(cudaGetLastError());
}

template <class Op>
int per_client_f32x4_launch(float* out, const float* x, const float* scalar,
                            int64_t clients, int64_t per_client, int blocks,
                            int threads, void* stream) {
  if (clients <= 0 || per_client <= 0) return static_cast<int>(cudaSuccess);
  if (per_client % 4 != 0 || threads < 1 || threads > kMaxF32x4Threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  per_client_f32x4_kernel<Op><<<blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      out, x, scalar, clients * (per_client / 4), per_client / 4, Op());
  return static_cast<int>(cudaGetLastError());
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

// The fp32 form: x, u, out fp32 and 16-byte aligned, cols % 4 == 0;
// `threads` (at most 512) a block, `blocks` enough for a thread per float4
// group.
extern "C" int quant_roundtrip_f32x4_launch(float* out, const float* x,
                                            const float* u,
                                            const float* scale,
                                            int64_t rows, int cols,
                                            float qmax, int blocks,
                                            int threads, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  if (cols % 4 != 0 || threads < 1 || threads > kMaxF32x4Threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  quant_roundtrip_f32x4_kernel<<<blocks, threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      out, x, u, scale, rows * (cols / 4), cols / 4, qmax);
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

// The fp32 form: theta, start, ef and both outputs fp32, those and u
// 16-byte aligned, cols % 4 == 0; `threads` (at most 512) a block,
// `blocks` enough for a thread per float4 group.
extern "C" int uplink_roundtrip_f32x4_launch(
    float* xhat_out, float* resid_out, const float* theta,
    const float* start, const float* ef, const float* u,
    const float* scale, int64_t rows, int cols, int64_t start_rows,
    float qmax, int blocks, int threads, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  if (cols % 4 != 0 || threads < 1 || threads > kMaxF32x4Threads ||
      start_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uplink_roundtrip_f32x4_kernel<<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      xhat_out, resid_out, theta, start, ef, u, scale, rows * (cols / 4),
      cols / 4, start_rows * (cols / 4), qmax);
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

// The fp32 form: theta, ref, ef and both outputs fp32, those and u
// 16-byte aligned, cols % 4 == 0; `threads` (at most 512) a block,
// `blocks` enough for a thread per float4 group.
extern "C" int broadcast_roundtrip_f32x4_launch(
    float* model_out, float* resid_out, const float* theta,
    const float* ref, const float* ef, const float* u, const float* scale,
    int64_t rows, int cols, int64_t theta_rows, float qmax, int blocks,
    int threads, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  if (cols % 4 != 0 || threads < 1 || threads > kMaxF32x4Threads ||
      theta_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  broadcast_roundtrip_f32x4_kernel<<<blocks, threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      model_out, resid_out, theta, ref, ef, u, scale, rows * (cols / 4),
      cols / 4, theta_rows * (cols / 4), qmax);
  return static_cast<int>(cudaGetLastError());
}

// The biased compressors: `clients` runs of `per_client` elements (1 run
// for a flat entry), scalar[n] the scale or threshold of run n.  The grid
// strides over clients * ceil(per_client / 256) chunks.
extern "C" int sign_roundtrip_launch(void* out, const void* x,
                                     const float* scale, int c_x,
                                     int64_t clients, int64_t per_client,
                                     int blocks, void* stream) {
  return per_client_launch<SignOp>(out, x, scale, c_x, clients, per_client,
                                   blocks, stream);
}

extern "C" int topk_threshold_launch(void* out, const void* x,
                                     const float* thr, int c_x,
                                     int64_t clients, int64_t per_client,
                                     int blocks, void* stream) {
  return per_client_launch<ThreshOp>(out, x, thr, c_x, clients, per_client,
                                     blocks, stream);
}

// The fp32 form of both: x and out fp32 and 16-byte aligned,
// per_client % 4 == 0; `threads` (at most 512) a block, `blocks` enough
// for a thread per float4 group.
extern "C" int sign_roundtrip_f32x4_launch(float* out, const float* x,
                                           const float* scale,
                                           int64_t clients,
                                           int64_t per_client, int blocks,
                                           int threads, void* stream) {
  return per_client_f32x4_launch<SignOp>(out, x, scale, clients, per_client,
                                         blocks, threads, stream);
}

extern "C" int topk_threshold_f32x4_launch(float* out, const float* x,
                                           const float* thr,
                                           int64_t clients,
                                           int64_t per_client, int blocks,
                                           int threads, void* stream) {
  return per_client_f32x4_launch<ThreshOp>(out, x, thr, clients, per_client,
                                           blocks, threads, stream);
}
