// Runtime-dtype loads and stores shared by the port's CUDA kernels.
//
// Every state operand carries a dtype code (kF32, kBF16, kE4M3, kE5M2);
// loads upcast to fp32 and stores round to the output's dtype.  The
// switch is uniform across a warp.  Narrow stores match torch.Tensor.to()
// on the card (pinned by chip_smoke.py, torch 2.11 + CUDA 12.8 on an
// H100): bf16 rounds to nearest even; fp8 rounds to nearest even without
// saturating, so e4m3 stores NaN past +-464 and for +-inf, e5m2 stores
// +-inf from +-61440 on; NaN stores as 0x7F with the input's sign bit in
// both.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace repro_torch {

enum DtypeCode : int { kF32 = 0, kBF16 = 1, kE4M3 = 2, kE5M2 = 3 };

__device__ __forceinline__ float to_f32(const void* p, int64_t i, int code) {
  switch (code) {
    case kBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kE4M3: {
      __nv_fp8_e4m3 v;
      v.__x = static_cast<const __nv_fp8_storage_t*>(p)[i];
      return static_cast<float>(v);
    }
    case kE5M2: {
      __nv_fp8_e5m2 v;
      v.__x = static_cast<const __nv_fp8_storage_t*>(p)[i];
      return static_cast<float>(v);
    }
    default:
      return static_cast<const float*>(p)[i];
  }
}

// fp8 store as torch rounds it: NaN -> 0x7F plus the sign bit (the CUDA
// conversion would give e5m2 NaN another payload), else round to nearest
// even with no saturation.
__device__ __forceinline__ __nv_fp8_storage_t to_fp8(
    float x, __nv_fp8_interpretation_t kind) {
  if (x != x) {
    return static_cast<__nv_fp8_storage_t>(
        0x7F | ((__float_as_uint(x) >> 24) & 0x80));
  }
  return __nv_cvt_float_to_fp8(x, __NV_NOSAT, kind);
}

__device__ __forceinline__ void from_f32(void* p, int64_t i, int code,
                                         float x) {
  switch (code) {
    case kBF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
      break;
    case kE4M3:
      static_cast<__nv_fp8_storage_t*>(p)[i] = to_fp8(x, __NV_E4M3);
      break;
    case kE5M2:
      static_cast<__nv_fp8_storage_t*>(p)[i] = to_fp8(x, __NV_E5M2);
      break;
    default:
      static_cast<float*>(p)[i] = x;
  }
}

}  // namespace repro_torch
