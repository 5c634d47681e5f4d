// The scalar helpers every schedule of kernels K3 and K4 shares (the grid,
// bitlinear.cuh; decode and stream through bitlinear_ring.cuh): the
// accumulator type, element loads, the rounding of z to C's dtype and of y
// to x's, and the layout arithmetic.  What they compute is bitlinear.cuh's
// note.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitlinear_impl {

template <typename XT>
struct Acc {
  using type = float;
};
template <>
struct Acc<int8_t> {
  using type = int;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ int ld(const int8_t* p) { return static_cast<int>(*p); }

__device__ __forceinline__ float as_f32(float z) { return z; }
// exact: |z| <= 128 * tn is far below 2^24
__device__ __forceinline__ float as_f32(int z) { return __int2float_rn(z); }

// z rounded to C's dtype (round to nearest), as the Pallas kernels' z.astype(c.dtype)
template <typename CT>
__device__ __forceinline__ float to_c(float z);
template <>
__device__ __forceinline__ float to_c<float>(float z) { return z; }
template <>
__device__ __forceinline__ float to_c<__nv_bfloat16>(float z) {
  return __bfloat162float(__float2bfloat16_rn(z));
}

template <typename XT>
__device__ __forceinline__ XT store_y(float acc);
template <>
__device__ __forceinline__ float store_y<float>(float acc) { return acc; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_y<__nv_bfloat16>(float acc) {
  return __float2bfloat16_rn(acc);
}
template <>
__device__ __forceinline__ int8_t store_y<int8_t>(float acc) {
  // toward zero, then saturate (cvt.rzi saturates to the int32 range itself)
  return static_cast<int8_t>(max(-128, min(127, __float2int_rz(acc))));
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

inline size_t x_size(int x_kind) { return x_kind == 0 ? 4 : x_kind == 1 ? 2 : 1; }

}  // namespace bitlinear_impl
