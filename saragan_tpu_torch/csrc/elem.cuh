// Element types of the port's CUDA kernels: loads widen to f32, stores round once.
//
// Kernels are templated on T in {float, __nv_bfloat16}; all arithmetic is f32.  A bf16
// value widens exactly (its 16 bits are the top half of an f32), and the store rounds
// to nearest even, as XLA's convert does in the reference.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace saragan {

// dtype codes shared with the Python wrappers (ops/conv3d_flat.py)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <typename T>
__device__ __forceinline__ float load_f32(const T* p);

template <>
__device__ __forceinline__ float load_f32<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

template <typename T>
__device__ __forceinline__ T store_t(float v);

template <>
__device__ __forceinline__ float store_t<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace saragan
