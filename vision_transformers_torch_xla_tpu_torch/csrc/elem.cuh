// Element types of the CUDA-core kernels: bfloat16, half and float.
//
// The CUDA-core kernels stage their operands as fp32 and compute in fp32
// whatever the element type; only loads, stores and the rounding points
// change with it. Elem<T>::round(x) rounds an fp32 value to T and back,
// the `astype(x.dtype)` of the JAX kernels: an identity for float. Pair is
// two adjacent elements, loaded and stored as one (4 bytes for the 16-bit
// types, 8 for float).
//
// The host functions take the element type as an int code (kBf16, kF16,
// kF32); ops/cuda_build.py::dtype_code gives it for a torch dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

enum DtypeCode { kBf16 = 0, kF16 = 1, kF32 = 2 };

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  typedef __nv_bfloat16 T;
  typedef __nv_bfloat162 Pair;
  static __device__ __forceinline__ float load(T x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ T store(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float2 load2(Pair x) {
    return __bfloat1622float2(x);
  }
  static __device__ __forceinline__ Pair store2(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Elem<__half> {
  typedef __half T;
  typedef __half2 Pair;
  static __device__ __forceinline__ float load(T x) { return __half2float(x); }
  static __device__ __forceinline__ T store(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ float2 load2(Pair x) {
    return __half22float2(x);
  }
  static __device__ __forceinline__ Pair store2(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <>
struct Elem<float> {
  typedef float T;
  typedef float2 Pair;
  static __device__ __forceinline__ float load(T x) { return x; }
  static __device__ __forceinline__ T store(float x) { return x; }
  static __device__ __forceinline__ float2 load2(Pair x) { return x; }
  static __device__ __forceinline__ Pair store2(float a, float b) {
    return make_float2(a, b);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

// The scale of q^ = T(q * scale) in K1's, K2's and K9's cast order, on the
// host: JAX multiplies the T array by the Python float in T, so the scale
// is rounded to T first (an identity for float; at a head dim whose scale
// is a power of two, 64 or 256, for every T).
template <typename T>
inline float rounded_scale(float s);
template <>
inline float rounded_scale<__nv_bfloat16>(float s) {
  return __bfloat162float(__float2bfloat16_rn(s));
}
template <>
inline float rounded_scale<__half>(float s) {
  return __half2float(__float2half_rn(s));
}
template <>
inline float rounded_scale<float>(float s) {
  return s;
}

// fp32 values of a pair, whatever its element type (for helpers that see
// only the pair type).
__device__ __forceinline__ float2 load2(__nv_bfloat162 x) {
  return __bfloat1622float2(x);
}
__device__ __forceinline__ float2 load2(__half2 x) { return __half22float2(x); }
__device__ __forceinline__ float2 load2(float2 x) { return x; }

}  // namespace
