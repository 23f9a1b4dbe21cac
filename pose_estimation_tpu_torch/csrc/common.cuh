// Shared helpers for the port's hand-written kernels. Every entry point is
// a plain C function: it launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (or -1 for a configuration it
// does not take), which the ctypes wrapper turns into an exception.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

typedef __nv_bfloat16 bf16;

#define POSE_UNSUPPORTED (-1)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: what an eager PyTorch op in dtype T stores
// (it computes in fp32 and rounds the result to T).
template <typename T> __device__ __forceinline__ float rn(float x) {
  return to_f32(from_f32<T>(x));
}

// ((a0*b0 + a1*b1) + a2*b2) + ... over D terms, every product and sum
// rounded on its own and then to T: no FMA contraction, the operation
// order of the plain PyTorch versions (one eager op per product and per
// sum), so kernel and reference agree to the last bit where they can.
template <typename T, int D>
__device__ __forceinline__ float dot_rn(const float* a, const float* b) {
  float acc = rn<T>(__fmul_rn(a[0], b[0]));
#pragma unroll
  for (int d = 1; d < D; ++d)
    acc = rn<T>(__fadd_rn(acc, rn<T>(__fmul_rn(a[d], b[d]))));
  return acc;
}

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  const float a[3] = {a0, a1, a2}, b[3] = {b0, b1, b2};
  return dot_rn<float, 3>(a, b);
}

static inline int pose_last_error() { return (int)cudaGetLastError(); }
