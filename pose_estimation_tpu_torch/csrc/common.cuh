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

// (a0*b0 + a1*b1) + a2*b2 with every product and sum rounded on its own:
// no FMA contraction, the same operation order as the plain PyTorch
// versions, so kernel and reference agree to the last bit where they can.
__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

static inline int pose_last_error() { return (int)cudaGetLastError(); }
