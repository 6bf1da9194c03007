// Shared helpers for the channels-major generator-tail and stem kernels.
//
// Every kernel takes float32 or bfloat16 activations (flag `bf16`), keeps its
// arithmetic in float32, and stores in the activation type. Weights, biases
// and the folded BatchNorm scale/shift always arrive as float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace itg {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to the storage type T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// act(scale * x + shift) rounded to the storage type T: the post-norm value
// the 3x3 conv kernels read (no FMA contraction, so every kernel that
// recomputes it gets the same bits).
template <typename T>
__device__ __forceinline__ float prenorm(float v, float scale, float shift, int relu) {
  float a = __fadd_rn(__fmul_rn(v, scale), shift);
  if (relu) a = fmaxf(a, 0.f);
  return round_to<T>(a);
}

// Sums v[k] over all threads of the block and adds the totals atomically:
// v[k] to out0[k] and v[N + k] to out1[k], for k < valid. `red` is shared
// memory of (threads / 32) * 2N floats. Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void block_sum2_atomic(float (&v)[2 * N], float* red, float* out0,
                                                  float* out1, int valid) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y) / 32;
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 2 * N; ++k) red[(tid >> 5) * 2 * N + k] = v[k];
  }
  __syncthreads();
  if (tid < 2 * N && tid % N < valid) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * 2 * N + tid];
    atomicAdd(tid < N ? out0 + tid : out1 + (tid - N), s);
  }
  __syncthreads();
}

}  // namespace itg
