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

// Two float32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The values of a 16-byte vector as float32 (8 bf16 or 4 float32), and back
// (bf16: rounded to nearest even; a bf16 value is the high half of its
// float32).
__device__ __forceinline__ void unpack_vec(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack_vec(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint4 pack_vec(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                    pack_bf16x2(f[6], f[7]));
}

__device__ __forceinline__ uint4 pack_vec(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// R values of a row from p, as float32: 16-byte loads where vec and all R
// are valid, else element by element up to `valid` (zeros past it).
template <typename T, int R>
__device__ __forceinline__ void load_run(const T* p, float (&v)[R], int valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  static_assert(R % V == 0, "a run is whole 16-byte vectors");
  if (vec && valid >= R) {
#pragma unroll
    for (int i = 0; i < R; i += V) {
      float f[V];
      unpack_vec(*reinterpret_cast<const uint4*>(p + i), f);
#pragma unroll
      for (int e = 0; e < V; ++e) v[i + e] = f[e];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = i < valid ? to_f32<T>(p[i]) : 0.f;
}

// R values of a row to p in T: 16-byte stores where vec and all R are valid,
// else element by element up to `valid`.
template <typename T, int R>
__device__ __forceinline__ void store_run(T* p, const float (&v)[R], int valid, bool vec) {
  constexpr int V = 16 / sizeof(T);
  static_assert(R % V == 0, "a run is whole 16-byte vectors");
  if (vec && valid >= R) {
#pragma unroll
    for (int i = 0; i < R; i += V) {
      float f[V];
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = v[i + e];
      *reinterpret_cast<uint4*>(p + i) = pack_vec(f);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < valid) p[i] = from_f32<T>(v[i]);
  }
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// The current device's SM count (read per call: the caller may switch cards).
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

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
