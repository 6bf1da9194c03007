// 1x1 convolution (+ bias, + optional residual, + optional output stats) on
// channels-major (N, C, H, W) activations, and its weight gradient: the
// generator ResBlock's shortcut fused with the residual add.
//
// Replaces two TPU kernels:
//   K3 infinite_texture_gans_tpu/ops/pallas_conv.py:_conv1x1_chw_fwd (:2311,
//      kernel _conv1x1_kernel :2243), called through conv1x1_chw (:2381),
//      conv1x1_chw_add (:2412) and, with the per-channel sums of the stored
//      output, conv1x1_chw_add_stats (:2435) / conv1x1_chw_add_p (:1140).
//      y = W x + b (+ res), per pixel. Its dx is this kernel again with the
//      transposed weights and a zero bias, as the reference's
//      _conv1x1_bwd_rule (:2397) does.
//   K3-dW pallas_conv.py:_conv1x1_chw_dw (:2361, kernel _dw1x1_kernel :2326):
//      dW[o, c] = sum g[o] x[c] and db[o] = sum g[o] over (N, H, W).
//
// What bounds them on the H100: the forward does 2 * C * Co FLOPs per pixel
// against 2 * (C + 2 Co) bytes in bf16 (x, res, y), about 23 FLOP/byte at
// the flagship 104 -> 52: well under the ridge, so the bound is bytes. The
// dW reduction reads x and g once (2 * (C + Co) bytes per pixel) for
// 2 * C * Co FLOPs: bytes again at these widths.
// What the design does about it: the forward runs one thread per pixel,
// walks the C input channels with coalesced loads along the pixel axis,
// reads the block's (C, TCO) weight slice from shared memory as float4
// broadcasts and writes y once; the stats epilogue reduces each block's
// stored values in registers and shared memory and adds them with one
// atomicAdd per block and channel. The dW kernel stages a 64-pixel chunk of
// x and g in shared memory (rows padded to an odd stride, so the threads of
// a warp, which own neighbouring input channels, hit distinct banks), keeps
// each thread's (o, c) pairs in registers across all the chunks it visits,
// and adds them to the zeroed output once per block. The TPU kernels' lane
// padding and fill matrices have no counterpart.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;

template <typename T, int TCO>
__global__ void __launch_bounds__(kThreads)
conv1x1_chw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const T* __restrict__ res,
                   T* __restrict__ y, float* __restrict__ s1, float* __restrict__ s2,
                   int C, int HW, int Co) {
  extern __shared__ __align__(16) float s_w[];  // (C, TCO)
  __shared__ float s_red[kThreads / 32][2 * TCO];
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * TCO;
  for (int i = threadIdx.x; i < C * TCO; i += kThreads) {
    const int co = co0 + i % TCO;
    s_w[i] = co < Co ? w[static_cast<size_t>(co) * C + i / TCO] : 0.f;
  }
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool inside = p < HW;

  float acc[TCO];
#pragma unroll
  for (int k = 0; k < TCO; ++k) acc[k] = 0.f;
  if (inside) {
    const T* xp = x + static_cast<size_t>(n) * C * HW + p;
    for (int c = 0; c < C; ++c) {
      const float v = to_f32<T>(xp[static_cast<size_t>(c) * HW]);
#pragma unroll
      for (int k = 0; k < TCO; k += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[c * TCO + k]);
        acc[k] = fmaf(v, wv.x, acc[k]);
        acc[k + 1] = fmaf(v, wv.y, acc[k + 1]);
        acc[k + 2] = fmaf(v, wv.z, acc[k + 2]);
        acc[k + 3] = fmaf(v, wv.w, acc[k + 3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TCO; ++k) {
    const int co = co0 + k;
    float stored = 0.f;
    if (inside && co < Co) {
      const size_t o = (static_cast<size_t>(n) * Co + co) * HW + p;
      float out = acc[k] + bias[co];
      if (res) out += to_f32<T>(res[o]);
      const T yv = from_f32<T>(out);
      y[o] = yv;
      stored = to_f32<T>(yv);
    }
    acc[k] = stored;
  }
  if (s1) {  // the same for every thread of the launch
    float v[2 * TCO];
#pragma unroll
    for (int k = 0; k < TCO; ++k) {
      v[k] = acc[k];
      v[TCO + k] = acc[k] * acc[k];
    }
    itg::block_sum2_atomic<TCO>(v, &s_red[0][0], s1 + co0, s2 + co0, min(TCO, Co - co0));
  }
}

template <typename T, int TCO>
int launch(const void* x, const float* w, const float* b, const void* res, void* y, float* s1,
           float* s2, int n, int c, int hw, int co, cudaStream_t stream) {
  const dim3 grid((hw + kThreads - 1) / kThreads, (co + TCO - 1) / TCO, n);
  const size_t smem = static_cast<size_t>(c) * TCO * sizeof(float);
  conv1x1_chw_kernel<T, TCO><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<const T*>(res), static_cast<T*>(y), s1, s2,
      c, hw, co);
  return itg::last_error();
}

template <typename T>
int dispatch(const void* x, const float* w, const float* b, const void* res, void* y,
             float* s1, float* s2, int n, int c, int hw, int co, cudaStream_t stream) {
  if (co <= 4) return launch<T, 4>(x, w, b, res, y, s1, s2, n, c, hw, co, stream);
  if (co <= 8) return launch<T, 8>(x, w, b, res, y, s1, s2, n, c, hw, co, stream);
  return launch<T, 16>(x, w, b, res, y, s1, s2, n, c, hw, co, stream);
}

// ---------------------------------------------------------------------------
// dW: (o, c) pairs in registers, 64-pixel chunks of x and g in shared memory.

constexpr int kChunkPx = 64;
constexpr int kStride = kChunkPx + 1;   // odd row stride: conflict-free columns
constexpr int kMaxPairs = 16;           // pairs per thread: Co * C <= 4096
constexpr int kMaxRows = 96;            // C + Co staged rows

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ dw,
                  float* __restrict__ db, int C, int HW, int Co, long long total) {
  __shared__ float s_x[kMaxRows * kStride];  // rows 0..C-1: x, rows C..C+Co-1: g
  const int tid = threadIdx.x;
  const int pairs = C * Co;
  float acc[kMaxPairs];
  float dbacc = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) acc[k] = 0.f;
  const float* s_g = s_x + C * kStride;

  for (long long q0 = static_cast<long long>(blockIdx.x) * kChunkPx; q0 < total;
       q0 += static_cast<long long>(gridDim.x) * kChunkPx) {
    for (int i = tid; i < (C + Co) * kChunkPx; i += kThreads) {
      const int row = i / kChunkPx;
      const int j = i % kChunkPx;
      const long long q = q0 + j;
      float v = 0.f;
      if (q < total) {
        const int nimg = static_cast<int>(q / HW);
        const int p = static_cast<int>(q - static_cast<long long>(nimg) * HW);
        v = row < C ? to_f32<T>(x[(static_cast<size_t>(nimg) * C + row) * HW + p])
                    : to_f32<T>(g[(static_cast<size_t>(nimg) * Co + (row - C)) * HW + p]);
      }
      s_x[row * kStride + j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      const int pr = tid + k * kThreads;
      if (pr < pairs) {
        const float* xr = s_x + (pr % C) * kStride;
        const float* gr = s_g + (pr / C) * kStride;
        float a = acc[k];
        for (int j = 0; j < kChunkPx; ++j) a = fmaf(gr[j], xr[j], a);
        acc[k] = a;
      }
    }
    if (tid < Co) {
      const float* gr = s_g + tid * kStride;
      for (int j = 0; j < kChunkPx; ++j) dbacc += gr[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int pr = tid + k * kThreads;
    if (pr < pairs) atomicAdd(dw + pr, acc[k]);  // dw (Co, C): pr = o * C + c
  }
  if (tid < Co) atomicAdd(db + tid, dbacc);
}

template <typename T>
int launch_dw(const void* x, const void* g, float* dw, float* db, int n, int c, int hw, int co,
              cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * hw;
  const long long chunks = (total + kChunkPx - 1) / kChunkPx;
  const int blocks = static_cast<int>(chunks < 4 * 132 ? chunks : 4 * 132);
  conv1x1_dw_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dw, db, c, hw, co, total);
  return itg::last_error();
}

}  // namespace

// x (N, C, HW), res and y (N, Co, HW): activation type (float32, or bfloat16
// when bf16 != 0); res may be null. w (Co, C), b (Co): float32. s1/s2 (Co)
// float32, zeroed by the caller, or null for no stats. C * 16 * 4 bytes of
// weights must fit the default 48 KB of shared memory (C <= 768).
// Returns cudaGetLastError() after the launch.
extern "C" int itg_conv1x1_chw(const void* x, const void* w, const void* b, const void* res,
                               void* y, void* s1, void* s2, int n, int c, int hw, int co,
                               int bf16, void* stream) {
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* a = static_cast<float*>(s1);
  auto* q = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(x, wf, bf, res, y, a, q, n, c, hw, co, st);
  return dispatch<float>(x, wf, bf, res, y, a, q, n, c, hw, co, st);
}

// x (N, C, HW), g (N, Co, HW): activation type. dw (Co, C) and db (Co):
// float32, zeroed by the caller; the kernel adds into them. Needs
// C * Co <= 4096 and C + Co <= 96. Returns cudaGetLastError().
extern "C" int itg_conv1x1_chw_dw(const void* x, const void* g, void* dw, void* db, int n, int c,
                                  int hw, int co, int bf16, void* stream) {
  if (c * co > kMaxPairs * kThreads || c + co > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_dw<__nv_bfloat16>(x, g, w, b, n, c, hw, co, st);
  return launch_dw<float>(x, g, w, b, n, c, hw, co, st);
}
