// Nearest-neighbour 2x upsample on channels-major (N, C, H, W) activations,
// y[n, c, 2i + a, 2j + b] = x[n, c, i, j], and its adjoint.
//
// Replaces K4 infinite_texture_gans_tpu/ops/pallas_conv.py:_up2_fwd_call
// (:2540, kernel _up2_kernel :2504), called through upsample2_chw (:2576)
// and upsample2_chw_p (:1174), and its backward _up2_bwd_call (:2560, kernel
// _up2_bwd_kernel :2518): dx[i, j] = (g[2i, 2j] + g[2i, 2j+1]) +
// (g[2i+1, 2j] + g[2i+1, 2j+1]), summed in float32 in that order (the
// reference's column pair-sum, then row pair-sum), so it matches the plain
// version bit for bit.
//
// What bounds it on the H100: it does no arithmetic; it reads each input
// element once and writes it four times, so the bound is bytes.
// What the design does about it: one thread per output element in a
// grid-stride loop, so consecutive threads store consecutive addresses
// (coalesced writes, the larger stream) and neighbouring thread pairs read
// the same input element, which the cache serves. The TPU kernel needed a
// 0/1 interleave matmul because Mosaic has no lane interleave; a plain
// gather has no such limit here. Values are copied bit for bit. The adjoint
// reads four values and writes one, bytes-bound too: one thread per output
// element, a 2-D grid (pixel blocks x planes) so that the index arithmetic
// is 32-bit with one division per thread, and each thread reads its 2x2
// block as two pairs of neighbouring elements.
//
// K10, the fused up-conv block's residual join, replaces
// upsample2_chw_add_p (pallas_conv.py:2173, pallas_call :2199, kernel
// _up2_add_kernel :2151): y = up2(x) + res in float32, stored in the
// activation type, with the optional float32 per-channel sums of the STORED
// y and y^2 (the next BatchNorm's batch moments). The port carries no lane
// padding, so the reference's pad-column fill has no counterpart. Bytes
// bound (it reads x and res once and writes y once): one thread per
// half-res pixel of one plane reads x once and its 2x2 block of res as two
// neighbouring pairs; a block's threads all lie in one plane, so with stats
// the block adds its two sums with one atomicAdd each. Its backward is K8
// (when the stats have cotangents) and K4's adjoint.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_chw_kernel(const T* __restrict__ x, T* __restrict__ y, long long planes, int H, int W) {
  const int W2 = 2 * W;
  const int H2 = 2 * H;
  const long long total = planes * H2 * W2;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int ox = static_cast<int>(i % W2);
    const long long t = i / W2;
    const int oy = static_cast<int>(t % H2);
    const long long p = t / H2;
    y[i] = x[(p * H + (oy >> 1)) * W + (ox >> 1)];
  }
}

template <typename T>
int launch(const void* x, void* y, long long planes, int h, int w, cudaStream_t stream) {
  const long long total = planes * 4LL * h * w;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  upsample2_chw_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, h, w);
  return itg::last_error();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_chw_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int planes, int H, int W) {
  const int hw = H * W;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= hw) return;
  const int i = idx / W;
  const int j = idx - i * W;
  const int W2 = 2 * W;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const T* g0 = g + (static_cast<size_t>(p) * 2 * H + 2 * i) * W2 + 2 * j;
    const float top = itg::to_f32<T>(g0[0]) + itg::to_f32<T>(g0[1]);
    const float bot = itg::to_f32<T>(g0[W2]) + itg::to_f32<T>(g0[W2 + 1]);
    dx[static_cast<size_t>(p) * hw + idx] = itg::from_f32<T>(top + bot);
  }
}

template <typename T>
int launch_bwd(const void* g, void* dx, int planes, int h, int w, cudaStream_t stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, planes < 65535 ? planes : 65535);
  upsample2_chw_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), planes, h, w);
  return itg::last_error();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_add_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                     float* __restrict__ s1, float* __restrict__ s2, int planes, int C, int H,
                     int W) {
  __shared__ float s_red[kThreads / 32][2];
  const int hw = H * W;
  const int W2 = 2 * W;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    float v[2] = {0.f, 0.f};
    for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < hw; idx += gridDim.x * kThreads) {
      const int i = idx / W;
      const int j = idx - i * W;
      const float xv = itg::to_f32<T>(x[static_cast<size_t>(p) * hw + idx]);
      const size_t top = (static_cast<size_t>(p) * 2 * H + 2 * i) * W2 + 2 * j;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const size_t off = top + a * W2 + b;
          const T out = itg::from_f32<T>(xv + itg::to_f32<T>(res[off]));
          y[off] = out;
          const float f = itg::to_f32<T>(out);
          v[0] += f;
          v[1] += f * f;
        }
      }
    }
    if (s1) {  // the same for every thread of the launch
      const int c = p % C;
      itg::block_sum2_atomic<1>(v, &s_red[0][0], s1 + c, s2 + c, 1);
    }
  }
}

template <typename T>
int launch_add(const void* x, const void* res, void* y, float* s1, float* s2, int planes, int c,
               int h, int w, cudaStream_t stream) {
  const int want = (h * w + kThreads - 1) / kThreads;
  const dim3 grid(want < 256 ? want : 256, planes < 65535 ? planes : 65535);
  upsample2_add_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), s1, s2, planes, c,
      h, w);
  return itg::last_error();
}

}  // namespace

// x (planes = N * C, H, W) -> y (planes, 2H, 2W), 4-byte elements (float32)
// or 2-byte elements (bfloat16, when bf16 != 0). Returns cudaGetLastError().
extern "C" int itg_upsample2_chw(const void* x, void* y, long long planes, int h, int w,
                                 int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, y, planes, h, w, st);
  return launch<float>(x, y, planes, h, w, st);
}

// g (planes, 2H, 2W) -> dx (planes, H, W), float32 or bfloat16 (bf16 != 0);
// H * W < 2^31. Returns cudaGetLastError().
extern "C" int itg_upsample2_chw_bwd(const void* g, void* dx, int planes, int h, int w, int bf16,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_bwd<__nv_bfloat16>(g, dx, planes, h, w, st);
  return launch_bwd<float>(g, dx, planes, h, w, st);
}

// x (planes = N * C, H, W), res and y (planes, 2H, 2W): float32 or bfloat16
// (bf16 != 0); H * W < 2^31. s1/s2 (C) float32, zeroed by the caller, or
// null for no stats. Returns cudaGetLastError().
extern "C" int itg_upsample2_chw_add(const void* x, const void* res, void* y, void* s1, void* s2,
                                     int planes, int c, int h, int w, int bf16, void* stream) {
  auto* a = static_cast<float*>(s1);
  auto* q = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_add<__nv_bfloat16>(x, res, y, a, q, planes, c, h, w, st);
  return launch_add<float>(x, res, y, a, q, planes, c, h, w, st);
}
