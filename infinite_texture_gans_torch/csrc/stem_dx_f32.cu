// The discriminator stem's input gradient (K13 dx) on the CUDA cores: the
// float32 route (bf16 runs on the tensor cores in stem_dx_tc.cu; this entry
// point takes bf16 too). The stem's forward is stem_fwd_f32.cu, its dW
// stem_dw_f32.cu.
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:2977 _stem_dx_call
// (kernel _stem_dx_kernel :2877), reached through conv4x4s2_stem_chw
// (:3086): for g (N, H/2, W/2, Co) NHWC and the OIHW float32 weight w (Co,
// C, 4, 4), C <= 4, dx[n, c, r, s] = sum over the taps whose stride-2
// window covers (r, s): per axis the tap parity is fixed by the pixel's, so
// at most 2 x 2 output pixels feed it.
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per output pixel
// against 4 (4 C + Co) bytes in float32: at C = 3, Co = 64 the FFMAs (67
// TFLOP/s) bound it about as much as the bytes. What the design does about
// it: one thread per image pixel and all C channels; the block stages the 6
// x 18 g pixels under its 8 x 32 tile (odd stride per pixel, so the lanes'
// different output pixels hit different banks) and the weights, and
// gathers its at most 4 taps per output channel. Each pixel sums its (o,
// tap) products in one fixed order. The TPU kernel's 0/1 selection matmuls,
// row-stacked packing and 8-row alignment have no counterpart.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;
constexpr int kTO = 64;  // output channels a staged chunk
constexpr int kDxTH = 8;
constexpr int kDxTW = 32;
constexpr int kGRows = kDxTH / 2 + 2;  // 6
constexpr int kGCols = kDxTW / 2 + 2;  // 18
constexpr int kGStride = kTO + 1;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
stem_dx_kernel(const T* __restrict__ g, const float* __restrict__ w, T* __restrict__ dx, int H,
               int W, int Co) {
  __shared__ float s_g[kGRows * kGCols * kGStride];
  __shared__ float s_w[kTO][C * 16];
  const int H2 = H / 2;
  const int W2 = W / 2;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * kDxTH;
  const int s0 = blockIdx.x * kDxTW;
  const int i0 = r0 / 2 - 1;
  const int j0 = s0 / 2 - 1;
  const int tid = threadIdx.y * kDxTW + threadIdx.x;
  const int r = r0 + threadIdx.y;
  const int s = s0 + threadIdx.x;
  const int ky0 = (r + 1) & 1;
  const int kx0 = (s + 1) & 1;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int o0 = 0; o0 < Co; o0 += kTO) {
    for (int idx = tid; idx < kGRows * kGCols * kTO; idx += kThreads) {
      const int oc = idx % kTO;
      const int cell = idx / kTO;
      const int gi = i0 + cell / kGCols;
      const int gj = j0 + cell % kGCols;
      const bool ok = gi >= 0 && gi < H2 && gj >= 0 && gj < W2 && o0 + oc < Co;
      s_g[cell * kGStride + oc] =
          ok ? to_f32<T>(g[((static_cast<size_t>(n) * H2 + gi) * W2 + gj) * Co + o0 + oc]) : 0.f;
    }
    for (int idx = tid; idx < kTO * C * 16; idx += kThreads) {
      const int oc = idx / (C * 16);
      s_w[oc][idx % (C * 16)] = o0 + oc < Co ? w[static_cast<size_t>(o0) * C * 16 + idx] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int ky = ky0 + 2 * a;
      const int gi = (r + 1 - ky) / 2;  // exact: r + 1 - ky is even
      if (gi < 0 || gi >= H2) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int kx = kx0 + 2 * b;
        const int gj = (s + 1 - kx) / 2;
        if (gj < 0 || gj >= W2) continue;
        const float* gp = s_g + ((gi - i0) * kGCols + (gj - j0)) * kGStride;
        for (int oc = 0; oc < kTO; ++oc) {
          const float gv = gp[oc];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = fmaf(gv, s_w[oc][c * 16 + ky * 4 + kx], acc[c]);
        }
      }
    }
    __syncthreads();
  }
  if (r < H && s < W) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dx[((static_cast<size_t>(n) * C + c) * H + r) * W + s] = from_f32<T>(acc[c]);
    }
  }
}

template <typename T, int C>
int launch(const void* g, const void* w, void* dx, int n, int h, int width, int co,
           cudaStream_t stream) {
  const dim3 grid((width + kDxTW - 1) / kDxTW, (h + kDxTH - 1) / kDxTH, n);
  stem_dx_kernel<T, C><<<grid, dim3(kDxTW, kDxTH), 0, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(w), static_cast<T*>(dx), h, width, co);
  return itg::last_error();
}

template <typename T>
int dispatch(int c, const void* g, const void* w, void* dx, int n, int h, int width, int co,
             cudaStream_t stream) {
  switch (c) {
    case 1: return launch<T, 1>(g, w, dx, n, h, width, co, stream);
    case 2: return launch<T, 2>(g, w, dx, n, h, width, co, stream);
    case 3: return launch<T, 3>(g, w, dx, n, h, width, co, stream);
    case 4: return launch<T, 4>(g, w, dx, n, h, width, co, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// g (N, H/2, W/2, Co) activation type, w (Co, C, 4, 4) float32 -> dx (N, C,
// H, W) activation type.
extern "C" int itg_stem_dx(const void* g, const void* w, void* dx, int n, int c, int h, int width,
                           int co, int bf16, void* stream) {
  if (h % 2 || width % 2) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(c, g, w, dx, n, h, width, co, st);
  return dispatch<float>(c, g, w, dx, n, h, width, co, st);
}
