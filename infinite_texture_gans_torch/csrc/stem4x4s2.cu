// The discriminator's stem: a 4x4 / stride-2 / zero-pad-1 convolution of a
// channels-major (N, C, H, W) image (C <= 4, the 3-channel fake) into NHWC
// (N, H/2, W/2, Co): its weight and input gradients on the CUDA cores (the
// forward is stem_fwd_f32.cu).
//
// Replaces two TPU kernels of infinite_texture_gans_tpu/ops/pallas_conv.py,
// reached through conv4x4s2_stem_chw (:3086):
//   K13 dW _stem_dw_call (:2840, kernel _stem_dw_kernel :2788): dW[o, c, ky,
//       kx] = sum g[n, i, j, o] x[n, c, 2i + ky - 1, 2j + kx - 1] and
//       db[o] = sum g[n, i, j, o];
//   K13 dx _stem_dx_call (:2977, kernel _stem_dx_kernel :2877): dx[n, c, r,
//       s] = sum over the taps whose stride-2 window covers (r, s): per axis
//       the tap parity is fixed by the pixel's, so at most 2 x 2 output
//       pixels feed it.
// The weight is the (spectrally normalised) kernel the caller passes, OIHW
// float32.
//
// What bounds them on the H100: 2 * 16 * C * Co FLOPs per output pixel
// against 4 * C input and 2 * Co output bytes in bf16 (about 16 FLOP/byte
// at C = 3, Co = 64): bytes at the dense bound. These are the float32
// routes (bf16 runs on the tensor cores in stem_dw_tc.cu and
// stem_dx_tc.cu), and in float32 the FFMAs (67 TFLOP/s) bound them about as
// much as the bytes. What the designs do about it:
//   dW: each thread owns one output channel and one column tap kx, so its
//       4 * C accumulators (ky, c) stay in registers over all the row
//       segments its block visits; g's NHWC rows load coalesced along the
//       channels, the staged image values are read as warp broadcasts, and
//       the sums reach the zeroed output with one atomicAdd per block.
//   dx: one thread per image pixel and all C channels; the block stages the
//       6 x 18 g pixels under its 8 x 32 tile (odd stride per pixel, so the
//       lanes' different output pixels hit different banks) and the
//       weights, and gathers its at most 4 taps per output channel.
// The TPU kernels' 0/1 selection matmuls, row-stacked packing and 8-row
// alignment have no counterpart.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;
constexpr int kTO = 64;                 // output channels per block
constexpr int kTJ = 32;                 // output pixels of a row per block
constexpr int kXW = 2 * kTJ + 2;        // staged input columns

// Zero-padded image value at row r, column s of plane (n, c).
template <typename T>
__device__ __forceinline__ float pixel(const T* x, int n, int c, int C, int H, int W, int r,
                                       int s) {
  if (r < 0 || r >= H || s < 0 || s >= W) return 0.f;
  return to_f32<T>(x[((static_cast<size_t>(n) * C + c) * H + r) * W + s]);
}

// Stages the 4 input rows under output row i, columns 2*j0 - 1 .. 2*j0 + 64.
template <typename T, int C>
__device__ __forceinline__ void stage_rows(float (*s_x)[4][kXW], const T* x, int n, int H, int W,
                                           int i, int j0, int tid) {
  for (int idx = tid; idx < C * 4 * kXW; idx += kThreads) {
    const int c = idx / (4 * kXW);
    const int ky = (idx / kXW) % 4;
    const int s = idx % kXW;
    s_x[c][ky][s] = pixel(x, n, c, C, H, W, 2 * i + ky - 1, 2 * j0 + s - 1);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
stem_dw_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ dw,
               float* __restrict__ db, int N, int H, int W, int Co) {
  __shared__ float s_x[C][4][kXW];
  __shared__ float s_g[kTJ][kTO];
  const int H2 = H / 2;
  const int W2 = W / 2;
  const int jtiles = (W2 + kTJ - 1) / kTJ;
  const int ol = threadIdx.x % kTO;
  const int kx = threadIdx.x / kTO;  // this thread's column tap
  const int o0 = blockIdx.y * kTO;
  const int o = o0 + ol;
  float acc[C * 4];  // (c, ky)
#pragma unroll
  for (int k = 0; k < C * 4; ++k) acc[k] = 0.f;
  float dbacc = 0.f;
  const long long segs = static_cast<long long>(N) * H2 * jtiles;
  for (long long seg = blockIdx.x; seg < segs; seg += gridDim.x) {
    const int jt = static_cast<int>(seg % jtiles);
    const int i = static_cast<int>((seg / jtiles) % H2);
    const int n = static_cast<int>(seg / (static_cast<long long>(jtiles) * H2));
    const int j0 = jt * kTJ;
    stage_rows<T, C>(s_x, x, n, H, W, i, j0, threadIdx.x);
    for (int idx = threadIdx.x; idx < kTJ * kTO; idx += kThreads) {
      const int jj = idx / kTO;
      const int oc = idx % kTO;
      const bool ok = j0 + jj < W2 && o0 + oc < Co;
      s_g[jj][oc] = ok ? to_f32<T>(g[((static_cast<size_t>(n) * H2 + i) * W2 + j0 + jj) * Co + o0 + oc]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kTJ; ++jj) {
      const float gv = s_g[jj][ol];
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int ky = 0; ky < 4; ++ky) acc[c * 4 + ky] = fmaf(gv, s_x[c][ky][2 * jj + kx], acc[c * 4 + ky]);
      }
      if (kx == 0) dbacc += gv;
    }
    __syncthreads();
  }
  if (o < Co) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int ky = 0; ky < 4; ++ky) atomicAdd(dw + (static_cast<size_t>(o) * C + c) * 16 + ky * 4 + kx, acc[c * 4 + ky]);
    }
    if (kx == 0) atomicAdd(db + o, dbacc);
  }
}

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
int launch_all(int which, const void* a, const void* b, void* out, void* out2, int n, int h,
               int width, int co, cudaStream_t stream) {
  const int h2 = h / 2;
  const int w2 = width / 2;
  const int otiles = (co + kTO - 1) / kTO;
  if (which == 1) {  // dW: a = x, b = g, out = dw, out2 = db
    const long long segs = static_cast<long long>(n) * h2 * ((w2 + kTJ - 1) / kTJ);
    const int blocks = static_cast<int>(segs < 4 * 132 ? segs : 4 * 132);
    stem_dw_kernel<T, C><<<dim3(blocks, otiles), kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(out),
        static_cast<float*>(out2), n, h, width, co);
  } else {  // dx: a = g, b = w, out = dx
    const dim3 grid((width + kDxTW - 1) / kDxTW, (h + kDxTH - 1) / kDxTH, n);
    stem_dx_kernel<T, C><<<grid, dim3(kDxTW, kDxTH), 0, stream>>>(
        static_cast<const T*>(a), static_cast<const float*>(b), static_cast<T*>(out), h, width,
        co);
  }
  return itg::last_error();
}

template <typename T>
int dispatch(int which, int c, const void* a, const void* b, void* out, void* out2, int n,
             int h, int width, int co, cudaStream_t stream) {
  switch (c) {
    case 1: return launch_all<T, 1>(which, a, b, out, out2, n, h, width, co, stream);
    case 2: return launch_all<T, 2>(which, a, b, out, out2, n, h, width, co, stream);
    case 3: return launch_all<T, 3>(which, a, b, out, out2, n, h, width, co, stream);
    case 4: return launch_all<T, 4>(which, a, b, out, out2, n, h, width, co, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(int which, int bf16, int c, const void* a, const void* b, void* out, void* out2, int n,
        int h, int width, int co, void* stream) {
  if (h % 2 || width % 2) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(which, c, a, b, out, out2, n, h, width, co, st);
  return dispatch<float>(which, c, a, b, out, out2, n, h, width, co, st);
}

}  // namespace

// x (N, C, H, W), g (N, H/2, W/2, Co): activation type. dw (Co, C, 4, 4) and
// db (Co): float32, zeroed by the caller; the kernel adds into them.
extern "C" int itg_stem_dw(const void* x, const void* g, void* dw, void* db, int n, int c, int h,
                           int width, int co, int bf16, void* stream) {
  return run(1, bf16, c, x, g, dw, db, n, h, width, co, stream);
}

// g (N, H/2, W/2, Co) activation type, w (Co, C, 4, 4) float32 -> dx (N, C,
// H, W) activation type.
extern "C" int itg_stem_dx(const void* g, const void* w, void* dx, int n, int c, int h, int width,
                           int co, int bf16, void* stream) {
  return run(2, bf16, c, g, w, dx, nullptr, n, h, width, co, stream);
}
