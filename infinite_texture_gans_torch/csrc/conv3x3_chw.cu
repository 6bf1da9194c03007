// Fused BN-fold -> ReLU -> border assembly -> 3x3 convolution on
// channels-major (N, C, H, W) activations: the generator tail's conv.
//
// Replaces two TPU kernels with one CUDA kernel:
//   K1 infinite_texture_gans_tpu/ops/pallas_conv.py:_conv3x3_chw_fwd (:395,
//      kernel _conv_kernel :275), the one-pass form, and
//   K2 infinite_texture_gans_tpu/ops/pallas_conv.py:_conv3x3_chw_fwd_halo
//      (:539, kernel _conv_halo_kernel :421), the raster-engine form whose
//      top row and left column come, already post-norm, from the halo cache.
// y = conv3x3(border(act(scale * x + shift))) + b. The border is the input's
// own edge (replicate) or zeros, except where the caller passes `top`
// (N, C, W + 2: the padded row above, corners included) or `left` (N, C, H:
// the padded column to the left); those are post-norm and used as they are.
// The bottom row and right column are always the own edge.
// With `s1`/`s2` (K5, the training forward of conv3x3_chw_stats and
// conv3x3_chw_p, pallas_conv.py:987/:1086 through the same :395 call) the
// kernel also adds the float32 per-channel sums of the STORED y and y^2
// (after rounding to the storage type) into s1/s2, which the wrapper zeroes:
// a warp-shuffle and shared-memory reduction per block, then one atomicAdd
// per block and channel, so the sums' order varies from run to run.
//
// What bounds it on the H100: at the flagship shapes (C -> Co of 104 -> 52
// at 96^2 down to 13 -> 3 at 384^2) the work is 2 * 9 * C * Co FLOPs per
// output pixel against 2 * (C + Co) bytes in bf16, so the dense bound is
// operations on the tensor cores. This first kernel does not use them: it is
// a direct convolution on the CUDA cores in float32, so it is bound by FMA
// issue and by shared-memory traffic, well above the tensor-core bound.
// What the design does about it: a block computes a 32 x 8 output tile for
// up to 16 output channels; each input channel chunk is loaded once into
// shared memory with the BN fold, ReLU and the border applied on the way in
// (the normed activation never reaches device memory, as in the TPU kernel),
// the chunk's weights sit beside it in shared memory and are read as float4
// broadcasts, and every thread keeps its output channels in registers, so
// each staged input value feeds 9 * TCO FMAs. The Mosaic-specific parts of
// the TPU kernel (128-lane padding, row-stacked partial matmuls, 8-row
// chunk specs) have no counterpart here. wgmma/TMA tiles are later work.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::round_to;
using itg::to_f32;

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kChunk = 8;  // input channels staged in shared memory per pass
constexpr int kThreads = kTileW * kTileH;
constexpr int kTile = (kTileH + 2) * (kTileW + 2);

template <typename T>
struct Source {
  const T* x;     // (C, H, W) of one image
  const T* top;   // (C, W + 2) post-norm row above, or nullptr
  const T* left;  // (C, H) post-norm column to the left, or nullptr
  const float* scale;
  const float* shift;
  int C, H, W, relu, zeros;
};

// act(scale * x + shift) rounded to the storage type, so that a value
// normed here equals the one the halo cache holds for the same pixel.
template <typename T>
__device__ __forceinline__ float prenorm(const Source<T>& s, int c, int r, int j) {
  const float v = to_f32<T>(s.x[(static_cast<size_t>(c) * s.H + r) * s.W + j]);
  float a = __fadd_rn(__fmul_rn(v, s.scale[c]), s.shift[c]);
  if (s.relu) a = fmaxf(a, 0.f);
  return round_to<T>(a);
}

// Post-norm value of the padded input at row r in [-1, H], column j in
// [-1, W]; rows and columns past those (ragged tiles) are clamped, and only
// feed outputs that are never stored.
template <typename T>
__device__ __forceinline__ float padded(const Source<T>& s, int c, int r, int j) {
  r = min(r, s.H);
  j = min(j, s.W);
  if (r < 0 && s.top) return to_f32<T>(s.top[static_cast<size_t>(c) * (s.W + 2) + j + 1]);
  if (s.zeros) {
    if (r < 0 || r >= s.H || j >= s.W) return 0.f;
    if (j < 0) return s.left ? to_f32<T>(s.left[static_cast<size_t>(c) * s.H + r]) : 0.f;
    return prenorm(s, c, r, j);
  }
  const int rr = min(max(r, 0), s.H - 1);
  if (j < 0) {
    return s.left ? to_f32<T>(s.left[static_cast<size_t>(c) * s.H + rr]) : prenorm(s, c, rr, 0);
  }
  return prenorm(s, c, rr, min(j, s.W - 1));
}

template <typename T, int TCO>
__global__ void __launch_bounds__(kThreads)
conv3x3_chw_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, const float* __restrict__ scale,
                   const float* __restrict__ shift, const T* __restrict__ top,
                   const T* __restrict__ left, T* __restrict__ y, float* __restrict__ s1,
                   float* __restrict__ s2, int C, int H, int W, int Co, int relu, int zeros) {
  __shared__ float s_in[kChunk][kTileH + 2][kTileW + 2];
  __shared__ __align__(16) float s_w[kChunk][9][TCO];
  __shared__ float s_red[kThreads / 32][2 * TCO];

  const int n = blockIdx.z;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;

  const Source<T> s{x + static_cast<size_t>(n) * C * H * W,
                    top ? top + static_cast<size_t>(n) * C * (W + 2) : nullptr,
                    left ? left + static_cast<size_t>(n) * C * H : nullptr,
                    scale, shift, C, H, W, relu, zeros};

  float acc[TCO];
#pragma unroll
  for (int k = 0; k < TCO; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    for (int i = tid; i < kChunk * kTile; i += kThreads) {
      const int cc = i / kTile;
      const int r = (i % kTile) / (kTileW + 2);
      const int j = (i % kTile) % (kTileW + 2);
      const int c = c0 + cc;
      s_in[cc][r][j] = c < C ? padded(s, c, ty0 + r - 1, tx0 + j - 1) : 0.f;
    }
    for (int i = tid; i < kChunk * 9 * TCO; i += kThreads) {
      const int cc = i / (9 * TCO);
      const int tap = (i / TCO) % 9;
      const int k = i % TCO;
      const int c = c0 + cc;
      const int co = co0 + k;
      s_w[cc][tap][k] = (c < C && co < Co) ? w[(static_cast<size_t>(co) * C + c) * 9 + tap] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kChunk; ++cc) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = s_in[cc][ty + tap / 3][tx + tap % 3];
#pragma unroll
        for (int k = 0; k < TCO; k += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(&s_w[cc][tap][k]);
          acc[k] = fmaf(v, wv.x, acc[k]);
          acc[k + 1] = fmaf(v, wv.y, acc[k + 1]);
          acc[k + 2] = fmaf(v, wv.z, acc[k + 2]);
          acc[k + 3] = fmaf(v, wv.w, acc[k + 3]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty0 + ty;
  const int ox = tx0 + tx;
  const bool inside = oy < H && ox < W;
#pragma unroll
  for (int k = 0; k < TCO; ++k) {
    const int co = co0 + k;
    float stored = 0.f;
    if (inside && co < Co) {
      const T out = from_f32<T>(acc[k] + bias[co]);
      y[((static_cast<size_t>(n) * Co + co) * H + oy) * W + ox] = out;
      stored = to_f32<T>(out);
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
int launch(const void* x, const float* w, const float* b, const float* scale,
           const float* shift, const void* top, const void* left, void* y, float* s1,
           float* s2, int n, int c, int h, int width, int co, int relu, int zeros,
           cudaStream_t stream) {
  const int tiles = ((width + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(tiles, (co + TCO - 1) / TCO, n);
  const dim3 block(kTileW, kTileH);
  conv3x3_chw_kernel<T, TCO><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), w, b, scale, shift, static_cast<const T*>(top),
      static_cast<const T*>(left), static_cast<T*>(y), s1, s2, c, h, width, co, relu, zeros);
  return itg::last_error();
}

template <typename T>
int dispatch(const void* x, const float* w, const float* b, const float* scale,
             const float* shift, const void* top, const void* left, void* y, float* s1,
             float* s2, int n, int c, int h, int width, int co, int relu, int zeros,
             cudaStream_t stream) {
  if (co <= 4) return launch<T, 4>(x, w, b, scale, shift, top, left, y, s1, s2, n, c, h, width, co, relu, zeros, stream);
  if (co <= 8) return launch<T, 8>(x, w, b, scale, shift, top, left, y, s1, s2, n, c, h, width, co, relu, zeros, stream);
  return launch<T, 16>(x, w, b, scale, shift, top, left, y, s1, s2, n, c, h, width, co, relu, zeros, stream);
}

}  // namespace

// x, top, left, y: activation type (float32, or bfloat16 when bf16 != 0).
// w (Co, C, 3, 3), b (Co), scale (C), shift (C): float32. top/left may be
// null. s1/s2 (Co) float32, zeroed by the caller, or null for no stats.
// Returns cudaGetLastError() after the launch.
extern "C" int itg_conv3x3_chw(const void* x, const void* w, const void* b,
                               const void* scale, const void* shift, const void* top,
                               const void* left, void* y, void* s1, void* s2, int n, int c,
                               int h, int width, int co, int relu, int zeros, int bf16,
                               void* stream) {
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* a = static_cast<float*>(s1);
  auto* q = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch<__nv_bfloat16>(x, wf, bf, sc, sh, top, left, y, a, q, n, c, h, width, co, relu, zeros, st);
  }
  return dispatch<float>(x, wf, bf, sc, sh, top, left, y, a, q, n, c, h, width, co, relu, zeros, st);
}
