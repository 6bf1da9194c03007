// The SSM embed chain on channels-major arrays, forward and backward, for
// float32 activations (bfloat16 takes ssm_embed_tc.cu): the per-pixel
// gamma|beta of StochasticSpatialModulation,
//   y = conv3x3_valid(ReLU(conv3x3_valid(maps, w1) + b1), w2) + b2,
// maps (N, md, H + 4, W + 4), w1 (hid, md, 3, 3), w2 (Co, hid, 3, 3), the
// biases and y (N, Co, H, W) float32 (Co = 2C gamma|beta channels, hid = 128
// in the models).
//
// Replaces the TPU kernels of infinite_texture_gans_tpu/ops/pallas_ssm.py:
//   K15 forward  ssm_embed_fwd_call (:343, kernel _ssm_fwd_kernel :189);
//   K15 backward ssm_embed_bwd_call (:392, kernel _ssm_bwd_kernel :210),
//   which returns dW2, db2, dW1 and db1 (the maps' cotangent is zero by
//   contract and is not computed).
// The port has no lane padding, so there is no edge fill of pad columns and
// no adjoint of one.
//
// What bounds it on the H100: stage 2 (hid -> Co over 9 taps) is 2 * 9 * hid
// * Co FLOPs per output pixel against 4 * (md + Co) bytes in float32, some
// 1000 FLOPs per byte at the models' shapes: operations bound it, here the
// CUDA cores' float32 rate (these kernels round nothing but the output: the
// exactness route of step parity). FMA issue and shared-memory traffic bound
// them above that. What the design does about it:
// - The 128-channel hidden activation never reaches device memory (as in
//   the TPU kernel): every kernel recomputes it per tile, with its halo, from
//   the maps (9 * md FMAs a value, a few per cent of stage 2's work) through
//   one function, `hidden_pre`, so the backward's ReLU mask has exactly the
//   forward's rounding.
// - Forward: a block computes a 32 x 16 output tile for up to 32 output
//   channels; each chunk of 8 hidden channels is computed into shared memory
//   (18 x 34 with its halo) beside the chunk's weights, and a thread keeps two
//   pixels x TCO channels in registers, so each shared-memory read feeds 8 to
//   16 FMAs. Each output sums its (hidden channel, tap) products in one fixed
//   order (chunk, channel, tap) and then adds the bias, whatever the tile,
//   the channel blocking or the canvas position: a raster sub-image and the
//   one pass give the same bits for the same maps.
// - Backward, two launches. (1) d_act = conv3x3^T(g) on the hidden grid
//   (H + 2) x (W + 2), the forward's scheme with the taps flipped and g staged
//   with a zero halo of 2; masked by hidden > 0 it is d_pre, which goes to
//   shared memory and is reduced against the staged maps tile into dW1 and
//   db1 (one warp per (channel, map channel, tap), lanes over pixels, then
//   one atomicAdd per block and entry). (2) dW2 = g x hidden summed over the
//   pixels: a block owns 32 output x 32 hidden channels (a lane per hidden
//   channel, four output channels per warp), walks its share of 4 x 32 pixel
//   tiles with a sliding 3 x 3 window, and adds its 9216 partial sums
//   atomically; db2 rides along. The atomics make the sums' order vary from
//   run to run.
// The Mosaic-specific parts of the TPU kernels (128-lane padding and its edge
// fill, row-stacked partial matmuls, 8-row chunk reads) have no counterpart
// here.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kTileW = 32;
constexpr int kThreadRows = 8;
constexpr int kRows = 2;  // output rows per thread: ty and ty + kThreadRows
constexpr int kTileH = kThreadRows * kRows;
constexpr int kThreads = kTileW * kThreadRows;
constexpr int kChunk = 8;  // source channels staged in shared memory per pass
constexpr int kSrcH = kTileH + 2;
constexpr int kSrcW = kTileW + 2;
constexpr int kSrc = kSrcH * kSrcW;
constexpr int kTC = 32;      // hidden channels per block in the backward
constexpr int kWRows = 4;    // output rows per dW2 tile
constexpr int kWSrc = (kWRows + 2) * (kTileW + 2);
constexpr int kWStride = kWSrc + 1;  // odd: the 32 lanes (channels) hit 32 banks

// The pre-activation hidden value at channel c, hidden row r and column j
// (0 <= r < H + 2, 0 <= j < W + 2) of one image's maps: the md x 9 products
// in one fixed order (map channel, then tap), then the bias. Every kernel of
// this file takes its hidden values from here.
template <typename T>
__device__ __forceinline__ float hidden_pre(const T* __restrict__ maps, const float* __restrict__ w1,
                                            const float* __restrict__ b1, int md, int Hm, int Wm,
                                            int c, int r, int j) {
  float acc = 0.f;
  for (int m = 0; m < md; ++m) {
    const T* p = maps + (static_cast<size_t>(m) * Hm + r) * Wm + j;
    const float* w = w1 + (static_cast<size_t>(c) * md + m) * 9;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) acc = fmaf(to_f32<T>(p[dy * Wm + dx]), w[dy * 3 + dx], acc);
    }
  }
  return __fadd_rn(acc, b1[c]);
}

// acc[q][k] += sum over the chunk's channels cc and taps of
// src[cc][ty + q * kThreadRows + tap / 3][tx + tap % 3] * w[cc][tap][k],
// in the order (cc, tap).
template <int NC>
__device__ __forceinline__ void accumulate_chunk(float (*src)[kSrcH][kSrcW],
                                                 float (*w)[9][NC], int tx, int ty,
                                                 float (&acc)[kRows][NC]) {
#pragma unroll
  for (int cc = 0; cc < kChunk; ++cc) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      float v[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) v[q] = src[cc][ty + q * kThreadRows + tap / 3][tx + tap % 3];
#pragma unroll
      for (int k = 0; k < NC; k += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&w[cc][tap][k]);
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          acc[q][k] = fmaf(v[q], wv.x, acc[q][k]);
          acc[q][k + 1] = fmaf(v[q], wv.y, acc[q][k + 1]);
          acc[q][k + 2] = fmaf(v[q], wv.z, acc[q][k + 2]);
          acc[q][k + 3] = fmaf(v[q], wv.w, acc[q][k + 3]);
        }
      }
    }
  }
}

// Forward. w2c is w2 as (hid, 9, Co). Grid (output tiles, Co / TCO, N).
template <typename T, int TCO>
__global__ void __launch_bounds__(kThreads)
ssm_fwd_kernel(const T* __restrict__ maps, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2c,
               const float* __restrict__ b2, T* __restrict__ y, int md, int hid, int H, int W,
               int Co) {
  __shared__ float s_src[kChunk][kSrcH][kSrcW];
  __shared__ __align__(16) float s_w[kChunk][9][TCO];

  const int n = blockIdx.z;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int Hm = H + 4, Wm = W + 4;
  const T* mp = maps + static_cast<size_t>(n) * md * Hm * Wm;

  float acc[kRows][TCO];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < TCO; ++k) acc[q][k] = 0.f;
  }

  for (int c0 = 0; c0 < hid; c0 += kChunk) {
    // output (oy, ox) reads hidden (oy + dy, ox + dx): rows ty0 .. ty0 + 17
    for (int i = tid; i < kChunk * kSrc; i += kThreads) {
      const int cc = i / kSrc;
      const int r = ty0 + (i % kSrc) / kSrcW;
      const int j = tx0 + (i % kSrc) % kSrcW;
      const int c = c0 + cc;
      s_src[cc][(i % kSrc) / kSrcW][(i % kSrc) % kSrcW] =
          (c < hid && r < H + 2 && j < W + 2)
              ? fmaxf(hidden_pre(mp, w1, b1, md, Hm, Wm, c, r, j), 0.f)
              : 0.f;
    }
    for (int i = tid; i < kChunk * 9 * TCO; i += kThreads) {
      const int cc = i / (9 * TCO);
      const int tap = (i / TCO) % 9;
      const int k = i % TCO;
      const int c = c0 + cc;
      const int co = co0 + k;
      s_w[cc][tap][k] = (c < hid && co < Co) ? w2c[(static_cast<size_t>(c) * 9 + tap) * Co + co] : 0.f;
    }
    __syncthreads();
    accumulate_chunk<TCO>(s_src, s_w, tx, ty, acc);
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int oy = ty0 + ty + q * kThreadRows;
    const int ox = tx0 + tx;
    if (oy >= H || ox >= W) continue;
#pragma unroll
    for (int k = 0; k < TCO; ++k) {
      const int co = co0 + k;
      if (co < Co) {
        y[((static_cast<size_t>(n) * Co + co) * H + oy) * W + ox] =
            from_f32<T>(__fadd_rn(acc[q][k], b2[co]));
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Backward (1): d_pre = (conv3x3^T(g) on the hidden grid) * (hidden > 0),
// reduced into dW1 (hid, md, 9) and db1 (hid). w2o is w2 as (Co, 9, hid).
// Grid (hidden-grid tiles, hid / kTC, N); dynamic shared memory of
// kTC * kTileH * kTileW + md * kSrc floats.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssm_bwd_act_kernel(const T* __restrict__ maps, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2o,
                   const T* __restrict__ g, float* __restrict__ dw1, float* __restrict__ db1,
                   int md, int hid, int H, int W, int Co) {
  extern __shared__ __align__(16) float smem[];
  auto s_g = reinterpret_cast<float (*)[kSrcH][kSrcW]>(smem);
  auto s_w = reinterpret_cast<float (*)[9][kTC]>(smem + kChunk * kSrc);
  // after the main loop the same memory holds d_pre
  auto s_dp = reinterpret_cast<float (*)[kTileH][kTileW]>(smem);
  auto s_m = reinterpret_cast<float (*)[kSrcH][kSrcW]>(smem + kTC * kTileH * kTileW);

  const int n = blockIdx.z;
  const int Hh = H + 2, Wh = W + 2, Hm = H + 4, Wm = W + 4;
  const int tiles_w = (Wh + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int c0 = blockIdx.y * kTC;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const T* mp = maps + static_cast<size_t>(n) * md * Hm * Wm;
  const T* gp = g + static_cast<size_t>(n) * Co * H * W;

  float acc[kRows][kTC];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int k = 0; k < kTC; ++k) acc[q][k] = 0.f;
  }

  // d_act[c, r, j] = sum over o, dy, dx of w2[o, c, dy, dx] * g[o, r - dy, j - dx]:
  // s_g[oo][i][jj] = g[o, ty0 - 2 + i, tx0 - 2 + jj] (zero outside g), so
  // tap' = (2 - dy) * 3 + (2 - dx) of the staged tile pairs with w2's tap 8 - tap'.
  for (int o0 = 0; o0 < Co; o0 += kChunk) {
    for (int i = tid; i < kChunk * kSrc; i += kThreads) {
      const int oo = i / kSrc;
      const int r = ty0 - 2 + (i % kSrc) / kSrcW;
      const int j = tx0 - 2 + (i % kSrc) % kSrcW;
      const int o = o0 + oo;
      s_g[oo][(i % kSrc) / kSrcW][(i % kSrc) % kSrcW] =
          (o < Co && r >= 0 && r < H && j >= 0 && j < W)
              ? to_f32<T>(gp[(static_cast<size_t>(o) * H + r) * W + j])
              : 0.f;
    }
    for (int i = tid; i < kChunk * 9 * kTC; i += kThreads) {
      const int oo = i / (9 * kTC);
      const int tap = (i / kTC) % 9;
      const int k = i % kTC;
      const int o = o0 + oo;
      const int c = c0 + k;
      s_w[oo][tap][k] = (o < Co && c < hid) ? w2o[(static_cast<size_t>(o) * 9 + 8 - tap) * hid + c] : 0.f;
    }
    __syncthreads();
    accumulate_chunk<kTC>(s_g, s_w, tx, ty, acc);
    __syncthreads();
  }

  // the ReLU mask, recomputed as the forward computed it
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int rl = ty + q * kThreadRows;
    const int r = ty0 + rl;
    const int j = tx0 + tx;
#pragma unroll
    for (int k = 0; k < kTC; ++k) {
      const int c = c0 + k;
      const bool live = c < hid && r < Hh && j < Wh && hidden_pre(mp, w1, b1, md, Hm, Wm, c, r, j) > 0.f;
      s_dp[k][rl][tx] = live ? acc[q][k] : 0.f;
    }
  }
  for (int i = tid; i < md * kSrc; i += kThreads) {
    const int m = i / kSrc;
    const int r = ty0 + (i % kSrc) / kSrcW;
    const int j = tx0 + (i % kSrc) % kSrcW;
    s_m[m][(i % kSrc) / kSrcW][(i % kSrc) % kSrcW] =
        (r < Hm && j < Wm) ? to_f32<T>(mp[(static_cast<size_t>(m) * Hm + r) * Wm + j]) : 0.f;
  }
  __syncthreads();

  // dW1[c, m, dy, dx] += sum over the tile of d_pre[c, r, j] * maps[m, r + dy, j + dx];
  // db1[c] += sum of d_pre[c]. One warp per entry, a lane per tile column.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = md * 9 + 1;
  for (int item = warp; item < kTC * per; item += kThreads / 32) {
    const int k = item / per;
    const int rem = item % per;
    float v = 0.f;
    if (rem < md * 9) {
      const int m = rem / 9;
      const int dy = (rem % 9) / 3;
      const int dx = rem % 3;
#pragma unroll 4
      for (int s = 0; s < kTileH; ++s) v = fmaf(s_dp[k][s][lane], s_m[m][s + dy][lane + dx], v);
    } else {
#pragma unroll 4
      for (int s = 0; s < kTileH; ++s) v += s_dp[k][s][lane];
    }
    v = warp_sum(v);
    const int c = c0 + k;
    if (lane == 0 && c < hid) {
      atomicAdd(rem < md * 9 ? dw1 + static_cast<size_t>(c) * md * 9 + rem : db1 + c, v);
    }
  }
}

// Backward (2): dW2[o, c, tap] = sum over pixels of g[o, p] * hidden[c, p + tap]
// and db2[o] = sum of g[o]. Grid (Co / 32, hid / 32, S): block z walks the
// pixel tiles z, z + S, ...; a lane owns a hidden channel, a warp four
// output channels.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_bwd_w2_kernel(const T* __restrict__ maps, const float* __restrict__ w1,
                  const float* __restrict__ b1, const T* __restrict__ g,
                  float* __restrict__ dw2, float* __restrict__ db2, int n_img, int md, int hid,
                  int H, int W, int Co) {
  __shared__ float s_h[kTC * kWStride];
  __shared__ float s_g[kTC][kWRows * kTileW];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int o0 = blockIdx.x * kTC;
  const int c0 = blockIdx.y * kTC;
  const int Hm = H + 4, Wm = W + 4;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kWRows - 1) / kWRows;
  const int n_tiles = n_img * tiles_h * tiles_w;

  float acc[4][9];
  float accb[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    accb[q] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[q][t] = 0.f;
  }

  for (int t = blockIdx.z; t < n_tiles; t += gridDim.z) {
    const int n = t / (tiles_h * tiles_w);
    const int ty0 = ((t / tiles_w) % tiles_h) * kWRows;
    const int tx0 = (t % tiles_w) * kTileW;
    const T* mp = maps + static_cast<size_t>(n) * md * Hm * Wm;
    const T* gp = g + static_cast<size_t>(n) * Co * H * W;
    for (int i = threadIdx.x; i < kTC * kWSrc; i += kThreads) {
      const int k = i / kWSrc;
      const int pos = i % kWSrc;
      const int r = ty0 + pos / (kTileW + 2);
      const int j = tx0 + pos % (kTileW + 2);
      const int c = c0 + k;
      s_h[k * kWStride + pos] = (c < hid && r < H + 2 && j < W + 2)
                                    ? fmaxf(hidden_pre(mp, w1, b1, md, Hm, Wm, c, r, j), 0.f)
                                    : 0.f;
    }
    for (int i = threadIdx.x; i < kTC * kWRows * kTileW; i += kThreads) {
      const int oo = i / (kWRows * kTileW);
      const int p = i % (kWRows * kTileW);
      const int r = ty0 + p / kTileW;
      const int j = tx0 + p % kTileW;
      const int o = o0 + oo;
      s_g[oo][p] = (o < Co && r < H && j < W) ? to_f32<T>(gp[(static_cast<size_t>(o) * H + r) * W + j]) : 0.f;
    }
    __syncthreads();

    const float* hrow = s_h + lane * kWStride;
    for (int i = 0; i < kWRows; ++i) {
      float win[3][3];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][0] = hrow[(i + dy) * (kTileW + 2)];
        win[dy][1] = hrow[(i + dy) * (kTileW + 2) + 1];
      }
#pragma unroll
      for (int x = 0; x < kTileW; ++x) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) win[dy][2] = hrow[(i + dy) * (kTileW + 2) + x + 2];
        float gv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gv[q] = s_g[warp * 4 + q][i * kTileW + x];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) acc[q][dy * 3 + dx] = fmaf(gv[q], win[dy][dx], acc[q][dy * 3 + dx]);
          }
        }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][0] = win[dy][1];
          win[dy][1] = win[dy][2];
        }
      }
    }
    if (blockIdx.y == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int s = 0; s < kWRows; ++s) accb[q] += s_g[warp * 4 + q][lane + 32 * s];
      }
    }
    __syncthreads();
  }

  const int c = c0 + lane;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = o0 + warp * 4 + q;
    if (o < Co && c < hid) {
#pragma unroll
      for (int t = 0; t < 9; ++t) atomicAdd(dw2 + (static_cast<size_t>(o) * hid + c) * 9 + t, acc[q][t]);
    }
    if (blockIdx.y == 0) {
      const float v = warp_sum(accb[q]);
      if (lane == 0 && o < Co) atomicAdd(db2 + o, v);
    }
  }
}

template <typename T, int TCO>
int launch_fwd(const void* maps, const float* w1, const float* b1, const float* w2c,
               const float* b2, void* y, int n, int md, int hid, int h, int w, int co,
               cudaStream_t stream) {
  const int tiles = ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(tiles, (co + TCO - 1) / TCO, n);
  ssm_fwd_kernel<T, TCO><<<grid, dim3(kTileW, kThreadRows), 0, stream>>>(
      static_cast<const T*>(maps), w1, b1, w2c, b2, static_cast<T*>(y), md, hid, h, w, co);
  return itg::last_error();
}

// The output-channel block: the widest that pads Co by at most 15% (wider
// blocks reuse each staged hidden value more and recompute the hidden
// activation for fewer blocks), else the one that pads least.
int pick_tco(int co) {
  const int cand[] = {32, 28, 24, 16, 8};
  for (int t : cand) {
    if ((co + t - 1) / t * t * 100 <= co * 115) return t;
  }
  int best = 8, best_cost = 1 << 30;
  for (int t : cand) {
    const int cost = (co + t - 1) / t * t;
    if (cost < best_cost) {
      best = t;
      best_cost = cost;
    }
  }
  return best;
}

template <typename T>
int dispatch_fwd(const void* maps, const float* w1, const float* b1, const float* w2c,
                 const float* b2, void* y, int n, int md, int hid, int h, int w, int co,
                 cudaStream_t s) {
  switch (pick_tco(co)) {
    case 32: return launch_fwd<T, 32>(maps, w1, b1, w2c, b2, y, n, md, hid, h, w, co, s);
    case 28: return launch_fwd<T, 28>(maps, w1, b1, w2c, b2, y, n, md, hid, h, w, co, s);
    case 24: return launch_fwd<T, 24>(maps, w1, b1, w2c, b2, y, n, md, hid, h, w, co, s);
    case 16: return launch_fwd<T, 16>(maps, w1, b1, w2c, b2, y, n, md, hid, h, w, co, s);
    default: return launch_fwd<T, 8>(maps, w1, b1, w2c, b2, y, n, md, hid, h, w, co, s);
  }
}

template <typename T>
int dispatch_bwd(const void* maps, const float* w1, const float* b1, const float* w2o,
                 const void* g, float* dw2, float* db2, float* dw1, float* db1, int n, int md,
                 int hid, int h, int w, int co, cudaStream_t stream) {
  const auto* m = static_cast<const T*>(maps);
  const auto* gt = static_cast<const T*>(g);
  // (1) d_pre -> dW1, db1. Its shared memory (64 KB of d_pre and md staged
  // map tiles) always exceeds the 48 KB default, and the limit is a per-device
  // attribute: raise it before every launch. It fails, and so does the call,
  // when md map tiles do not fit in the card's shared memory.
  const size_t smem = (kTC * kTileH * kTileW + md * kSrc) * sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      ssm_bwd_act_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = ((w + 2 + kTileW - 1) / kTileW) * ((h + 2 + kTileH - 1) / kTileH);
  const dim3 grid1(tiles, (hid + kTC - 1) / kTC, n);
  ssm_bwd_act_kernel<T><<<grid1, dim3(kTileW, kThreadRows), smem, stream>>>(
      m, w1, b1, w2o, gt, dw1, db1, md, hid, h, w, co);
  const int rc = itg::last_error();
  if (rc) return rc;
  // (2) dW2, db2: about three blocks per SM, each over a share of the tiles
  const int gx = (co + kTC - 1) / kTC;
  const int gy = (hid + kTC - 1) / kTC;
  const int n_tiles = n * ((h + kWRows - 1) / kWRows) * ((w + kTileW - 1) / kTileW);
  const int want = (3 * itg::sm_count() + gx * gy - 1) / (gx * gy);
  const int split = want < n_tiles ? want : n_tiles;
  ssm_bwd_w2_kernel<T><<<dim3(gx, gy, split), kThreads, 0, stream>>>(
      m, w1, b1, gt, dw2, db2, n, md, hid, h, w, co);
  return itg::last_error();
}

}  // namespace

// maps (N, md, h + 4, w + 4), y (N, co, h, w), w1 (hid, md, 3, 3), b1 (hid),
// w2c (hid, 3, 3, co) = w2 permuted, b2 (co): float32. Returns
// cudaGetLastError() after the launch.
extern "C" int itg_ssm_embed_fwd(const void* maps, const void* w1, const void* b1,
                                 const void* w2c, const void* b2, void* y, int n, int md,
                                 int hid, int h, int w, int co, void* stream) {
  return dispatch_fwd<float>(maps, static_cast<const float*>(w1), static_cast<const float*>(b1),
                             static_cast<const float*>(w2c), static_cast<const float*>(b2), y, n,
                             md, hid, h, w, co, static_cast<cudaStream_t>(stream));
}

// maps as the forward's, g (N, co, h, w) float32; w1, b1 float32, w2o (co,
// 3, 3, hid) = w2 permuted. dw2 (co, hid, 3, 3), db2 (co), dw1 (hid, md, 3,
// 3), db1 (hid): float32, zeroed by the caller. md is bounded by the shared
// memory of the first launch (64 KB + 2448 B a map channel). Two launches;
// returns the first CUDA error.
extern "C" int itg_ssm_embed_bwd(const void* maps, const void* w1, const void* b1,
                                 const void* w2o, const void* g, void* dw2, void* db2, void* dw1,
                                 void* db1, int n, int md, int hid, int h, int w, int co,
                                 void* stream) {
  return dispatch_bwd<float>(maps, static_cast<const float*>(w1), static_cast<const float*>(b1),
                             static_cast<const float*>(w2o), g, static_cast<float*>(dw2),
                             static_cast<float*>(db2), static_cast<float*>(dw1),
                             static_cast<float*>(db1), n, md, hid, h, w, co,
                             static_cast<cudaStream_t>(stream));
}
