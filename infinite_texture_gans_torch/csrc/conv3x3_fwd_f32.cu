// The generator tail's fused BN-fold -> ReLU -> border -> 3x3 convolution
// (K1, with K5's batch sums, and the raster step K2) on the CUDA cores: the
// float32 route (bf16 runs on the tensor cores in chw_fwd_tc.cu; this entry
// point takes bf16 too).
//
// Replaces two TPU kernels with one CUDA kernel:
//   K1 infinite_texture_gans_tpu/ops/pallas_conv.py:395 _conv3x3_chw_fwd
//      (kernel _conv_kernel :275), the one-pass form, with the batch sums
//      of conv3x3_chw_stats (:987) / conv3x3_chw_p (:1086) through the same
//      call (K5), and
//   K2 pallas_conv.py:539 _conv3x3_chw_fwd_halo (kernel _conv_halo_kernel
//      :421), the raster-engine form whose top row and left column come,
//      already post-norm, from the halo cache.
// y = conv3x3(border(act(scale * x + shift))) + b on channels-major (N, C,
// H, W) activations. The border is the input's own edge (replicate) or
// zeros, except where the caller passes `top` (N, C, W + 2: the padded row
// above, corners included) or `left` (N, C, H: the padded column to the
// left); those are post-norm and used as they are. The bottom row and right
// column are always the own edge. With stats, the float32 per-channel sums
// of the STORED y and y^2 (after rounding to the storage type).
//
// What bounds it on the H100: 2 * 9 * C * Co FLOPs per output pixel against
// 4 (C + Co) bytes in float32: at the Experiment-1 shapes (26 -> 26 at
// 192^2, 13 -> 13 and 13 -> 3 at 384^2, N = 8) FFMA issue bounds the wide
// convs (67 TFLOP/s outside the tensor cores) and bytes the Co = 3 one. The
// operands come from shared memory, whose load pipe serves one 4-byte word
// a lane a cycle (a 16-byte load takes four cycles even as a broadcast), so
// the design counts loaded words per FMA; and the staging of the input
// tile (copies, the fold, the border) is paid once for all the output
// channels of a block, so the fewer channels a block holds, the more it
// weighs. What it does:
// - Register tiles. A thread computes 16 consecutive output pixels of a row
//   x TO output channels (TO 7, or 3 at Co = 3). Per input channel and row
//   tap it loads its 18 input values once (a ring cell, four 16-byte loads,
//   a ring cell) and keeps them across the three column taps; per tap it
//   loads its TO weights (a broadcast: the warp shares them) and does 16 TO
//   FMAs. At TO = 7 that is 336 FMAs for 39 loaded words.
// - A warp (a group) owns a 16 x 32 output tile and TO channels; a block
//   holds G groups (up to 4) over the same tile, so at Co = 26, 13 and 3
//   every output channel is in one block and the input tile is staged and
//   folded once. The planner in ops/kernels.py (conv3x3_f32_plan) picks TO
//   and G from (N, C, Co, H, W): the wide eval layers at N = 1 take TO = 3,
//   for four times the warps.
// - Overlapped staging. Input channels come in chunks of kCC: the next
//   chunk's raw x (18 rows of 32 columns and the ring cells a channel) and
//   its weights land by cp.async in the other half of a double buffer
//   while this chunk's FMAs run; the 16 row lanes of a warp read their
//   windows as 16-byte loads from distinct banks. The tile's staging (its
//   copy plan, the border, the BN fold on the copied cells) is
//   chw_stage_f32.cuh's, which K9's float32 forward shares.
// - Each output sums (c, ky, kx) in one fixed order from zero and adds the
//   bias last, wherever its tile lies: the raster (K2) gives the one
//   pass's bits.
// - K5's sums: each group adds its stored y and y^2 in a fixed order (a
//   thread's pixels, then a shuffle tree over the warp) and writes them as
//   the tile's partial; a last launch adds the partials in one fixed order
//   (chw_fwd_tc.cuh: sum_partials). No atomics: two calls give the same
//   bits.
#include "chw_fwd_tc.cuh"    // sum_partials; common.cuh, cp.async groups
#include "chw_stage_f32.cuh"  // the input tile's staging

namespace {

using itg::cp_async4;
using itg::from_f32;
using itg::store_run;
using itg::to_f32;

constexpr int kR = 16;   // output pixels of a thread, along a row
constexpr int kTH = 16;  // output rows of a tile: 16 row lanes of a warp
using Geom = itg::TileGeom32<kTH>;  // 32 columns: 2 runs of kR
constexpr int kTW = Geom::kTW, kXS = Geom::kXS, kXC = Geom::kXC, kCC = Geom::kCC;

struct FwdArgs {
  const void* x;     // (N, C, H, W)
  const float* w;    // (Co, C, 3, 3)
  const float* b;    // (Co)
  const float* scale;
  const float* shift;
  const void* top;   // (N, C, W + 2) or null
  const void* left;  // (N, C, H) or null
  void* y;           // (N, Co, H, W)
  float* part;       // (N tiles, 2 Co) or null
  int N, C, H, W, Co, relu, zeros, tiles_w, xvec, yvec;
};

// Grid (tiles of an image, channel chunks, N), 32 G threads: group g (warp
// g) computes output channels co0 + TO g .. of the 16 x 32 tile; lane (ty,
// q) the 16 pixels 16 q .. of row ty. Dynamic shared memory: two stages of
// [x: kCC channels of kXC][w: kCC x 9 taps x G TO channels] floats; staged
// row r of a channel holds image columns tx0 .. tx0 + 31 at 4 + kXS r ..,
// its ring cells at 3 + kXS r (column tx0 - 1) and 36 + kXS r (tx0 + 32);
// then the tile's copy plan, Geom::kPlan int2.
template <typename T, int TO, int G>
__global__ void __launch_bounds__(32 * G, 12 / G) conv3x3_fwd_f32_kernel(const FwdArgs a) {
  constexpr int kThreads = 32 * G, OB = G * TO;
  constexpr int kStage = kCC * kXC + kCC * 9 * OB;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / a.tiles_w) * kTH, tx0 = (blockIdx.x % a.tiles_w) * kTW;
  const int co0 = blockIdx.y * OB;
  const int C = a.C, W = a.W;
  const size_t plane = static_cast<size_t>(a.H) * W;
  const itg::StageSrc32 in{a.x, a.top, a.left, a.scale, a.shift, C, a.H, W, a.relu, a.zeros,
                           a.xvec};
  const itg::TileStage32<T, kTH> tile(in, n, ty0, tx0,
                                      reinterpret_cast<int2*>(smem + 2 * kStage), kThreads);
  tile.make_plan();
  __syncthreads();

  // input channels c0 .. c0 + kCC - 1 (zeros past C) into stage s, then
  // their weights: s_w[(cc 9 + tap) OB + ob] = w[co0 + ob, c0 + cc, tap]
  auto stage = [&](int c0, float* s) {
    tile.copy(c0, s);
    float* s_w = s + kCC * kXC;
    for (int i = tid; i < kCC * 9 * OB; i += kThreads) {
      const int ob = i / (kCC * 9), k = i % (kCC * 9);
      const bool ok = c0 + k / 9 < C && co0 + ob < a.Co;
      const float* wk = ok ? a.w + (static_cast<size_t>(co0 + ob) * C + c0) * 9 + k : a.w;
      cp_async4(s_w + k * OB + ob, wk, ok);
    }
  };

  const int g = tid / 32, lane = tid % 32;
  const int ty = lane / 2, q = lane % 2;
  float acc[kR][TO];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
#pragma unroll
    for (int o = 0; o < TO; ++o) acc[i][o] = 0.f;
  }

  stage(0, smem);
  itg::cp_async_commit();
  const int chunks = (C + kCC - 1) / kCC;
  for (int k = 0; k < chunks; ++k) {
    float* cur = smem + (k & 1) * kStage;
    itg::cp_async_wait_all();
    if constexpr (sizeof(T) == 4) tile.fold(k * kCC, cur);
    __syncthreads();  // chunk k is in and folded; every thread is done with the other stage
    if (k + 1 < chunks) stage((k + 1) * kCC, smem + ((k + 1) & 1) * kStage);
    itg::cp_async_commit();
    const int nc = min(kCC, C - k * kCC);
    const float* xs = cur + 4 + ty * kXS + kR * q;
    const float* ws = cur + kCC * kXC + TO * g;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // the window: image columns 16 q - 1 .. 16 q + 16 of the row, as a
        // ring cell, four 16-byte loads and a ring cell
        const float* row = xs + cc * kXC + ky * kXS;
        float v[kR + 2];
        v[0] = row[-1];
#pragma unroll
        for (int e = 0; e < kR; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(row + e);
          v[e + 1] = f.x, v[e + 2] = f.y, v[e + 3] = f.z, v[e + 4] = f.w;
        }
        v[kR + 1] = row[kR];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wp = ws + (cc * 9 + ky * 3 + kx) * OB;
#pragma unroll
          for (int o = 0; o < TO; ++o) {
            const float wv = wp[o];
#pragma unroll
            for (int i = 0; i < kR; ++i) acc[i][o] = fmaf(v[i + kx], wv, acc[i][o]);
          }
        }
      }
    }
  }

  // -- y, and the tile's partial sums of the stored values
  const int oy = ty0 + ty, ox = tx0 + kR * q;
  const int valid = oy < a.H ? min(kR, W - ox) : 0;
  T* yp = static_cast<T*>(a.y) + (static_cast<size_t>(n) * a.Co * a.H + oy) * W + ox;
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    const int co = co0 + TO * g + o;
    float s1 = 0.f, s2 = 0.f;
    if (co < a.Co && valid > 0) {
      const float bias = __ldg(a.b + co);
      float st[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) st[i] = to_f32<T>(from_f32<T>(acc[i][o] + bias));
      store_run<T>(yp + static_cast<size_t>(co) * plane, st, valid, a.yvec);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        if (i < valid) {
          s1 = __fadd_rn(s1, st[i]);
          s2 = __fadd_rn(s2, __fmul_rn(st[i], st[i]));
        }
      }
    }
    if (a.part) {  // the same for every thread of the launch
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, d));
        s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, d));
      }
      if (lane == 0 && co < a.Co) {
        float* pr = a.part + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * 2 * a.Co;
        pr[co] = s1;
        pr[a.Co + co] = s2;
      }
    }
  }
}

template <typename T, int TO, int G>
int launch(const FwdArgs& a, float* s1, float* s2, cudaStream_t st) {
  constexpr int OB = G * TO;
  const int tiles_h = (a.H + kTH - 1) / kTH;
  const dim3 grid(tiles_h * a.tiles_w, (a.Co + OB - 1) / OB, a.N);
  const size_t smem = sizeof(float) * 2 * (kCC * kXC + kCC * 9 * OB) + sizeof(int2) * Geom::kPlan;
  const auto kernel = conv3x3_fwd_f32_kernel<T, TO, G>;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem))) {
      return static_cast<int>(e);
    }
  }
  kernel<<<grid, 32 * G, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  if (a.part) {
    itg::sum_partials<<<2 * a.Co, itg::kReduceThreads, 0, st>>>(a.part, s1, s2,
                                                                a.N * grid.x, a.Co);
  }
  return itg::last_error();
}

template <typename T, int TO>
int by_groups(int g, const FwdArgs& a, float* s1, float* s2, cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, TO, 1>(a, s1, s2, st);
    case 2: return launch<T, TO, 2>(a, s1, s2, st);
    case 4: return launch<T, TO, 4>(a, s1, s2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int to, int g, const FwdArgs& a, float* s1, float* s2, cudaStream_t st) {
  if (to == 7) return by_groups<T, 7>(g, a, s1, s2, st);
  if (to == 3) return by_groups<T, 3>(g, a, s1, s2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, top, left, y: activation type (float32, or bfloat16 when bf16 != 0).
// w (Co, C, 3, 3), b (Co), scale (C), shift (C): float32. top/left may be
// null. part (N ceil(H / 16) ceil(W / 32), 2 Co) float32 scratch and s1, s2
// (Co) float32, written with Σy and Σy² of the stored y, or all three null
// for no stats. to (7 or 3) output channels a thread and g (1, 2 or 4)
// groups a block: ops/kernels.py conv3x3_f32_plan (any pair gives the same
// bits). N <= 65535, H W < 2^31. One launch, two with stats; returns the
// first CUDA error (cudaErrorInvalidValue for a shape or plan it does not
// take).
extern "C" int itg_conv3x3_chw(const void* x, const void* w, const void* b,
                               const void* scale, const void* shift, const void* top,
                               const void* left, void* y, void* part, void* s1, void* s2, int n,
                               int c, int h, int width, int co, int relu, int zeros, int bf16,
                               int to, int g, void* stream) {
  if (n < 1 || n > 65535 || c < 1 || h < 1 || width < 1 || co < 1 ||
      static_cast<long long>(h) * width > 0x7fffffffLL ||
      (part == nullptr) != (s1 == nullptr) || (s1 == nullptr) != (s2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_px = bf16 ? 8 : 4;
  const bool x_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool y_aligned = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const FwdArgs a{x, static_cast<const float*>(w), static_cast<const float*>(b),
                  static_cast<const float*>(scale), static_cast<const float*>(shift), top, left,
                  y, static_cast<float*>(part), n, c, h, width, co, relu, zeros,
                  (width + kTW - 1) / kTW, !bf16 && x_aligned && width % 4 == 0,
                  y_aligned && width % vec_px == 0};
  auto* a1 = static_cast<float*>(s1);
  auto* a2 = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(to, g, a, a1, a2, st);
  return dispatch<float>(to, g, a, a1, a2, st);
}
