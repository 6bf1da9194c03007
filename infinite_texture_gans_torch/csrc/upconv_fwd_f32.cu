// The subpixel-fused up-conv of the generator's tail (K9's forward, with its
// batch sums, and the raster step K14) on the CUDA cores: the float32 route
// (bf16 runs on the tensor cores in upconv_fwd_tc.cu; this entry point takes
// bf16 too).
//
// Replaces two TPU kernels with one CUDA kernel:
//   K9 infinite_texture_gans_tpu/ops/pallas_conv.py:1457 _upconv3x3_fwd
//      (kernel _upconv_kernel :1366), the one-pass form, with the float32
//      per-channel sums of the STORED y and y^2 (as K5), and
//   K14 pallas_conv.py:2019 _upconv3x3_fwd_halo (kernel
//      _upconv_halo_kernel :1879), the raster-engine form (--fuse_up all at
//      eval) whose half-res top row (C, W + 2, corners included) and left
//      column (C, H) come post-norm from the halo cache.
// y = conv3x3(pad1(up2(act(scale * x + shift)))) + b for x (N, C, H, W) at
// half resolution and y (N, Co, 2H, 2W). Nearest-2x commutes with the
// per-channel affine and the ReLU, and a replicate (or zeros) pad of the
// upsample equals one of the half-res post-norm slab A, so output phase
// (di, dj), y[2i + di, 2j + dj], is a 2 x 2 convolution of A at rows i - 1
// + di + r and columns j - 1 + dj + s (r, s in {0, 1}) with combined
// kernels (row taps K0 | K1 + K2 for di = 0, K0 + K1 | K2 for di = 1; the
// same on columns). A pack launch builds them from the 3 x 3 weights in the
// float32 order of ops/kernels.py: _upconv_phase_weights. The full-res halo
// row of the unfused raster site is the half-res one doubled, so K14's
// border is assembled on the half-res slab as K2's is (conv3x3_fwd_f32.cu).
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per half-res pixel
// against 4 (C + 4 Co) bytes in float32. At the Experiment-1 shapes (52 ->
// 26 at a 96^2 half resolution, 26 -> 13 at 192^2, N = 8) that is 6.4
// GFLOP a step against 0.1 GB, so FFMA issue bounds it (67 TFLOP/s outside
// the tensor cores: 0.048 ms a call), not the bytes (0.014 ms); at the
// flagship's eval shapes (104 -> 52 at 48^2 ... 26 -> 13 at 192^2, N = 1)
// the same per pixel, on a grid that fills the card only thinly. The
// operands come from shared memory, whose load pipe serves one 4-byte word
// a lane a cycle (a 16-byte load takes four cycles even as a broadcast), so
// the design counts loaded words per FMA. It is K1's design
// (conv3x3_fwd_f32.cu) at half resolution with four phases:
// - Register tiles. A thread computes 8 consecutive half-res pixels of a
//   row x TO output channels (2, or 1) x 4 phases: its 2 x 16 full-res
//   outputs a channel. Per input channel and staged row it loads its 10
//   window values once (a ring cell, two 16-byte loads, a ring cell); per
//   column shift it feeds the phase taps that read that shift, each tap's
//   TO weights (a broadcast: the warp shares them) used for 8 TO FMAs. At
//   TO = 2 that is 256 FMAs for 62 loaded words a channel. (4 channels a
//   thread load fewer words per FMA, but take 221 registers against 128,
//   half the warps an SM, and measured 11-12% slower at the Experiment-1
//   shapes: f32_route_study.py's plan table on an H100.)
// - A warp (a group) owns an 8 x 32 half-res tile and TO channels; a block
//   holds G groups (up to 4) over the same tile, which stage and normalise
//   it once. The planner in ops/kernels.py (upconv_f32_plan) picks TO and G
//   from (N, C, Co, H, W): the N = 1 eval layers at 48^2 and 96^2 take one
//   channel a thread, for at least four warps an SM.
// - Overlapped staging. Input channels come in chunks of kCC: the next
//   chunk's raw x (10 rows of 32 columns and the ring cells a channel) and
//   its packed weights land by cp.async in the other half of a double
//   buffer while this chunk's FMAs run; the eight lanes of a quarter warp
//   read their windows as 16-byte loads from distinct banks. The tile's
//   staging (its copy plan, the border with K14's cached row and column,
//   the BN fold on the copied cells) is K1's (chw_stage_f32.cuh).
// - Each output sums its (c, r, s) products in one fixed order from zero
//   (channel by channel, the four slots in order) and adds the bias last,
//   wherever its tile lies and whatever TO and G are: the raster (K14)
//   gives the one pass's bits.
// - The sums: each group adds its stored y and y^2 in a fixed order (a
//   thread's outputs, then a shuffle tree over the warp) and writes them as
//   the tile's partial; a last launch adds the partials in one fixed order
//   (chw_fwd_tc.cuh: sum_partials). No atomics: two calls give the same
//   bits.
#include "chw_fwd_tc.cuh"    // sum_partials; common.cuh, cp.async groups
#include "chw_stage_f32.cuh"  // the input tile's staging

namespace {

using itg::cp_async16z;
using itg::from_f32;
using itg::store_run;
using itg::to_f32;

constexpr int kR = 8;   // half-res pixels of a thread, along a row
constexpr int kTH = 8;  // half-res rows of a tile: 8 row lanes of a warp
using Geom = itg::TileGeom32<kTH>;  // 32 half-res columns: 4 runs of kR
constexpr int kTW = Geom::kTW, kXS = Geom::kXS, kXC = Geom::kXC, kCC = Geom::kCC;
constexpr int kMaxG = 4;  // groups (warps) a block
constexpr int kPackThreads = 256;

struct FwdArgs {
  const void* x;     // (N, C, H, W)
  const float* wp;   // (chunks, C, 16, G TO): the packed combined weights
  const float* b;    // (Co)
  const float* scale;
  const float* shift;
  const void* top;   // (N, C, W + 2) or null
  const void* left;  // (N, C, H) or null
  void* y;           // (N, Co, 2H, 2W)
  float* part;       // (N tiles, 2 Co) or null
  int N, C, H, W, Co, relu, zeros, tiles_w, xvec, yvec, G;
};

// The combined 2 x 2 kernels: slot (d, t) of an axis reads the 3 x 3 taps
// kFirst[slot] and, where kSecond[slot] >= 0, kSecond[slot] (K0 | K1 + K2 |
// K0 + K1 | K2).
__device__ __constant__ int kFirst[4] = {0, 1, 0, 2};
__device__ __constant__ int kSecond[4] = {-1, 2, 1, -1};

// wp[((cb C + c) 16 + tap) OB + ob] = the combined kernel of output channel
// cb OB + ob (zero past Co), input channel c, tap ((di 2 + dj) 2 + r) 2 + s:
// rows combined first, then columns, as _upconv_phase_weights adds them.
__global__ void __launch_bounds__(kPackThreads)
pack_weights(const float* __restrict__ w, float* __restrict__ wp, int C, int Co, int OB,
             long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (i >= total) return;
  const int ob = static_cast<int>(i % OB);
  const int tap = static_cast<int>((i / OB) % 16);
  const long long cc = i / (16LL * OB);  // cb C + c
  const int c = static_cast<int>(cc % C);
  const int o = static_cast<int>(cc / C) * OB + ob;
  float v = 0.f;
  if (o < Co) {
    const float* w9 = w + (static_cast<size_t>(o) * C + c) * 9;
    const int rs = (tap >> 2 & 2) | (tap >> 1 & 1);  // di 2 + r
    const int cs = (tap >> 1 & 2) | (tap & 1);       // dj 2 + s
    auto row = [&](int kx) {  // the row slot's taps at column kx
      const float a = w9[kFirst[rs] * 3 + kx];
      return kSecond[rs] < 0 ? a : __fadd_rn(a, w9[kSecond[rs] * 3 + kx]);
    };
    v = kSecond[cs] < 0 ? row(kFirst[cs]) : __fadd_rn(row(kFirst[cs]), row(kSecond[cs]));
  }
  wp[i] = v;
}

// Grid (tiles of an image, channel chunks, N), 32 G threads: group g (warp
// g) computes output channels co0 + TO g .. of the 8 x 32 half-res tile;
// lane (ty, q) the 8 pixels 8 q .. of row ty, all four phases. Dynamic
// shared memory: two stages of [x: kCC channels of kXC][w: kCC x 16 taps x
// G TO channels] floats; staged row r of a channel holds image columns tx0
// .. tx0 + 31 at 4 + kXS r .., its ring cells at 3 + kXS r (column tx0 - 1)
// and 36 + kXS r (tx0 + 32); then the tile's copy plan, Geom::kPlan int2.
template <typename T, int TO>
__global__ void __launch_bounds__(32 * kMaxG, 4) upconv_fwd_f32_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int G = a.G, OB = G * TO, threads = 32 * G;
  const int stage_floats = kCC * kXC + kCC * 16 * OB;
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / a.tiles_w) * kTH, tx0 = (blockIdx.x % a.tiles_w) * kTW;
  const int co0 = blockIdx.y * OB;
  const int C = a.C, W = a.W;
  const size_t plane = static_cast<size_t>(a.H) * W;
  const float* wpb = a.wp + static_cast<size_t>(blockIdx.y) * C * 16 * OB;
  const itg::StageSrc32 in{a.x, a.top, a.left, a.scale, a.shift, C, a.H, W, a.relu, a.zeros,
                           a.xvec};
  const itg::TileStage32<T, kTH> tile(in, n, ty0, tx0,
                                      reinterpret_cast<int2*>(smem + 2 * stage_floats), threads);
  tile.make_plan();
  __syncthreads();

  // input channels c0 .. c0 + kCC - 1 (zeros past C) into stage s, then
  // their nc x 16 x OB packed weights, 16 bytes a copy
  auto stage = [&](int c0, float* s) {
    tile.copy(c0, s);
    float* s_w = s + kCC * kXC;
    const float* wc = wpb + static_cast<size_t>(c0) * 16 * OB;
    const int nc = min(kCC, C - c0);
    for (int i = tid; i < nc * 4 * OB; i += threads) cp_async16z(s_w + 4 * i, wc + 4 * i, true);
  };

  const int g = tid / 32, lane = tid % 32;
  const int ty = lane / 4, q = lane % 4;
  float acc[4][kR][TO];  // [phase di 2 + dj][pixel][channel]
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int o = 0; o < TO; ++o) acc[p][i][o] = 0.f;
    }
  }

  stage(0, smem);
  itg::cp_async_commit();
  const int chunks = (C + kCC - 1) / kCC;
  for (int k = 0; k < chunks; ++k) {
    float* cur = smem + (k & 1) * stage_floats;
    itg::cp_async_wait_all();
    if constexpr (sizeof(T) == 4) tile.fold(k * kCC, cur);
    __syncthreads();  // chunk k is in and folded; every thread is done with the other stage
    if (k + 1 < chunks) stage((k + 1) * kCC, smem + ((k + 1) & 1) * stage_floats);
    itg::cp_async_commit();
    const int nc = min(kCC, C - k * kCC);
    const float* xs = cur + 4 + ty * kXS + kR * q;
    const float* ws = cur + kCC * kXC + TO * g;
#pragma unroll 1
    for (int cc = 0; cc < nc; ++cc) {
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        // staged row ty + u (image row ty0 + ty - 1 + u): columns 8 q - 1 ..
        // 8 q + 8 of the tile, as a ring cell, two 16-byte loads and a ring cell
        const float* row = xs + cc * kXC + u * kXS;
        float v[kR + 2];
        v[0] = row[-1];
#pragma unroll
        for (int e = 0; e < kR; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(row + e);
          v[e + 1] = f.x, v[e + 2] = f.y, v[e + 3] = f.z, v[e + 4] = f.w;
        }
        v[kR + 1] = row[kR];
#pragma unroll
        for (int e = 0; e < 3; ++e) {  // column shift: pixel i reads v[i + e]
#pragma unroll
          for (int di = 0; di < 2; ++di) {
            const int r = u - di;
            if (r < 0 || r > 1) continue;
#pragma unroll
            for (int dj = 0; dj < 2; ++dj) {
              const int s_ = e - dj;
              if (s_ < 0 || s_ > 1) continue;
              const int p = di * 2 + dj;
              const float* wq = ws + (cc * 16 + (p * 2 + r) * 2 + s_) * OB;
              float wv[TO];
              if constexpr (TO == 2) {
                const float2 f = *reinterpret_cast<const float2*>(wq);
                wv[0] = f.x, wv[1] = f.y;
              } else {
                wv[0] = wq[0];
              }
#pragma unroll
              for (int o = 0; o < TO; ++o) {
#pragma unroll
                for (int i = 0; i < kR; ++i) acc[p][i][o] = fmaf(v[i + e], wv[o], acc[p][i][o]);
              }
            }
          }
        }
      }
    }
  }

  // -- y (full-res rows 2 i and 2 i + 1, 16 columns a channel), and the
  // tile's partial sums of the stored values
  const int oi = ty0 + ty, oj = tx0 + kR * q;
  const int valid = oi < a.H && oj < W ? min(2 * kR, 2 * (W - oj)) : 0;
  const size_t plane2 = 4 * plane;
  T* yp = static_cast<T*>(a.y) + (static_cast<size_t>(n) * a.Co * 2 * a.H + 2 * oi) * 2 * W + 2 * oj;
#pragma unroll
  for (int o = 0; o < TO; ++o) {
    const int co = co0 + TO * g + o;
    float s1 = 0.f, s2 = 0.f;
    if (co < a.Co && valid > 0) {
      const float bias = __ldg(a.b + co);
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        float st[2 * kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            st[2 * i + dj] = to_f32<T>(from_f32<T>(__fadd_rn(acc[di * 2 + dj][i][o], bias)));
          }
        }
        store_run<T>(yp + co * plane2 + static_cast<size_t>(di) * 2 * W, st, valid, a.yvec);
#pragma unroll
        for (int i = 0; i < 2 * kR; ++i) {
          if (i < valid) {
            s1 = __fadd_rn(s1, st[i]);
            s2 = __fadd_rn(s2, __fmul_rn(st[i], st[i]));
          }
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

template <typename T, int TO>
int launch(const FwdArgs& a, const float* w, float* wp, float* s1, float* s2, int chunks,
           cudaStream_t st) {
  const int OB = a.G * TO;
  const long long total = static_cast<long long>(chunks) * a.C * 16 * OB;
  pack_weights<<<static_cast<unsigned>((total + kPackThreads - 1) / kPackThreads), kPackThreads, 0,
                 st>>>(w, wp, a.C, a.Co, OB, total);
  if (int rc = itg::last_error()) return rc;
  const int tiles_h = (a.H + kTH - 1) / kTH;
  const dim3 grid(tiles_h * a.tiles_w, chunks, a.N);
  const size_t smem = sizeof(float) * 2 * (kCC * kXC + kCC * 16 * OB) + sizeof(int2) * Geom::kPlan;
  upconv_fwd_f32_kernel<T, TO><<<grid, 32 * a.G, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  if (a.part) {
    itg::sum_partials<<<2 * a.Co, itg::kReduceThreads, 0, st>>>(a.part, s1, s2,
                                                                a.N * grid.x, a.Co);
  }
  return itg::last_error();
}

template <typename T>
int dispatch(int to, const FwdArgs& a, const float* w, float* wp, float* s1, float* s2, int chunks,
             cudaStream_t st) {
  if (to == 2) return launch<T, 2>(a, w, wp, s1, s2, chunks, st);
  if (to == 1) return launch<T, 1>(a, w, wp, s1, s2, chunks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (n, c, h, w) at half resolution, top, left, y (n, co, 2h, 2w):
// activation type (float32, or bfloat16 when bf16 != 0). w (co, c, 3, 3), b
// (co), scale (c), shift (c): float32. top (n, c, w + 2) / left (n, c, h)
// may be null. wp (chunks, c, 16, g to) float32 scratch for the packed
// combined weights, chunks = ceil(ceil(co / to) / g). part (n ceil(h / 8)
// ceil(w / 32), 2 co) float32 scratch and s1, s2 (co) float32, written with
// Σy and Σy² of the stored y, or all three null for no stats. to (2 or 1)
// output channels a thread and g (1 .. 4) groups a block: ops/kernels.py
// upconv_f32_plan (any pair gives the same bits). n <= 65535, h w < 2^31.
// Two launches, three with stats; returns the first CUDA error
// (cudaErrorInvalidValue for a shape or plan it does not take).
extern "C" int itg_upconv3x3_chw(const void* x, const void* w, const void* b, const void* scale,
                                 const void* shift, const void* top, const void* left, void* wp,
                                 void* y, void* part, void* s1, void* s2, int n, int c, int h,
                                 int width, int co, int relu, int zeros, int bf16, int to, int g,
                                 void* stream) {
  if (n < 1 || n > 65535 || c < 1 || h < 1 || width < 1 || co < 1 || g < 1 || g > kMaxG ||
      to < 1 || static_cast<long long>(h) * width > 0x7fffffffLL ||
      (part == nullptr) != (s1 == nullptr) || (s1 == nullptr) != (s2 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = ((co + to - 1) / to + g - 1) / g;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_px = bf16 ? 8 : 4;
  const bool x_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool y_aligned = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const FwdArgs a{x, static_cast<const float*>(wp), static_cast<const float*>(b),
                  static_cast<const float*>(scale), static_cast<const float*>(shift), top, left,
                  y, static_cast<float*>(part), n, c, h, width, co, relu, zeros,
                  (width + kTW - 1) / kTW, !bf16 && x_aligned && width % 4 == 0,
                  y_aligned && (2 * width) % vec_px == 0, g};
  const auto* wf = static_cast<const float*>(w);
  auto* wq = static_cast<float*>(wp);
  auto* a1 = static_cast<float*>(s1);
  auto* a2 = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(to, a, wf, wq, a1, a2, chunks, st);
  return dispatch<float>(to, a, wf, wq, a1, a2, chunks, st);
}
