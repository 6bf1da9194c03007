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
//   while this chunk's FMAs run. A staged row is 36 floats: its 32 interior
//   columns arrive as eight 16-byte copies wherever the tile lies inside an
//   aligned image, and the 16 row lanes of a warp read their windows as
//   16-byte loads from distinct banks. The tile's copy units (where each
//   comes from: x, the cached top row or left column, or zeros, the
//   _halo_padded border of ops/kernels.py) are planned once a tile into
//   shared memory, so a unit costs one 8-byte load and a copy a channel.
//   When its copies are in, a thread applies the BN fold, ReLU and
//   rounding to the x cells it copied (__fmul_rn then __fadd_rn, no
//   contraction: the halo cache holds exactly those bits), four at a time.
// - Each output sums (c, ky, kx) in one fixed order from zero and adds the
//   bias last, wherever its tile lies: the raster (K2) gives the one
//   pass's bits.
// - K5's sums: each group adds its stored y and y^2 in a fixed order (a
//   thread's pixels, then a shuffle tree over the warp) and writes them as
//   the tile's partial; a last launch adds the partials in one fixed order
//   (chw_fwd_tc.cuh: sum_partials). No atomics: two calls give the same
//   bits.
#include "chw_fwd_tc.cuh"  // sum_partials; common.cuh, cp.async groups

namespace {

using itg::cp_async16z;
using itg::cp_async4;
using itg::from_f32;
using itg::store_run;
using itg::to_f32;

constexpr int kR = 16;             // output pixels of a thread, along a row
constexpr int kTH = 16;            // output rows of a tile: 16 row lanes of a warp
constexpr int kTW = 32;            // output columns of a tile: 2 runs of kR
constexpr int kXR = kTH + 2;       // staged rows
constexpr int kXS = 36;            // floats a staged row: 16-byte aligned, 9 units apart
constexpr int kXC = 4 + kXR * kXS; // floats a staged channel
constexpr int kUnits = 10;         // copy units a staged row: 8 interior vectors, 2 ring cells
constexpr int kCC = 4;             // input channels a chunk
// how a copy unit is staged: 16 bytes, one cell, or cell by cell
enum Mode : int { kVec = 1, kCell = 2, kSlow = 3 };

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

// Where staged row r of the tile at (ty0, tx0) comes from: the cached top
// row, zeros, or x row `xr` (the border of ops/kernels.py: _halo_padded).
struct RowSrc {
  bool top, zero;
  int xr;
};

__device__ __forceinline__ RowSrc row_src(const FwdArgs& a, int ty0, int r) {
  const int p = min(ty0 - 1 + r, a.H);
  const bool top = p < 0 && a.top;
  return {top, !top && a.zeros && (p < 0 || p >= a.H), min(max(p, 0), a.H - 1)};
}

// The source of one ring or ragged cell of an x row: image column j (-1 <=
// j <= W, clamped), `fold` where it is an x value, `left` where it is the
// cached left column, else zero when !ok.
struct CellSrc {
  int off;  // into the channel's plane (x) or its left column
  bool ok, fold, left;
};

__device__ __forceinline__ CellSrc cell_src(const FwdArgs& a, int xr, int j) {
  j = min(j, a.W);
  if (j < 0) {
    if (a.left) return {xr, true, false, true};
    if (a.zeros) return {0, false, false, false};
    return {xr * a.W, true, true, false};
  }
  if (j >= a.W) {
    if (a.zeros) return {0, false, false, false};
    return {xr * a.W + a.W - 1, true, true, false};
  }
  return {xr * a.W + j, true, true, false};
}

// Grid (tiles of an image, channel chunks, N), 32 G threads: group g (warp
// g) computes output channels co0 + TO g .. of the 16 x 32 tile; lane (ty,
// q) the 16 pixels 16 q .. of row ty. Dynamic shared memory: two stages of
// [x: kCC channels of kXC][w: kCC x 9 taps x G TO channels] floats; staged
// row r of a channel holds image columns tx0 .. tx0 + 31 at 4 + kXS r ..,
// its ring cells at 3 + kXS r (column tx0 - 1) and 36 + kXS r (tx0 + 32);
// then the tile's copy plan, kXR kUnits int2.
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
  const T* xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * C * plane;
  const T* topn = a.top ? static_cast<const T*>(a.top) + static_cast<size_t>(n) * C * (W + 2) : xn;
  const T* leftn = a.left ? static_cast<const T*>(a.left) + static_cast<size_t>(n) * C * a.H : xn;
  // interior units copy 16 bytes where the tile's 32 columns lie in the image
  const bool vec_tile = a.xvec && tx0 + kTW <= W;

  // the fold of one staged value
  auto fold1 = [&](float v, float sc, float sh) { return itg::prenorm<T>(v, sc, sh, a.relu); };

  // -- the tile's copy units, planned once into shared memory: unit t is
  // (staged row t / kUnits, unit t % kUnits); .x its source offset, .y its
  // destination in a channel | mode << 16 | kind << 18 (kind 0 zero, 1 x,
  // 2 the cached top row, 3 the cached left column)
  int2* s_plan = reinterpret_cast<int2*>(smem + 2 * kStage);
  for (int t = tid; t < kXR * kUnits; t += kThreads) {
    const int r = t / kUnits, u = t % kUnits;
    const RowSrc rs = row_src(a, ty0, r);
    const int j0 = u < 8 ? tx0 + 4 * u : u == 8 ? tx0 - 1 : tx0 + kTW;
    int mode = kSlow, kind = 0, so = 0;
    if (u < 8) {  // four interior cells
      if (rs.zero) {
        mode = kVec;
      } else if (!rs.top && vec_tile) {
        mode = kVec, kind = 1, so = rs.xr * W + j0;
      }
    } else if (rs.top || rs.zero) {  // a ring cell of the cached top row or a zero row
      mode = kCell, kind = rs.top ? 2 : 0, so = rs.top ? min(j0, W) + 1 : 0;
    } else {  // a ring cell of an x row
      const CellSrc cs = cell_src(a, rs.xr, j0);
      mode = kCell, kind = !cs.ok ? 0 : cs.left ? 3 : 1, so = cs.off;
    }
    const int d = 4 + r * kXS + (u < 8 ? 4 * u : u == 8 ? -1 : kTW);
    s_plan[t] = make_int2(so, d | mode << 16 | kind << 18);
  }
  __syncthreads();

  // input channels c0 .. c0 + kCC - 1 (zeros past C) into stage s, unit by
  // unit; bf16 values are folded on the way in
  auto stage = [&](int c0, float* s) {
    for (int t = tid; t < kXR * kUnits; t += kThreads) {
      const int2 pl = s_plan[t];
      const int d = pl.y & 0xffff, mode = (pl.y >> 16) & 3, kind = pl.y >> 18;
      if (mode == kSlow) {  // interior cells of a ragged or cached row, one by one
        const int r = t / kUnits, j0 = tx0 + 4 * (t % kUnits);
        const RowSrc rs = row_src(a, ty0, r);
#pragma unroll 1
        for (int cc = 0; cc < kCC; ++cc) {
          const int c = c0 + cc;
          const bool live = c < C;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            CellSrc cs{min(j0 + e, W) + 1, rs.top, false, false};
            if (!rs.top) cs = cell_src(a, rs.xr, j0 + e);
            const bool ok = live && cs.ok;
            const T* p = !ok ? xn
                       : rs.top ? topn + static_cast<size_t>(c) * (W + 2) + cs.off
                                : xn + c * plane + cs.off;
            float* dst = s + cc * kXC + d + e;
            if constexpr (sizeof(T) == 4) {
              cp_async4(dst, p, ok);
            } else {
              const float v = ok ? to_f32<T>(*p) : 0.f;
              *dst = ok && cs.fold ? fold1(v, a.scale[c], a.shift[c]) : v;
            }
          }
        }
        continue;
      }
      // the channel strides of the unit's source: x plane, top row, left column
      const size_t stride = kind == 1 ? plane : kind == 2 ? static_cast<size_t>(W + 2) : a.H;
      const T* base = kind == 1 ? xn : kind == 2 ? topn : leftn;
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        const int c = c0 + cc;
        const bool ok = c < C && kind != 0;
        const T* p = ok ? base + c * stride + pl.x : xn;
        float* dst = s + cc * kXC + d;
        if constexpr (sizeof(T) == 4) {
          if (mode == kVec) {
            cp_async16z(dst, p, ok);
          } else {
            cp_async4(dst, p, ok);
          }
        } else {
          for (int e = 0; e < (mode == kVec ? 4 : 1); ++e) {
            const float v = ok ? to_f32<T>(p[e]) : 0.f;
            dst[e] = ok && kind == 1 ? fold1(v, a.scale[c], a.shift[c]) : v;
          }
        }
      }
    }
    // weights: s_w[(cc 9 + tap) OB + ob] = w[co0 + ob, c0 + cc, tap]
    float* s_w = s + kCC * kXC;
    for (int i = tid; i < kCC * 9 * OB; i += kThreads) {
      const int ob = i / (kCC * 9), k = i % (kCC * 9);
      const bool ok = c0 + k / 9 < C && co0 + ob < a.Co;
      const float* src = ok ? a.w + (static_cast<size_t>(co0 + ob) * C + c0) * 9 + k : a.w;
      cp_async4(s_w + k * OB + ob, src, ok);
    }
  };

  // the BN fold, ReLU and rounding on the x cells of the units this thread
  // copied (float32: the copies land raw)
  auto fold = [&](int c0, float* s) {
    const int nc = min(kCC, C - c0);
    float sc[kCC], sh[kCC];
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      sc[cc] = cc < nc ? __ldg(a.scale + c0 + cc) : 0.f;
      sh[cc] = cc < nc ? __ldg(a.shift + c0 + cc) : 0.f;
    }
    for (int t = tid; t < kXR * kUnits; t += kThreads) {
      const int2 pl = s_plan[t];
      const int d = pl.y & 0xffff, mode = (pl.y >> 16) & 3, kind = pl.y >> 18;
      if (mode == kSlow) {
        const RowSrc rs = row_src(a, ty0, t / kUnits);
        const int j0 = tx0 + 4 * (t % kUnits);
        if (rs.top) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const CellSrc cs = cell_src(a, rs.xr, j0 + e);
          if (!(cs.ok && cs.fold)) continue;
#pragma unroll
          for (int cc = 0; cc < kCC; ++cc) {
            if (cc < nc) s[cc * kXC + d + e] = fold1(s[cc * kXC + d + e], sc[cc], sh[cc]);
          }
        }
        continue;
      }
      if (kind != 1) continue;
      if (mode == kVec) {
#pragma unroll
        for (int cc = 0; cc < kCC; ++cc) {
          if (cc >= nc) break;
          float4* q = reinterpret_cast<float4*>(s + cc * kXC + d);
          float4 v = *q;
          v.x = fold1(v.x, sc[cc], sh[cc]), v.y = fold1(v.y, sc[cc], sh[cc]);
          v.z = fold1(v.z, sc[cc], sh[cc]), v.w = fold1(v.w, sc[cc], sh[cc]);
          *q = v;
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < kCC; ++cc) {
          if (cc < nc) s[cc * kXC + d] = fold1(s[cc * kXC + d], sc[cc], sh[cc]);
        }
      }
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
    if constexpr (sizeof(T) == 4) fold(k * kCC, cur);
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
  const size_t smem = sizeof(float) * 2 * (kCC * kXC + kCC * 9 * OB) + sizeof(int2) * kXR * kUnits;
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
