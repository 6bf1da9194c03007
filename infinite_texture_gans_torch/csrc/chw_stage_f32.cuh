// The input tile of the float32 channels-major 3x3 forwards on the CUDA
// cores (conv3x3_fwd_f32.cu: K1/K2, 16 rows; upconv_fwd_f32.cu: K9/K14, 8
// half-res rows): TH + 2 staged rows of 32 columns and their ring cells a
// channel, the post-norm input with its border. The border is the input's
// own edge (replicate) or zeros, except where the caller passes `top` (N, C,
// W + 2: the padded row above, corners included) or `left` (N, C, H: the
// padded column to the left); those are post-norm and used as they are. The
// bottom row and right column are always the own edge (ops/kernels.py:
// _halo_padded). A staged row is 36 floats: image columns tx0 .. tx0 + 31
// at 4 .., its ring cells at 3 (column tx0 - 1) and 36 (tx0 + 32), so its 32
// interior columns arrive as eight 16-byte copies wherever the tile lies
// inside an aligned image, and 16 lanes reading a 16-byte window of each
// row hit distinct banks. The tile's copy units (where each comes from: x,
// the cached top row or left column, or zeros) are planned once a tile into
// shared memory, so a unit costs one 8-byte load and a copy a channel (a
// plan held in registers spilled). When its copies are in, a thread applies
// the BN fold, ReLU and rounding to the x cells it copied (__fmul_rn then
// __fadd_rn, no contraction: the halo cache holds exactly those bits), four
// at a time; bf16 values are converted and folded on the way in.
#pragma once

#include "common.cuh"
#include "mma.cuh"  // cp.async

namespace itg {

// The input of a tile and its cached border.
struct StageSrc32 {
  const void* x;     // (N, C, H, W)
  const void* top;   // (N, C, W + 2) or null
  const void* left;  // (N, C, H) or null
  const float* scale;
  const float* shift;
  int C, H, W, relu, zeros;
  int xvec;  // x rows may be copied 16 bytes at a time (float32, aligned, W % 4 == 0)
};

// The geometry of a tile of TH rows x 32 columns: a stage holds kCC
// channels of kXC floats each; staged row r of a channel starts at kXS r.
template <int TH>
struct TileGeom32 {
  static constexpr int kTW = 32;              // columns of a tile
  static constexpr int kXR = TH + 2;          // staged rows
  static constexpr int kXS = 36;              // floats a staged row: 16-byte aligned, 9 units apart
  static constexpr int kXC = 4 + kXR * kXS;   // floats a staged channel
  static constexpr int kUnits = 10;           // copy units a staged row: 8 vectors, 2 ring cells
  static constexpr int kPlan = kXR * kUnits;  // int2 entries of the copy plan
  static constexpr int kCC = 4;               // input channels a chunk
};

// The staging of one tile of image n at rows ty0 .., columns tx0 .., by
// `threads` threads; every member is inlined into the kernel.
template <typename T, int TH>
struct TileStage32 {
  using Geom = TileGeom32<TH>;
  static constexpr int kTW = Geom::kTW, kXS = Geom::kXS, kXC = Geom::kXC, kUnits = Geom::kUnits,
                       kPlan = Geom::kPlan, kCC = Geom::kCC;
  // how a copy unit is staged: 16 bytes, one cell, or cell by cell
  enum Mode : int { kVec = 1, kCell = 2, kSlow = 3 };

  // Where staged row r comes from: the cached top row, zeros, or x row `xr`.
  struct RowSrc {
    bool top, zero;
    int xr;
  };
  // The source of one ring or ragged cell of an x row: image column j (-1
  // <= j <= W, clamped), `fold` where it is an x value, `left` where it is
  // the cached left column, else zero when !ok.
  struct CellSrc {
    int off;  // into the channel's plane (x) or its left column
    bool ok, fold, left;
  };

  const StageSrc32 a;
  const T* xn;
  const T* topn;
  const T* leftn;
  size_t plane;
  int ty0, tx0, tid, threads;
  int2* plan;  // shared memory, kPlan entries

  __device__ __forceinline__ TileStage32(const StageSrc32& src, int n, int ty0_, int tx0_,
                                         int2* plan_, int threads_)
      : a(src), ty0(ty0_), tx0(tx0_), tid(threadIdx.x), threads(threads_), plan(plan_) {
    plane = static_cast<size_t>(a.H) * a.W;
    xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * a.C * plane;
    topn = a.top ? static_cast<const T*>(a.top) + static_cast<size_t>(n) * a.C * (a.W + 2) : xn;
    leftn = a.left ? static_cast<const T*>(a.left) + static_cast<size_t>(n) * a.C * a.H : xn;
  }

  __device__ __forceinline__ float fold1(float v, float sc, float sh) const {
    return prenorm<T>(v, sc, sh, a.relu);
  }

  __device__ __forceinline__ RowSrc row_src(int r) const {
    const int p = min(ty0 - 1 + r, a.H);
    const bool top = p < 0 && a.top;
    return {top, !top && a.zeros && (p < 0 || p >= a.H), min(max(p, 0), a.H - 1)};
  }

  __device__ __forceinline__ CellSrc cell_src(int xr, int j) const {
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

  // The tile's copy units, planned once into shared memory: unit t is
  // (staged row t / kUnits, unit t % kUnits); .x its source offset, .y its
  // destination in a channel | mode << 16 | kind << 18 (kind 0 zero, 1 x, 2
  // the cached top row, 3 the cached left column). The caller synchronises.
  __device__ __forceinline__ void make_plan() const {
    // interior units copy 16 bytes where the tile's 32 columns lie in the image
    const bool vec_tile = a.xvec && tx0 + kTW <= a.W;
    for (int t = tid; t < kPlan; t += threads) {
      const int r = t / kUnits, u = t % kUnits;
      const RowSrc rs = row_src(r);
      const int j0 = u < 8 ? tx0 + 4 * u : u == 8 ? tx0 - 1 : tx0 + kTW;
      int mode = kSlow, kind = 0, so = 0;
      if (u < 8) {  // four interior cells
        if (rs.zero) {
          mode = kVec;
        } else if (!rs.top && vec_tile) {
          mode = kVec, kind = 1, so = rs.xr * a.W + j0;
        }
      } else if (rs.top || rs.zero) {  // a ring cell of the cached top row or a zero row
        mode = kCell, kind = rs.top ? 2 : 0, so = rs.top ? min(j0, a.W) + 1 : 0;
      } else {  // a ring cell of an x row
        const CellSrc cs = cell_src(rs.xr, j0);
        mode = kCell, kind = !cs.ok ? 0 : cs.left ? 3 : 1, so = cs.off;
      }
      const int d = 4 + r * kXS + (u < 8 ? 4 * u : u == 8 ? -1 : kTW);
      plan[t] = make_int2(so, d | mode << 16 | kind << 18);
    }
  }

  // Input channels c0 .. c0 + kCC - 1 (zeros past C) into stage s, unit by
  // unit (float32 by cp.async, landing raw; bf16 converted and folded).
  __device__ __forceinline__ void copy(int c0, float* s) const {
    const int C = a.C, W = a.W;
    for (int t = tid; t < kPlan; t += threads) {
      const int2 pl = plan[t];
      const int d = pl.y & 0xffff, mode = (pl.y >> 16) & 3, kind = pl.y >> 18;
      if (mode == kSlow) {  // interior cells of a ragged or cached row, one by one
        const int r = t / kUnits, j0 = tx0 + 4 * (t % kUnits);
        const RowSrc rs = row_src(r);
#pragma unroll 1
        for (int cc = 0; cc < kCC; ++cc) {
          const int c = c0 + cc;
          const bool live = c < C;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            CellSrc cs{min(j0 + e, W) + 1, rs.top, false, false};
            if (!rs.top) cs = cell_src(rs.xr, j0 + e);
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
  }

  // The BN fold, ReLU and rounding on the x cells of the units this thread
  // copied into stage s (float32: the copies land raw).
  __device__ __forceinline__ void fold(int c0, float* s) const {
    const int nc = min(kCC, a.C - c0);
    float sc[kCC], sh[kCC];
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      sc[cc] = cc < nc ? __ldg(a.scale + c0 + cc) : 0.f;
      sh[cc] = cc < nc ? __ldg(a.shift + c0 + cc) : 0.f;
    }
    for (int t = tid; t < kPlan; t += threads) {
      const int2 pl = plan[t];
      const int d = pl.y & 0xffff, mode = (pl.y >> 16) & 3, kind = pl.y >> 18;
      if (mode == kSlow) {
        const RowSrc rs = row_src(t / kUnits);
        const int j0 = tx0 + 4 * (t % kUnits);
        if (rs.top) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const CellSrc cs = cell_src(rs.xr, j0 + e);
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
  }
};

}  // namespace itg
