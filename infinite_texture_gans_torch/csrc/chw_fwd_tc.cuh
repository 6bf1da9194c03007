// What the channels-major 3x3 forwards on the tensor cores share
// (chw_fwd_tc.cu: K1/K2; upconv_fwd_tc.cu: K9/K14 on the half-res slab):
// the post-norm padded input of a tile of TH rows x kTW columns, staged
// pixel-major in shared memory with its one-pixel border, bf16; and the
// last launch of the statistics, which adds the per-block partial sums in
// one fixed order.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace itg {

constexpr int kTW = 32;        // output columns per tile: a warp's two m16 tiles
constexpr int kCC = kTW + 2;   // staged columns
constexpr int kRSL = kCC + 1;  // pixel slots per staged row (odd: the 16-byte stores
                               // of eight consecutive rows hit distinct banks)

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float bf16_bits_to_f32(uint32_t b) { return __uint_as_float(b << 16); }

// The raw input of a tile and its cached border, bf16 bits.
struct StageSrc {
  const uint16_t* x;     // (N, C, H, W)
  const uint16_t* top;   // (N, C, W + 2) post-norm padded row -1, corners included, or null
  const uint16_t* left;  // (N, C, H) post-norm padded column -1, or null
  int C, H, W, relu, zeros;
};

// Stages the tile of image n at rows h0.., columns w0.. into s_a: (TH + 2)
// staged rows of kRSL pixel slots, each a row of OS bf16 (NC x 8 channels,
// zero past C). The post-norm value is act(scale * x + shift) with no FMA
// contraction (__fmul_rn, __fadd_rn, then ReLU) rounded to bf16, from the
// per-channel s_sc and s_sh (zero past C); the border is the own edge
// (replicate) or zeros, except the cached top row and left column where
// given, used as they are; the bottom row and right column are the own
// edge. xvec: x rows may be read 16 bytes at a time (W % 8 == 0 and x
// aligned). Called by all 32 TH threads of the block.
template <int TH>
__device__ __forceinline__ void stage_tile(const StageSrc& a, int n, int h0, int w0, int nc,
                                           int OS, bool xvec, const float* s_sc,
                                           const float* s_sh, uint16_t* s_a) {
  constexpr int kRows = TH + 2, nthreads = 32 * TH;
  const int tid = threadIdx.x;
  const int C = a.C, H = a.H, W = a.W;
  const size_t plane = static_cast<size_t>(H) * W;
  const uint16_t* xn = a.x + static_cast<size_t>(n) * C * plane;
  const int chunks = nc * kRows * (kTW / 8), halo = nc * kRows * 2;
  // -- A, staged row r, slot cc: padded pixel (p, q) = (h0 + r, w0 + cc), x
  // pixel (p - 1, q - 1). A unit is 8 channels of an interior chunk (slots
  // 1 + 8 k .. 8 + 8 k; consecutive threads on consecutive rows) and, for
  // the first `halo` units, of a halo column's pixel (slot 0 or kCC - 1);
  // all of a unit's loads go out before any is used. A padded row's source
  // is decided once: the cached top row, x row p - 1 (or the edge row it
  // replicates), or zero. A chunk takes eight 16-byte loads where it lies
  // inside an aligned x row, else a gather of its 64 values (the cached
  // top row, the replicate ring's column, ragged widths); then the fold,
  // ReLU and rounding in registers, a transpose to pixels by byte
  // permutes, eight 16-byte stores. Pixels past the padded image (ragged
  // tiles, read only by outputs never stored) are zero.
  for (int u = tid; u < chunks; u += nthreads) {
    // the halo pixel: the cached top row, the cached left column, x (or
    // the edge it replicates), or zero
    uint32_t hbits[8];
    int hdst = -1;
    bool hnorm = false;
    if (u < halo) {
      const int r = u % kRows, cc = (u / kRows) % 2 ? kCC - 1 : 0, og = u / (2 * kRows);
      const int p = h0 + r, q = w0 + cc;
      const uint16_t* src = nullptr;
      size_t cstride = 0;
      if (p <= H + 1 && q <= W + 1) {
        if (p == 0 && a.top) {
          src = a.top + static_cast<size_t>(n) * C * (W + 2) + q;
          cstride = W + 2;
        } else if (!(a.zeros && (p == 0 || p == H + 1))) {
          const int xr = min(max(p - 1, 0), H - 1);
          if (q == 0 && a.left) {
            src = a.left + static_cast<size_t>(n) * C * H + xr;
            cstride = H;
          } else if (!(a.zeros && (q == 0 || q == W + 1))) {
            src = xn + static_cast<size_t>(xr) * W + min(max(q - 1, 0), W - 1);
            cstride = plane;
            hnorm = true;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hbits[e] = src && 8 * og + e < C ? __ldg(src + (8 * og + e) * cstride) : 0u;
      }
      hdst = (r * kRSL + cc) * OS + 8 * og;
    }
    const int r = u % kRows, k = (u / kRows) % (kTW / 8), og = u / (kRows * (kTW / 8));
    const int p = h0 + r, j0 = w0 + 8 * k;
    const bool top_row = p == 0 && a.top;
    const bool x_row = !top_row && p <= H + 1 && !(a.zeros && (p == 0 || p == H + 1));
    uint4 in[8];  // channel e: the chunk's 8 pixels
#pragma unroll
    for (int e = 0; e < 8; ++e) in[e] = make_uint4(0u, 0u, 0u, 0u);
    uint32_t keep[4] = {~0u, ~0u, ~0u, ~0u};  // the pixels that hold a value
    const uint16_t* row = x_row ? xn + static_cast<size_t>(min(max(p - 1, 0), H - 1)) * W
                                : a.top + static_cast<size_t>(n) * C * (W + 2);
    if (x_row && xvec && j0 + 8 <= W) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * og + e;
        if (c < C) in[e] = __ldg(reinterpret_cast<const uint4*>(row + c * plane + j0));
      }
    } else if (x_row || top_row) {
      // the last padded column with a value: the replicate ring W + 1 (the
      // top row holds it too), W where the ring is zeros
      const int last = x_row && a.zeros ? W : W + 1;
      const size_t cstride = x_row ? plane : W + 2;
      uint32_t v[8][4];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * og + e;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t w = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = j0 + 1 + 2 * i + h;
            const int col = x_row ? min(q - 1, W - 1) : q;
            if (c < C && q <= last) w |= static_cast<uint32_t>(__ldg(row + c * cstride + col)) << (16 * h);
          }
          v[e][i] = w;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) in[e] = make_uint4(v[e][0], v[e][1], v[e][2], v[e][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        keep[i] = (j0 + 1 + 2 * i <= last ? 0xffffu : 0u) | (j0 + 2 + 2 * i <= last ? 0xffff0000u : 0u);
      }
    }
    if (x_row) {  // zero past C (scale and shift 0 there) and past the last column
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float sc = s_sc[8 * og + e], sh = s_sh[8 * og + e];
        uint32_t w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t w = word(in[e], i);
          float lo = __fadd_rn(__fmul_rn(bf16_bits_to_f32(w & 0xffffu), sc), sh);
          float hi = __fadd_rn(__fmul_rn(bf16_bits_to_f32(w >> 16), sc), sh);
          if (a.relu) lo = fmaxf(lo, 0.f), hi = fmaxf(hi, 0.f);
          w4[i] = itg::pack_bf16x2(lo, hi) & keep[i];
        }
        in[e] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
      }
    }
    uint16_t* dst = s_a + (r * kRSL + 1 + 8 * k) * OS + 8 * og;
#pragma unroll
    for (int px = 0; px < 8; ++px) {
      const uint32_t sel = (px & 1) ? 0x7632u : 0x5410u;
      *reinterpret_cast<uint4*>(dst + px * OS) =
          make_uint4(__byte_perm(word(in[0], px / 2), word(in[1], px / 2), sel),
                     __byte_perm(word(in[2], px / 2), word(in[3], px / 2), sel),
                     __byte_perm(word(in[4], px / 2), word(in[5], px / 2), sel),
                     __byte_perm(word(in[6], px / 2), word(in[7], px / 2), sel));
    }
    if (hdst >= 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * (u / (2 * kRows)) + e;
        if (hnorm) {
          float f = __fadd_rn(__fmul_rn(bf16_bits_to_f32(hbits[e]), s_sc[c]), s_sh[c]);
          if (a.relu) f = fmaxf(f, 0.f);
          hbits[e] = c < C ? __bfloat16_as_ushort(__float2bfloat16_rn(f)) : 0u;
        }
      }
      *reinterpret_cast<uint4*>(s_a + hdst) =
          make_uint4(hbits[0] | (hbits[1] << 16), hbits[2] | (hbits[3] << 16),
                     hbits[4] | (hbits[5] << 16), hbits[6] | (hbits[7] << 16));
    }
  }
}

// Σy[o] and Σy²[o] (entry e = blockIdx.x of 2 Co): the blocks' partials
// summed in one fixed order, thread t taking the blocks t, t + 256, ...,
// then a fixed tree over the threads.
constexpr int kReduceThreads = 256;

namespace {

__global__ void __launch_bounds__(kReduceThreads)
sum_partials(const float* __restrict__ part, float* __restrict__ s1, float* __restrict__ s2,
             int blocks, int Co) {
  __shared__ float s_w[kReduceThreads / 32];
  const int e = blockIdx.x, t = threadIdx.x;
  float v = 0.f;
  for (int b = t; b < blocks; b += kReduceThreads) {
    v = __fadd_rn(v, part[static_cast<size_t>(b) * 2 * Co + e]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((t & 31) == 0) s_w[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceThreads / 32; ++w) sum = __fadd_rn(sum, s_w[w]);
    if (e < Co) {
      s1[e] = sum;
    } else {
      s2[e - Co] = sum;
    }
  }
}

}  // namespace

}  // namespace itg
