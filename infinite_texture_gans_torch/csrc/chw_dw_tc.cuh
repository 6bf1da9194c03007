// What the channels-major weight gradients on the tensor cores share
// (chw_dw_tc.cu: K7; upconv_dw_tc.cu: K9 dW on the half-res slab): the
// post-norm padded input A of a tile of TH rows x kTW columns, landed raw as
// one TMA box (or by element loads) and staged pixel-major in shared memory
// with its ring; the rule that picks a block's stages from its shared
// memory.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "mma.cuh"

namespace itg::dw {

using bf16 = __nv_bfloat16;

constexpr int kTW = 32;       // output columns per tile: two k16 steps per row
constexpr int kAC = kTW + 2;  // staged columns
constexpr int kAP = kAC + 1;  // pixel slots per staged row (odd)
// a raw x row in shared memory: x columns w0 - 8 .. w0 + kTW + 7 (a TMA box
// starts on a 16-byte boundary), of which the tile reads w0 - 1 .. w0 + kTW;
// raw column j is pixel slot j - 7
constexpr int kRW = kTW + 16;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// the shared memory of an H100 SM; 1 KB of it per block is reserved
constexpr size_t kSmemPerSM = 233472;
constexpr int kMaxStages = 6;

// A block's shared memory with `stages` stages of copies in flight and `a`
// bytes outside them, and the blocks an SM holds of it.
constexpr size_t smem_for(int stages, size_t stage, size_t a, size_t red, size_t fixed) {
  const size_t s = stages * stage + a;
  return (s > red ? s : red) + fixed;
}

constexpr int blocks_for(int stages, size_t stage, size_t a, size_t red, size_t fixed) {
  return static_cast<int>(kSmemPerSM / (smem_for(stages, stage, a, red, fixed) + 1024));
}

// The stage count: two blocks an SM (128 registers a thread) where the
// shared memory holds them, else one; then as many stages (2 to 6) as fit.
// A second block overlaps one block's staging with the other's products,
// which more stages of one block do not: on an H100 two blocks of 2 stages
// ran faster than one of 5 at every shape of K7 where both fit.
constexpr int pick_stages(size_t stage, size_t a, size_t red, size_t fixed) {
  int best = 2, best_blocks = 0;
  for (int s = 2; s <= kMaxStages; ++s) {
    int b = blocks_for(s, stage, a, red, fixed);
    b = b > 2 ? 2 : b;
    if (b >= best_blocks && b > 0) best = s, best_blocks = b;
  }
  return best;
}

struct DwArgs {
  const bf16* x;       // (N, C, H, W): the conv's (for K9 dW the half-res) input
  const bf16* g;       // (N, Co, H, W) (for K9 dW (N, Co, 2H, 2W))
  const float* scale;  // (C)
  const float* shift;  // (C)
  float* part;         // per-block partials: dW fragments | db
  int N, C, H, W, Co, relu, zeros;
  int tma;             // x's raw tiles by TMA (else element loads)
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// act(scale * v + shift) before the rounding to bf16 (the packing rounds).
__device__ __forceinline__ float pre(float v, float sc, float sh, int relu) {
  const float a = __fadd_rn(__fmul_rn(v, sc), sh);
  return relu ? fmaxf(a, 0.f) : a;
}

// Tile `tile`'s image and corner: image n, rows h0 .., columns w0 ..
struct Tile {
  int n, h0, w0;
};

template <int TH>
__device__ __forceinline__ Tile tile_at(int tile, int tiles_h, int tiles_w) {
  return {tile / (tiles_h * tiles_w), ((tile / tiles_w) % tiles_h) * TH, (tile % tiles_w) * kTW};
}

// Element loads of row columns xc .. xc + len - 1 (zero outside [0, W) or
// where !ok) into dst.
__device__ __forceinline__ void load_cols(bf16* dst, const bf16* row, int xc, int len, int W,
                                          bool ok) {
  for (int q = 0; q < len; ++q) {
    dst[q] = ok && xc + q >= 0 && xc + q < W ? row[xc + q] : __float2bfloat16_rn(0.f);
  }
}

// The staged input of a tile of TH rows: TH + 2 rows (the taps' halo) of
// kAP pixel slots, each pixel a row of AS bf16 (Cp channels, zero past C, and
// a pad: an odd number of 16-byte units), staged from the raw box of Cp
// channels x (TH + 2) rows x kRW columns.
template <int TH, int Cp, int AS>
struct Slab {
  static constexpr int kAR = TH + 2;
  static constexpr size_t a_bytes = sizeof(bf16) * kAR * kAP * AS;
  static constexpr size_t box_bytes = sizeof(bf16) * Cp * kAR * kRW;
  // a unit is 8 channels of one staged row: 8 columns (interior) or one
  // halo column; the interior units first
  static constexpr int kInner = (Cp / 8) * (kTW / 8) * kAR;
  static constexpr int kUnits = kInner + (Cp / 8) * 2 * kAR;

  // Starts the copy of tile t's raw x (Cp channels x kAR rows x kRW columns,
  // x columns w0 - 8 .., rows h0 - 1 ..; zeros outside the image and past C)
  // into s_raw: one TMA box completing on `bar`, or element loads where x's
  // rows are not 16-byte aligned. Every thread of the block calls it.
  static __device__ __forceinline__ void start_copy(const DwArgs& a, const void* tmap,
                                                    const Tile& t, bf16* s_raw, uint64_t* bar) {
    if (a.tma) {
      if (threadIdx.x == 0) {
        itg::fence_proxy_async();  // the stage's earlier reads come before the copy's writes
        itg::mbar_expect_tx(bar, static_cast<uint32_t>(box_bytes));  // the box, zeros included
        itg::tma_load_4d(s_raw, tmap, bar, t.w0 - 8, t.h0 - 1, 0, t.n);
      }
      return;
    }
    const size_t plane = static_cast<size_t>(a.H) * a.W;
    const bf16* xn = a.x + static_cast<size_t>(t.n) * a.C * plane;
    for (int u = threadIdx.x; u < Cp * kAR * (kRW / 8); u += kThreads) {
      const int k = u % (kRW / 8), r = (u / (kRW / 8)) % kAR, c = u / (kRW / 8 * kAR);
      const int xr = t.h0 + r - 1;
      const bool ok = c < a.C && xr >= 0 && xr < a.H;
      load_cols(s_raw + (c * kAR + r) * kRW + 8 * k,
                xn + c * plane + static_cast<size_t>(ok ? xr : 0) * a.W, t.w0 - 8 + 8 * k, 8, a.W,
                ok);
    }
  }

  // Unit u's staged row r, part (interior: 8-column chunk; halo: 0 left, 1
  // right) and channel group og; true for an interior unit.
  static __device__ __forceinline__ bool unit(int u, int& r, int& part, int& og) {
    const bool inner = u < kInner;
    const int v = inner ? u : u - kInner;
    const int parts = inner ? kTW / 8 : 2;
    r = v % kAR, part = (v / kAR) % parts, og = v / (kAR * parts);
    return inner;
  }

  // Unit u's post-norm pixels from the raw tile, handed to put(i, v): pixel
  // i of the unit, one pixel's 8 channels v. Staged row r is padded row h0 +
  // r (x row h0 + r - 1), slot s is padded column w0 + s (x column w0 + s -
  // 1, raw column s + 7); an interior unit is slots 8 part + 1 .. (raw
  // columns 8 (part + 1) ..), pixels 0..7, a halo unit slot 0 or kTW + 1,
  // pixel 0. The fold, ReLU and rounding in registers; zero outside the
  // image (the replicate ring is filled by ring()).
  template <typename Put>
  static __device__ __forceinline__ void load(int u, const bf16* s_raw, const float* s_sc,
                                              const float* s_sh, int h0, int w0, int H, int W,
                                              int relu, Put&& put) {
    int r, part, og;
    const bool inner = unit(u, r, part, og);
    const bool row_in = h0 + r - 1 >= 0 && h0 + r - 1 < H;
    const bf16* src = s_raw + (8 * og * kAR + r) * kRW;
    const float* sc = s_sc + 8 * og;
    const float* sh = s_sh + 8 * og;
    if (inner) {
      src += 8 * (part + 1);
      uint32_t o[8][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 lo = *reinterpret_cast<const uint4*>(src + 2 * k * kAR * kRW);
        const uint4 hi = *reinterpret_cast<const uint4*>(src + (2 * k + 1) * kAR * kRW);
        const float sc0 = sc[2 * k], sc1 = sc[2 * k + 1], sh0 = sh[2 * k], sh1 = sh[2 * k + 1];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const uint32_t wl = word(lo, p / 2), wh = word(hi, p / 2);
          const float v0 = (p & 1) ? bf16_hi(wl) : bf16_lo(wl);
          const float v1 = (p & 1) ? bf16_hi(wh) : bf16_lo(wh);
          o[p][k] = itg::pack_bf16x2(pre(v0, sc0, sh0, relu), pre(v1, sc1, sh1, relu));
        }
      }
      const int xc0 = w0 + 8 * part;  // x column of slot 8 part + 1
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        // channels past C hold zeros with scale = shift = 0: act(0) = 0
        put(p, row_in && xc0 + p < W ? make_uint4(o[p][0], o[p][1], o[p][2], o[p][3])
                                     : make_uint4(0u, 0u, 0u, 0u));
      }
    } else {
      const int xc = part ? w0 + kTW : w0 - 1;
      src += part ? kTW + 8 : 7;
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v0 = __bfloat162float(src[2 * k * kAR * kRW]);
        const float v1 = __bfloat162float(src[(2 * k + 1) * kAR * kRW]);
        o[k] = itg::pack_bf16x2(pre(v0, sc[2 * k], sh[2 * k], relu),
                                pre(v1, sc[2 * k + 1], sh[2 * k + 1], relu));
      }
      put(0, row_in && xc >= 0 && xc < W ? make_uint4(o[0], o[1], o[2], o[3])
                                         : make_uint4(0u, 0u, 0u, 0u));
    }
  }

  // Pixel i of unit u into A: one 16-byte store.
  static __device__ __forceinline__ void store(int u, int i, const uint4& v, bf16* s_a) {
    int r, part, og;
    const int slot = unit(u, r, part, og) ? 8 * part + 1 + i : part ? kAC - 1 : 0;
    *reinterpret_cast<uint4*>(s_a + (r * kAP + slot) * AS + 8 * og) = v;
  }

  // The replicate ring inside the tile: padded column 0 and W + 1 take
  // columns 1 and W, then padded rows 0 and H + 1 take rows 1 and H (so a
  // corner gets the corner value). Every thread of the block calls it, after
  // A is staged.
  static __device__ __forceinline__ void ring(bf16* s_a, int h0, int w0, int H, int W) {
    const int tid = threadIdx.x;
    const int sl = w0 == 0 ? 0 : -1, sr = W + 1 - w0 < kAC ? W + 1 - w0 : -1;
    const int rt = h0 == 0 ? 0 : -1, rb = H + 1 - h0 < kAR ? H + 1 - h0 : -1;
    if (sl >= 0 || sr >= 0) {
      for (int u = tid; u < 2 * kAR * (Cp / 8); u += kThreads) {
        const int og = u % (Cp / 8), r = (u / (Cp / 8)) % kAR, side = u / (kAR * Cp / 8);
        const int s = side ? sr : sl;
        if (s < 0) continue;
        const int from = side ? s - 1 : s + 1;
        *reinterpret_cast<uint4*>(s_a + (r * kAP + s) * AS + 8 * og) =
            *reinterpret_cast<const uint4*>(s_a + (r * kAP + from) * AS + 8 * og);
      }
      __syncthreads();
    }
    if (rt >= 0 || rb >= 0) {
      for (int u = tid; u < 2 * kAC * (Cp / 8); u += kThreads) {
        const int og = u % (Cp / 8), s = (u / (Cp / 8)) % kAC, side = u / (kAC * Cp / 8);
        const int r = side ? rb : rt;
        if (r < 0) continue;
        const int from = side ? r - 1 : r + 1;
        *reinterpret_cast<uint4*>(s_a + (r * kAP + s) * AS + 8 * og) =
            *reinterpret_cast<const uint4*>(s_a + (from * kAP + s) * AS + 8 * og);
      }
      __syncthreads();
    }
  }
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no link against libcuda); null where it is not available.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// Sets a.tma where x's rows are 16-byte aligned and then encodes x (N, C, H,
// W) as a 4-D tensor map with box (kRW, rows, cp, 1); returns a CUDA error
// (0 on success).
inline int x_tensor_map(DwArgs& a, int rows, int cp, CUtensorMap* tmap) {
  a.tma = a.W % 8 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  if (!a.tma) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.W), static_cast<cuuint64_t>(a.H),
                              static_cast<cuuint64_t>(a.C), static_cast<cuuint64_t>(a.N)};
  const cuuint64_t row = sizeof(bf16) * static_cast<cuuint64_t>(a.W);
  const cuuint64_t strides[3] = {row, row * a.H, row * a.H * a.C};  // bytes, dims 1..3
  const cuuint32_t box[4] = {kRW, static_cast<cuuint32_t>(rows), static_cast<cuuint32_t>(cp), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(a.x), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace itg::dw
