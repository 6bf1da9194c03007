// The discriminator stem's input gradient (K13 dx) on the CUDA cores: the
// float32 route (bf16 runs on the tensor cores in stem_dx_tc.cu; this entry
// point takes bf16 too). The stem's forward is stem_fwd_f32.cu, its dW
// stem_dw_f32.cu.
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:2977 _stem_dx_call
// (kernel _stem_dx_kernel :2877), reached through conv4x4s2_stem_chw
// (:3086): for g (N, H/2, W/2, Co) NHWC and the OIHW float32 weight w (Co,
// C, 4, 4), C <= 4, dx[n, c, r, s] = sum over o and the taps whose stride-2
// window covers (r, s). Per axis the tap parity is fixed by the pixel's: dx
// row r = 2p + py takes g rows p + py - a with ky = 1 - py + 2a (a = 0, 1),
// and the same for columns, so a pixel of parity class (py, px) sums 4 taps
// x Co products, and a g cell feeds 4 x 4 pixels.
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per g cell against 4 Co
// bytes of g and 16 C bytes of dx in float32: at C = 3, Co = 64 the FFMAs
// (67 TFLOP/s) bound it about as much as the bytes (3.35 TB/s). What the
// design does about it:
// - A lane holds one parity class: 4 rows x 4 columns of its pixels x C
//   channels in registers, so it needs 4 C weights an output channel, and
//   streams its 5 x 5 g cells a row at a time (each g row feeds two of its
//   pixel rows).
// - g is read once from device memory: a block stages its 16 rows x 32
//   columns of g cells and their zero halo by cp.async, two output
//   channels in one 8-byte copy, through a double buffer of 8-channel
//   chunks; a cell takes 5 slots of 8 bytes, so a half warp's loads (its
//   lanes' cells differ modulo 16) hit distinct banks. An output-channel
//   pair costs a lane 25 8-byte g loads and 2 C 16-byte weight loads for
//   128 C FMAs.
// - Each dx element sums its products in one fixed order (output-channel
//   pair, then g row, channel, g column), whatever its tile; no atomics.
// - A block is 4 warps (16 g rows x 32 columns): 2 and 8 warps a block were
//   slower or within 2% at every shape the steps give it on the H100.
// The TPU kernel's 0/1 selection matmuls, row-stacked packing and 8-row
// alignment have no counterpart.
#include "common.cuh"
#include "mma.cuh"  // cp.async groups

namespace {

using itg::cp_async4;
using itg::cp_async8;
using itg::from_f32;

constexpr int kRows = 4;             // g rows of a lane's pixels (and of a warp)
constexpr int kCols = 4;             // g columns of a lane's pixels
constexpr int kLaneCols = 8;         // lanes of a warp along a row (32 g columns)
constexpr int kTileW = kCols * kLaneCols;  // g columns of a block
constexpr int kRS = kTileW + 2;      // staged cells a row (34: 2 modulo 16)
constexpr int kPairs = 4;            // output-channel pairs a chunk
constexpr int kSlots = kPairs + 1;   // 8-byte (float) or 4-byte (bf16) slots a staged cell
constexpr int kWarps = 4;            // warps a block, stacked along the rows
constexpr int kSrows = kRows * kWarps + 2;  // staged g rows: the block's and the halo

// Two output channels of a staged g cell: float2 for float32 g, a bf16 pair
// for bf16 g.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 get(const float2& v) { return v; }
  static __device__ __forceinline__ float2 make(float lo, float hi) { return make_float2(lo, hi); }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 get(const __nv_bfloat162& v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ __nv_bfloat162 make(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return __halves2bfloat162(lo, hi);
  }
};

struct Args {
  const void* g;     // (N, H2, W2, Co)
  const float* w;    // (Co, C, 4, 4)
  void* dx;          // (N, C, H, W)
  int H2, W2, Co, tiles_w, vec;
};

// Grid (tiles of the g grid: 16 rows x 32 columns, N), 128 threads.
// Dynamic shared memory: two stages of the g tile (kSrows rows x kRS cells
// x kSlots pair slots: staged row R, column K hold g row p0 - 1 + R, column
// q0 - 1 + K; zero outside g and past Co), then two stages of the chunk's
// weights (pair, class, c, channel of the pair, tap: 128 C floats).
template <typename T, int C>
__global__ void __launch_bounds__(32 * kWarps, C == 4 ? 2 : 4)
    stem_dx_f32_kernel(const Args a) {
  using P = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int nthr = 32 * kWarps;
  const int tid = threadIdx.x;
  constexpr int gstage = kSrows * kRS * kSlots;  // pair slots a stage
  constexpr int wstage = kPairs * 4 * C * 8;    // floats a stage
  P* s_g = reinterpret_cast<P*>(smem_raw);
  float* s_w = reinterpret_cast<float*>(s_g + 2 * gstage);
  const int n = blockIdx.y;
  const int p0 = (blockIdx.x / a.tiles_w) * kRows * kWarps;
  const int q0 = (blockIdx.x % a.tiles_w) * kTileW;
  const int H2 = a.H2, W2 = a.W2, Co = a.Co;
  const T* gn = static_cast<const T*>(a.g) + static_cast<size_t>(n) * H2 * W2 * Co;

  // chunk o0 / 8 into stage s: g's pairs (o0 + 2 j, o0 + 2 j + 1), and
  // w[o, c, 1 - py + 2 ta, 1 - px + 2 tb] at (((j 4 + cls) C + c) 2 + oi) 4 +
  // 2 ta + tb for o = o0 + 2 j + oi, cls = 2 py + px
  auto stage = [&](int o0, P* sg, float* sw) {
    for (int i = tid; i < kSrows * kRS * kPairs; i += nthr) {
      const int j = i % kPairs, cell = i / kPairs;
      const int gi = p0 - 1 + cell / kRS, gj = q0 - 1 + cell % kRS, o = o0 + 2 * j;
      const bool in = gi >= 0 && gi < H2 && gj >= 0 && gj < W2;
      const size_t off = in ? (static_cast<size_t>(gi) * W2 + gj) * Co : 0;
      P* dst = sg + cell * kSlots + j;
      if (a.vec) {  // Co even, g aligned: a pair is one copy
        const bool ok = in && o < Co;
        if constexpr (sizeof(P) == 8) {
          cp_async8(dst, gn + (ok ? off + o : 0), ok);
        } else {
          cp_async4(dst, gn + (ok ? off + o : 0), ok);
        }
      } else {
        const T zero = from_f32<T>(0.f);
        *dst = Pair<T>::make(in && o < Co ? gn[off + o] : zero,
                             in && o + 1 < Co ? gn[off + o + 1] : zero);
      }
    }
    for (int i = tid; i < wstage; i += nthr) {
      const int t = i % 4, oi = (i / 4) % 2, c = (i / 8) % C, cls = (i / (8 * C)) % 4;
      const int o = o0 + 2 * (i / (32 * C)) + oi;
      const int ky = 1 - cls / 2 + 2 * (t / 2), kx = 1 - cls % 2 + 2 * (t % 2);
      const bool ok = o < Co;
      cp_async4(sw + i, a.w + (ok ? ((static_cast<size_t>(o) * C + c) * 4 + ky) * 4 + kx : 0),
                ok);
    }
  };

  const int wid = tid / 32, lane = tid % 32;
  const int px = lane & 1, py = (lane >> 1) & 1, ux = lane >> 2, cls = 2 * py + px;
  // lane row k, column m: staged row kRows wid + py + k, column kCols ux + px + m
  const int base = (kRows * wid + py) * kRS + kCols * ux + px;
  float acc[kRows][kCols][C];
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[t][e][c] = 0.f;
    }
  }

  stage(0, s_g, s_w);
  itg::cp_async_commit();
  const int chunks = (Co + 2 * kPairs - 1) / (2 * kPairs);
  for (int k = 0; k < chunks; ++k) {
    const int cur = k & 1;
    itg::cp_async_wait_all();
    __syncthreads();  // chunk k is in; every thread is done with the other stage
    if (k + 1 < chunks) {
      stage((k + 1) * 2 * kPairs, s_g + (cur ^ 1) * gstage, s_w + (cur ^ 1) * wstage);
    }
    itg::cp_async_commit();
    const P* sg = s_g + cur * gstage + base * kSlots;
    const float* sw = s_w + cur * wstage + cls * C * 8;
#pragma unroll 1
    for (int j = 0; j < kPairs; ++j) {
      // taps (ta, tb) = (0, 0), (0, 1), (1, 0), (1, 1) of each channel of the pair
      float4 wv[C][2];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        wv[c][0] = *reinterpret_cast<const float4*>(sw + j * 32 * C + c * 8);
        wv[c][1] = *reinterpret_cast<const float4*>(sw + j * 32 * C + c * 8 + 4);
      }
#pragma unroll
      for (int r = 0; r <= kRows; ++r) {
        // g row r feeds pixel row r with ta = 1, then pixel row r - 1 with ta = 0
        float2 gv[kCols + 1];
#pragma unroll
        for (int m = 0; m <= kCols; ++m) gv[m] = Pair<T>::get(sg[(r * kRS + m) * kSlots + j]);
#pragma unroll
        for (int ta = 1; ta >= 0; --ta) {
          const int t = r - 1 + ta;
          if (t < 0 || t >= kRows) continue;
#pragma unroll
          for (int oi = 0; oi < 2; ++oi) {
#pragma unroll
            for (int tb = 0; tb < 2; ++tb) {
#pragma unroll
              for (int c = 0; c < C; ++c) {
                const float4& w4 = wv[c][oi];
                const float wt = ta ? (tb ? w4.w : w4.z) : (tb ? w4.y : w4.x);
#pragma unroll
                for (int e = 0; e < kCols; ++e) {
                  const float2& g2 = gv[e + 1 - tb];
                  acc[t][e][c] = fmaf(oi ? g2.y : g2.x, wt, acc[t][e][c]);
                }
              }
            }
          }
        }
      }
    }
  }

  T* dxn = static_cast<T*>(a.dx) + static_cast<size_t>(n) * C * (2 * H2) * (2 * W2);
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int p = p0 + kRows * wid + t;
    if (p >= H2) break;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int q = q0 + kCols * ux + e;
      if (q >= W2) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dxn[(static_cast<size_t>(c) * 2 * H2 + 2 * p + py) * 2 * W2 + 2 * q + px] =
            from_f32<T>(acc[t][e][c]);
      }
    }
  }
}

template <typename T, int C>
int launch(const Args& a, int n, cudaStream_t stream) {
  using P = typename Pair<T>::type;
  const size_t smem = 2 * sizeof(P) * kSrows * kRS * kSlots +
                      2 * sizeof(float) * kPairs * 4 * C * 8;
  if (cudaError_t e = cudaFuncSetAttribute(stem_dx_f32_kernel<T, C>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const int tiles_h = (a.H2 + kRows * kWarps - 1) / (kRows * kWarps);
  stem_dx_f32_kernel<T, C><<<dim3(tiles_h * a.tiles_w, n), 32 * kWarps, smem, stream>>>(a);
  return itg::last_error();
}

template <typename T>
int dispatch(int c, const Args& a, int n, cudaStream_t stream) {
  switch (c) {
    case 1: return launch<T, 1>(a, n, stream);
    case 2: return launch<T, 2>(a, n, stream);
    case 3: return launch<T, 3>(a, n, stream);
    case 4: return launch<T, 4>(a, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// g (N, H/2, W/2, Co) activation type, w (Co, C, 4, 4) float32 -> dx (N, C,
// H, W) activation type.
extern "C" int itg_stem_dx(const void* g, const void* w, void* dx, int n, int c, int h, int width,
                           int co, int bf16, void* stream) {
  if (h % 2 || width % 2 || h < 2 || width < 2 || n < 1 || n > 65535 || co < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t es = bf16 ? 2 : 4;
  const bool vec = co % 2 == 0 && (reinterpret_cast<uintptr_t>(g) & (2 * es - 1)) == 0;
  const Args a{g, static_cast<const float*>(w), dx, h / 2, width / 2, co,
               (width / 2 + kTileW - 1) / kTileW, vec};
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(c, a, n, st);
  return dispatch<float>(c, a, n, st);
}
