// The discriminator stem's forward on the tensor cores, for bfloat16: a
// 4x4 / stride-2 / zero-pad-1 convolution of the channels-major fake image x
// (N, C, H, W), C <= 4 (3 on the path), into NHWC y (N, H/2, W/2, Co),
//   y[n, i, j, o] = b[o] + sum_{c, ky, kx} w[o, c, ky, kx] *
//                   x[n, c, 2i + ky - 1, 2j + kx - 1]   (zero outside x),
// with w and b rounded to bf16 (the reference rounds both to the activation
// type before its kernel, pallas_conv.py:3041 and :3045), bf16 x bf16
// products summed in float32, the bias added and y rounded once to bf16.
//
// Replaces K13's forward infinite_texture_gans_tpu/ops/pallas_conv.py:
// _stem_fwd_call (:2761, pallas_call :2769, kernel _stem_kernel :2683),
// reached through conv4x4s2_stem_chw (:3086) -> _stem_impl_chw (:3028).
// Float32 takes the CUDA-core kernel of stem_fwd_f32.cu (the stem's f32 dx:
// stem_dx_f32.cu, f32 dW: stem_dw_f32.cu, bf16 dW: stem_dw_tc.cu).
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per output pixel against
// 4 C input and 2 Co output bytes (Co = 64: 6,144 FLOPs for 140 bytes, 44
// FLOP/byte, far below the 295 at which the tensor cores would bind), so
// bytes: at N = 8, 384^2 a launch reads 7.1 MB and writes 37.7 MB of NHWC
// y, 13.4 us at 3.35 TB/s. The design:
// - Implicit GEMM on warp-level mma.sync m16n8k16 (bf16 operands, float32
//   sums): M = output pixels of a row segment (a warp owns one output row of
//   the tile as two m16 tiles of 16 pixels), N = every output channel (Co
//   padded to 8 NO with zero weight rows, walked in chunks of 64 so the
//   accumulators stay 64 registers, any Co up to kMaxCo), K = 16 C, one k16
//   step per input channel with k = ky * 4 + kx.
// - A straight from the staged input rows, no im2col: a lane's k pairs (2t,
//   2t + 1) and (2t + 8, 2t + 9) are the taps kx in {0, 1} or {2, 3} of row
//   ky = t / 2 or 2 + t / 2; with the staging origin at column 2 j0 - 1 they
//   sit at staged columns 2 (j - j0) + kx, an even index, so each A register
//   is one aligned 32-bit shared-memory load. A staged row is 48 words (16
//   mod 32), so the two rows a fragment register spans fall in disjoint
//   banks for the warp's 8 pixels x 4 k lanes.
// - Staging: the C x (2 * 4 + 2) input rows under a tile of 4 output rows x
//   32 pixels, 16-byte vector loads of 8 columns; the zero border (pad 1,
//   rows and columns past the image) is decided per 16-byte chunk, and a
//   chunk's 8 values land at an odd staged column as three 32-bit words and
//   two 16-bit halves. Where W is not a multiple of 8 or x is not 16-byte
//   aligned, the same tile is staged element by element. The next tile's
//   chunks load into registers while this tile multiplies.
// - B, the weights rounded to bf16 (ops/kernels.py: pack_stem_weights is
//   the plain version of that order: row o, K contiguous), and the rounded
//   bias are staged once per block; blocks are persistent, each walking
//   tiles blockIdx.x, + gridDim.x, ..., so they are reused across tiles. A
//   weight row is 8 C + 4 words, so B's 8 rows x 4 k lanes hit distinct
//   banks.
// - Epilogue: float32 sum + bias, rounded to bf16, staged as the tile's NHWC
//   rows in shared memory (a pixel's 8 NO + 8 values, or 8 NO + 16 for odd
//   NO: an odd number of 16-byte units, conflict-free for the fragments' 8
//   pixels x 4 channel pairs), then written with 16-byte stores,
//   consecutive lanes on consecutive addresses: a row segment of 32 pixels
//   x Co is contiguous in NHWC. Where Co is not a multiple of 8 (a row's
//   16-byte units would straddle pixels), the same staged tile is written
//   element by element, only the Co valid channels of each pixel.
// - Bits: each y sums its C k16 steps in one fixed order; no atomics and no
//   split K, so two calls give the same bits.
// The TPU kernel's 0/1 column-selection matmul (`mp`), its 128-lane width
// padding and its 8-row height padding have no counterpart.
#include "common.cuh"
#include "mma.cuh"
#include "stem_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::mma_bf16;
using itg::pack_bf16x2;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
using itg::stem::kChunks;  // 16-byte chunks per staged row
using itg::stem::kRows;    // staged input rows per channel
using itg::stem::kTJ;      // output pixels per tile row: two m16 tiles
using itg::stem::kTR;      // output rows per tile, a warp each
using itg::stem::Tile;
using itg::stem::tile_at;
static_assert(kTR == kWarps, "a warp takes one output row of the tile");
constexpr int kCols = 2 * kTJ + 2;          // staged input columns used
constexpr int kFront = 8;                   // staged slots before the origin column
constexpr int kRowStride = 96;              // bf16 slots per staged row (48 words)
constexpr int kNChunk = 8;                  // n8 tiles per pass over the channels
constexpr int kMaxCo = 512;  // the widest Co whose block fits in shared memory at
                             // C = 4 (ops/kernels.py: STEM_TC_MAX_CO)

struct StemArgs {
  const uint16_t* x;
  const float* w;
  const float* b;
  uint16_t* y;
  int N, H, W, Co;
  int vec;  // 16-byte staging: W % 8 == 0 and x 16-byte aligned
};

// bf16 per staged output pixel for NO groups of 8 channels: an odd number
// of 16-byte units.
__host__ __device__ constexpr int out_stride(int no) { return 8 * (no + 1 + (no & 1)); }

// Shared memory for NO groups: y's tile (kTR x kTJ pixels of out_stride
// bf16), the weights (8 NO rows of 8 C + 4 words, zero past Co), the bias
// (8 NO floats), the input rows (C x kRows x kRowStride bf16).
__host__ __device__ constexpr size_t out_bytes(int no) {
  return static_cast<size_t>(kTR) * kTJ * out_stride(no) * 2;
}

template <int C>
__host__ __device__ constexpr size_t smem_bytes(int no) {
  return out_bytes(no) + static_cast<size_t>(8 * no) * (8 * C + 4) * 4 +
         static_cast<size_t>(8 * no) * 4 + static_cast<size_t>(C) * kRows * kRowStride * 2;
}

// Chunks of 16 bytes a thread loads per tile in the vector mode.
template <int C>
__host__ __device__ constexpr int chunks_per_thread() {
  return (C * kRows * kChunks + kThreads - 1) / kThreads;
}

// Chunk k's values e0..e7 go to staged slots 8k + 1 .. 8k + 8 (slot kFront
// is input column 2 j0 - 1): e0 and e7 as 16-bit halves, (e1, e2), (e3,
// e4), (e5, e6) as the words 4k + 1 .. 4k + 3. Every slot has one writer.
__device__ __forceinline__ void store_chunk(uint16_t* s_in, int q, const uint4& v) {
  const int row = q / kChunks;  // c * kRows + rr
  const int k = q % kChunks;
  uint16_t* base = s_in + row * kRowStride;
  uint32_t* words = reinterpret_cast<uint32_t*>(base);
  base[8 * k + 1] = static_cast<uint16_t>(v.x & 0xffffu);
  words[4 * k + 1] = __byte_perm(v.x, v.y, 0x5432);
  words[4 * k + 2] = __byte_perm(v.y, v.z, 0x5432);
  words[4 * k + 3] = __byte_perm(v.z, v.w, 0x5432);
  base[8 * k + 8] = static_cast<uint16_t>(v.w >> 16);
}

// The element-wise staging of a tile (W % 8 != 0 or x unaligned): the
// kCols slots each staged row uses, zero outside the image.
template <int C>
__device__ __forceinline__ void stage_scalar(const StemArgs& a, const Tile& tl, uint16_t* s_in) {
  for (int idx = threadIdx.x; idx < C * kRows * kCols; idx += kThreads) {
    const int row = idx / kCols;
    const int s = idx % kCols;
    const int c = row / kRows;
    const int gr = 2 * tl.i0 - 1 + row % kRows;
    const int gc = 2 * tl.j0 - 1 + s;
    uint16_t v = 0;
    if (gr >= 0 && gr < a.H && gc >= 0 && gc < a.W) {
      v = a.x[((static_cast<size_t>(tl.n) * C + c) * a.H + gr) * a.W + gc];
    }
    s_in[row * kRowStride + kFront + s] = v;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 3) stem_fwd_tc_kernel(StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kW = 8 * C + 4;  // words per weight row
  constexpr int kPer = chunks_per_thread<C>();
  constexpr int kQ = C * kRows * kChunks;
  const int Co = a.Co;
  const int NO = (Co + 7) / 8;
  const int Cop = 8 * NO;
  const int ostride = out_stride(NO);
  uint16_t* s_out = reinterpret_cast<uint16_t*>(smem);
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem + out_bytes(NO));
  float* s_b = reinterpret_cast<float*>(s_w + Cop * kW);
  uint16_t* s_in = reinterpret_cast<uint16_t*>(s_b + Cop);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int H2 = a.H / 2;
  const int W2 = a.W / 2;
  const int it_n = (H2 + kTR - 1) / kTR;
  const int jt_n = (W2 + kTJ - 1) / kTJ;
  const long tiles = static_cast<long>(a.N) * it_n * jt_n;
  long tt = blockIdx.x;
  if (tt >= tiles) return;

  for (int idx = threadIdx.x; idx < Cop * 8 * C; idx += kThreads) {
    const int o = idx / (8 * C);
    const int k2 = idx - o * 8 * C;
    const float* src = a.w + static_cast<size_t>(o) * 16 * C + 2 * k2;
    s_w[o * kW + k2] = o < Co ? pack_bf16x2(src[0], src[1]) : 0u;
  }
  for (int o = threadIdx.x; o < Cop; o += kThreads) {
    s_b[o] = o < Co ? itg::round_to<bf16>(a.b[o]) : 0.f;
  }

  uint4 pre[kPer];
  Tile tl = tile_at(tt, it_n, jt_n);
  if (a.vec) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = threadIdx.x + u * kThreads;
      if (q < kQ) store_chunk(s_in, q, itg::stem::load_chunk<C>(a.x, a.H, a.W, tl, q));
    }
  } else {
    stage_scalar<C>(a, tl, s_in);
  }
  __syncthreads();

  for (; tt < tiles; tt += gridDim.x) {
    const long tn = tt + gridDim.x;
    const Tile nx = tn < tiles ? tile_at(tn, it_n, jt_n) : tl;
    if (a.vec && tn < tiles) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int q = threadIdx.x + u * kThreads;
        if (q < kQ) pre[u] = itg::stem::load_chunk<C>(a.x, a.H, a.W, nx, q);
      }
    }

    // A: this warp's output row (staged rows 2 warp .. 2 warp + 3), two
    // m16 tiles of pixels, one k16 step per channel
    uint32_t af[2][C][4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint16_t* rows = s_in + (c * kRows + 2 * warp) * kRowStride + kFront;
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(rows + (t >> 1) * kRowStride);
      const uint32_t* r2 = reinterpret_cast<const uint32_t*>(rows + (2 + (t >> 1)) * kRowStride);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int m = mt * 16 + g + (t & 1);
        af[mt][c][0] = r0[m];
        af[mt][c][1] = r0[m + 8];
        af[mt][c][2] = r2[m];
        af[mt][c][3] = r2[m + 8];
      }
    }
    uint32_t* s_out32 = reinterpret_cast<uint32_t*>(s_out);
    for (int n0 = 0; n0 < NO; n0 += kNChunk) {
      float acc[2][kNChunk][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kNChunk; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int nt = 0; nt < kNChunk; ++nt) {
          if (n0 + nt < NO) {
            const uint32_t* wr = s_w + ((n0 + nt) * 8 + g) * kW + c * 8 + t;
            const uint32_t b0 = wr[0];
            const uint32_t b1 = wr[4];
            mma_bf16(acc[0][nt], af[0][c], b0, b1);
            mma_bf16(acc[1][nt], af[1][c], b0, b1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNChunk; ++nt) {
        if (n0 + nt < NO) {
          const int o = (n0 + nt) * 8 + 2 * t;
          const float b0 = s_b[o];
          const float b1 = s_b[o + 1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int p = warp * kTJ + mt * 16 + g;
            s_out32[(p * ostride + o) >> 1] = pack_bf16x2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
            s_out32[((p + 8) * ostride + o) >> 1] =
                pack_bf16x2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
          }
        }
      }
    }
    __syncthreads();  // y's tile complete; the input rows free

    if (tn < tiles) {
      if (a.vec) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int q = threadIdx.x + u * kThreads;
          if (q < kQ) store_chunk(s_in, q, pre[u]);
        }
      } else {
        stage_scalar<C>(a, nx, s_in);
      }
    }
    // y: each tile row's valid pixels x Co are one contiguous NHWC run,
    // 16 bytes a lane where Co keeps the units whole, else a value a lane
    const int valid = min(kTJ, W2 - tl.j0);
    for (int rr = 0; rr < kTR; ++rr) {
      const int i = tl.i0 + rr;
      if (i >= H2) break;
      uint16_t* row = a.y + ((static_cast<size_t>(tl.n) * H2 + i) * W2 + tl.j0) * Co;
      const uint16_t* src = s_out + rr * kTJ * ostride;
      if (Co % 8 == 0) {
        uint4* dst = reinterpret_cast<uint4*>(row);
        for (int u = threadIdx.x; u < valid * NO; u += kThreads) {
          const int p = u / NO;
          dst[u] = *reinterpret_cast<const uint4*>(src + p * ostride + 8 * (u - p * NO));
        }
      } else {
        for (int u = threadIdx.x; u < valid * Co; u += kThreads) {
          const int p = u / Co;
          row[u] = src[p * ostride + u - p * Co];
        }
      }
    }
    __syncthreads();  // y's tile read; the next tile's input rows staged
    tl = nx;
  }
}

// One persistent launch: at most the blocks the card holds at once, the
// tiles spread evenly over them.
template <int C>
int launch(const StemArgs& a, cudaStream_t st) {
  const auto kernel = stem_fwd_tc_kernel<C>;
  const size_t smem = smem_bytes<C>((a.Co + 7) / 8);
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) {
    return static_cast<int>(e);
  }
  const long held = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count();
  const long tiles = static_cast<long>(a.N) * ((a.H / 2 + kTR - 1) / kTR) *
                     ((a.W / 2 + kTJ - 1) / kTJ);
  if (tiles == 0) return 0;
  const long waves = (tiles + held - 1) / held;
  const long blocks = (tiles + waves - 1) / waves;
  kernel<<<static_cast<int>(blocks), kThreads, smem, st>>>(a);
  return itg::last_error();
}

}  // namespace

// K13's forward on the tensor cores. x (n, c, h, w) bfloat16, 1 <= c <= 4,
// h and w even; w (co, c, 4, 4) and b (co) float32 (rounded to bf16 by the
// kernel); y (n, h/2, w/2, co) bfloat16; 1 <= co <= kMaxCo. One launch;
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape the kernel
// does not take).
extern "C" int itg_stem_fwd_tc(const void* x, const void* w, const void* b, void* y, int n, int c,
                               int h, int width, int co, void* stream) {
  if (h % 2 || width % 2 || co < 1 || co > kMaxCo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = width % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const StemArgs a{static_cast<const uint16_t*>(x), static_cast<const float*>(w),
                   static_cast<const float*>(b), static_cast<uint16_t*>(y), n, h, width, co, vec};
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
