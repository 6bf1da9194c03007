// The discriminator stem's weight gradient (K13 dW) on the CUDA cores: the
// float32 route (bf16 runs on the tensor cores in stem_dw_tc.cu; this entry
// point takes bf16 too).
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:2840 _stem_dw_call
// (kernel _stem_dw_kernel :2788), reached through conv4x4s2_stem_chw
// (:3086): for x (N, C, H, W) channels-major, C <= 4, and g (N, H/2, W/2,
// Co) NHWC, the cotangent of the stem's output,
//   dW[o, c, ky, kx] = sum g[n, i, j, o] x[n, c, 2i + ky - 1, 2j + kx - 1]
//   (zero outside the image) and db[o] = sum g[n, i, j, o].
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per output pixel
// against 4 (4 C + Co) bytes in float32. At the Experiment-1 stem (8 x 3 x
// 384^2 fakes, 64 channels) a call is 1.81 GFLOP (0.027 ms of FFMA at 67
// TFLOP/s) against 90 MB, mostly g (0.027 ms at 3.35 TB/s): both bounds sit
// together. The operands come from shared memory, whose load pipe serves
// one 4-byte word a lane a cycle, so the design counts loaded words per
// FMA. What it does:
// - Persistent blocks. The planner in ops/kernels.py (stem_dw_f32_plan)
//   sizes the grid to the card, one block an SM for each chunk of 64 output
//   channels (the grid's second axis), and picks the block's warps and its
//   chunk. A chunk is `rows` output rows x 32 output columns of one image;
//   a block walks a contiguous range of them.
// - Chunks through a cp.async double buffer. A chunk's g rows (its 32 x
//   rows pixels' 64 channels, NHWC: 16-byte copies where Co is a multiple
//   of 4) and its 2 rows + 2 input rows of x (66 columns a row, zeros
//   outside the image) land in shared memory while the previous chunk's
//   FMAs run.
// - Register outer products. A warp is a pixel slot; its lane (og, ky)
//   owns output channels og, og + 8, ..., og + 56 of the block's 64 and the
//   row tap ky, with all C input channels and the 4 column taps: 32 C sums.
//   It walks a run of 16 pixels along an output row, keeping a window of x
//   in registers: output pixel j reads input columns 2j - 1 .. 2j + 2, the
//   next one two columns on, so a pixel costs 8 g words (the 8 og lanes of
//   a ky read 8 consecutive words; the 4 ky lanes share them) and 2 C x
//   words (one row per lane's ky, a broadcast over og) for 32 C FMAs: 6.9
//   FMAs a loaded word at C = 3. db rides along on the same g values.
// - Fixed-order partials. A block adds its pixel slots in a fixed tree
//   through shared memory and writes its dW and db partials; a last launch
//   adds the blocks' partials in one fixed order. No atomics: two calls give
//   the same bits.
// bf16 activations are loaded and converted on the way into shared memory.
// The TPU kernel's 0/1 selection matmuls, row-stacked packing and 8-row
// alignment have no counterpart.
#include "common.cuh"
#include "mma.cuh"  // cp.async groups

namespace {

using itg::cp_async16z;
using itg::cp_async4;
using itg::to_f32;

constexpr int kCO = 64;           // output channels of a block (the grid's second axis)
constexpr int kCols = 32;         // output columns of a chunk
constexpr int kRun = 16;          // output pixels of a run
constexpr int kRuns = kCols / kRun;
constexpr int kXW = 2 * kCols + 2;  // staged input columns 2 j0 - 1 .. 2 j0 + 64
constexpr int kXS = 68;           // floats a staged x row: the 4 ky rows of a lane sit 4 banks apart
constexpr int kMaxSlots = 12;
constexpr int kRedCols = kMaxSlots / 2 * 32;  // threads that write in the reduction's first level
constexpr int kStages = 2;

// the block's warps at C input channels: 12, or 8 at C = 4 (136 sums a
// thread need the registers of 8 warps an SM)
constexpr int max_threads(int c) { return c == 4 ? 256 : 32 * kMaxSlots; }

struct DwArgs {
  const void* x;  // (N, C, H, W)
  const void* g;  // (N, H2, W2, Co)
  float* part;    // (gridDim.x, Co 16 C + Co)
  int N, H, W, Co, H2, W2;
  int slots, rows;       // warps a block; output rows a chunk
  int rchunks, cchunks;  // ceil(H2 / rows), ceil(W2 / kCols) chunks an image
  long long chunks;      // N rchunks cchunks
  int vec;               // g by 16-byte copies (float32, Co % 4 == 0, aligned)
  int stage_floats;      // C (2 rows + 2) kXS + rows kCols kCO
};

// Chunk q into stage s: x's C planes of 2 rows + 2 rows (staged row r is
// input row 2 i0 - 1 + r, column k input column 2 j0 - 1 + k), then g's
// rows x kCols pixels of kCO channels (channel o0 + oc of chunk pixel
// (r, j) at (r kCols + j) kCO + oc). Zeros outside the image and past Co.
template <typename T, int C>
__device__ __forceinline__ void stage_chunk(const DwArgs& a, long long q, int o0, float* s) {
  const int per_image = a.rchunks * a.cchunks;
  const int n = static_cast<int>(q / per_image);
  const int rem = static_cast<int>(q % per_image);
  const int i0 = (rem / a.cchunks) * a.rows, j0 = (rem % a.cchunks) * kCols;
  const int xr = 2 * a.rows + 2;
  const T* xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * C * a.H * a.W;
  for (int u = threadIdx.x; u < C * xr * kXW; u += blockDim.x) {
    const int k = u % kXW, r = (u / kXW) % xr, c = u / (kXW * xr);
    const int gr = 2 * i0 - 1 + r, gc = 2 * j0 - 1 + k;
    const bool ok = gr >= 0 && gr < a.H && gc >= 0 && gc < a.W;
    const T* src = xn + (static_cast<size_t>(c) * a.H + (ok ? gr : 0)) * a.W + (ok ? gc : 0);
    float* dst = s + (c * xr + r) * kXS + k;
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst, src, ok);
    } else {
      *dst = ok ? to_f32<T>(*src) : 0.f;
    }
  }
  float* sg = s + C * xr * kXS;
  const T* gn = static_cast<const T*>(a.g) + static_cast<size_t>(n) * a.H2 * a.W2 * a.Co;
  if constexpr (sizeof(T) == 4) {
    if (a.vec) {
      for (int u = threadIdx.x; u < a.rows * kCols * (kCO / 4); u += blockDim.x) {
        const int quad = u % (kCO / 4), px = u / (kCO / 4);
        const int i = i0 + px / kCols, j = j0 + px % kCols, o = o0 + 4 * quad;
        const bool ok = i < a.H2 && j < a.W2 && o < a.Co;
        const T* src = gn + (ok ? (static_cast<size_t>(i) * a.W2 + j) * a.Co + o : 0);
        cp_async16z(sg + px * kCO + 4 * quad, src, ok);
      }
      return;
    }
  }
  for (int u = threadIdx.x; u < a.rows * kCols * kCO; u += blockDim.x) {
    const int oc = u % kCO, px = u / kCO;
    const int i = i0 + px / kCols, j = j0 + px % kCols, o = o0 + oc;
    const bool ok = i < a.H2 && j < a.W2 && o < a.Co;
    const T* src = gn + (ok ? (static_cast<size_t>(i) * a.W2 + j) * a.Co + o : 0);
    if constexpr (sizeof(T) == 4) {
      cp_async4(sg + u, src, ok);
    } else {
      sg[u] = ok ? to_f32<T>(*src) : 0.f;
    }
  }
}

// Grid (blocks, ceil(Co / kCO)), 32 slots threads; dynamic shared memory:
// kStages stages of stage_floats, or the reduction's (32 C + 8) x kRedCols
// floats if larger. Block (b, cb) takes chunks [b chunks / B, (b + 1) chunks
// / B) for output channels 64 cb ..; warp w is pixel slot w (runs w, w +
// slots, ... of each chunk), lane (og, ky) = (lane % 8, lane / 8).
template <typename T, int C>
__global__ void __launch_bounds__(max_threads(C), 1) stem_dw_f32_kernel(const DwArgs a) {
  constexpr int kVals = 32 * C + 8;  // a thread's sums: acc[e][c][kx], then db[e]
  extern __shared__ __align__(16) float smem[];
  const int o0 = blockIdx.y * kCO;
  const long long q0 = a.chunks * blockIdx.x / gridDim.x;
  const long long q1 = a.chunks * (blockIdx.x + 1) / gridDim.x;
  const int count = static_cast<int>(q1 - q0);
  const int slot = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int og = lane % 8, ky = lane / 8;
  const int S = a.slots, xr = 2 * a.rows + 2, per_image = a.rchunks * a.cchunks;

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) stage_chunk<T, C>(a, q0 + i, o0, smem + i * a.stage_floats);
    itg::cp_async_commit();
  }

  float acc[8][C][4], db[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    db[e] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) acc[e][c][kx] = 0.f;
    }
  }

  for (int k = 0; k < count; ++k) {
    const float* cur = smem + (k % kStages) * a.stage_floats;
    itg::cp_async_wait_group<kStages - 2>();
    __syncthreads();  // chunk k is in; every thread is done with the stage refilled below
    if (k + kStages - 1 < count) {
      stage_chunk<T, C>(a, q0 + k + kStages - 1, o0,
                        smem + ((k + kStages - 1) % kStages) * a.stage_floats);
    }
    itg::cp_async_commit();
    const int rem = static_cast<int>((q0 + k) % per_image);
    const int i0 = (rem / a.cchunks) * a.rows, j0 = (rem % a.cchunks) * kCols;
    const float* sg = cur + C * xr * kXS;
#pragma unroll 1
    for (int run = slot; run < a.rows * kRuns; run += S) {
      const int rr = run / kRuns, js = (run % kRuns) * kRun;
      if (i0 + rr >= a.H2 || j0 + js >= a.W2) continue;  // g is zero there
      // output pixel js + p of row rr reads staged row 2 rr + ky, columns
      // 2 (js + p) + kx
      const float* xa = cur + (2 * rr + ky) * kXS + 2 * js;
      const float* ga = sg + (rr * kCols + js) * kCO + og;
      float w0[C], w1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        w0[c] = xa[c * xr * kXS];
        w1[c] = xa[c * xr * kXS + 1];
      }
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        float w2[C], w3[C], gv[8];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          w2[c] = xa[c * xr * kXS + 2 * p + 2];
          w3[c] = xa[c * xr * kXS + 2 * p + 3];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) gv[e] = ga[p * kCO + 8 * e];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[e][c][0] = fmaf(gv[e], w0[c], acc[e][c][0]);
            acc[e][c][1] = fmaf(gv[e], w1[c], acc[e][c][1]);
            acc[e][c][2] = fmaf(gv[e], w2[c], acc[e][c][2]);
            acc[e][c][3] = fmaf(gv[e], w3[c], acc[e][c][3]);
          }
          db[e] = __fadd_rn(db[e], gv[e]);
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          w0[c] = w2[c];
          w1[c] = w3[c];
        }
      }
    }
  }
  itg::cp_async_wait_all();

  // -- the block's sums: the pixel slots added in a fixed tree (slot s +
  // half onto slot s), value v of thread w of a level at red[v kRedCols + w]
  float* red = smem;
#pragma unroll 1
  for (int m = S; m > 1;) {
    const int half = (m + 1) / 2;
    __syncthreads();  // the stages (or the last level) are read
    if (slot >= half && slot < m) {
      const int w = (slot - half) * 32 + lane;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int kx = 0; kx < 4; ++kx) red[((e * C + c) * 4 + kx) * kRedCols + w] = acc[e][c][kx];
        }
        red[(kVals - 8 + e) * kRedCols + w] = db[e];
      }
    }
    __syncthreads();
    if (slot + half < m) {
      const int w = slot * 32 + lane;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int kx = 0; kx < 4; ++kx) {
            acc[e][c][kx] = __fadd_rn(acc[e][c][kx], red[((e * C + c) * 4 + kx) * kRedCols + w]);
          }
        }
        db[e] = __fadd_rn(db[e], red[(kVals - 8 + e) * kRedCols + w]);
      }
    }
    m = half;
  }
  if (slot == 0) {
    const size_t E = static_cast<size_t>(a.Co) * C * 16 + a.Co;
    float* out = a.part + blockIdx.x * E;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int o = o0 + og + 8 * e;
      if (o >= a.Co) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
          out[(static_cast<size_t>(o) * C + c) * 16 + ky * 4 + kx] = acc[e][c][kx];
        }
      }
      if (ky == 0) out[static_cast<size_t>(a.Co) * C * 16 + o] = db[e];
    }
  }
}

// dW (Co, C, 4, 4) and db (Co): entry e of the partials (dW row-major, then
// db), the blocks' rows summed in one fixed order. A block takes 32 entries
// (a warp's coalesced columns) x 32 segments: segment s adds the rows s, s +
// 32, ..., then the segments are added in order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
stem_dw_f32_reduce(const float* __restrict__ part, float* __restrict__ dw,
                   float* __restrict__ db, int blocks, long long E, long long Ew) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int le = threadIdx.x % kRedEntries, seg = threadIdx.x / kRedEntries;
  const long long e = static_cast<long long>(blockIdx.x) * kRedEntries + le;
  float v = 0.f;
  if (e < E) {
    for (int b = seg; b < blocks; b += kRedSegs) v = __fadd_rn(v, part[b * E + e]);
  }
  s_sum[seg][le] = v;
  __syncthreads();
  if (seg == 0 && e < E) {
#pragma unroll
    for (int s = 1; s < kRedSegs; ++s) v = __fadd_rn(v, s_sum[s][le]);
    if (e < Ew) {
      dw[e] = v;
    } else {
      db[e - Ew] = v;
    }
  }
}

template <typename T, int C>
int launch(const DwArgs& a, float* dw, float* db, int blocks, cudaStream_t st) {
  const size_t ring = sizeof(float) * kStages * static_cast<size_t>(a.stage_floats);
  const size_t reduce = sizeof(float) * (32 * C + 8) * kRedCols;
  const size_t smem = ring > reduce ? ring : reduce;
  const auto kernel = stem_dw_f32_kernel<T, C>;
  if (32 * a.slots > max_threads(C)) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  kernel<<<dim3(blocks, (a.Co + kCO - 1) / kCO), 32 * a.slots, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  const long long Ew = static_cast<long long>(a.Co) * C * 16, E = Ew + a.Co;
  stem_dw_f32_reduce<<<static_cast<unsigned>((E + kRedEntries - 1) / kRedEntries),
                       kRedEntries * kRedSegs, 0, st>>>(a.part, dw, db, blocks, E, Ew);
  return itg::last_error();
}

template <typename T>
int dispatch(int c, const DwArgs& a, float* dw, float* db, int blocks, cudaStream_t st) {
  switch (c) {
    case 1: return launch<T, 1>(a, dw, db, blocks, st);
    case 2: return launch<T, 2>(a, dw, db, blocks, st);
    case 3: return launch<T, 3>(a, dw, db, blocks, st);
    case 4: return launch<T, 4>(a, dw, db, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (n, c, h, w), g (n, h / 2, w / 2, co): activation type (float32, or
// bfloat16 when bf16 != 0), 1 <= c <= 4, h and w even. part (blocks, co 16 c
// + co) float32 scratch; dw (co, c, 4, 4) and db (co) float32, written (not
// accumulated). The plan (ops/kernels.py: stem_dw_f32_plan): blocks, the
// persistent grid's first axis (any count from 1 gives a valid result);
// slots, warps a block (1 to 12, 8 at c = 4); rows, output rows a chunk
// (two stages must fit the card's shared memory). Two launches; returns the
// first CUDA error (cudaErrorInvalidValue for a shape or plan it does not
// take).
extern "C" int itg_stem_dw(const void* x, const void* g, void* part, void* dw, void* db, int n,
                           int c, int h, int width, int co, int bf16, int blocks, int slots,
                           int rows, void* stream) {
  if (n < 1 || h < 2 || width < 2 || h % 2 || width % 2 || co < 1 || blocks < 1 || slots < 1 ||
      slots > kMaxSlots || rows < 1 || static_cast<long long>(h) * width > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int h2 = h / 2, w2 = width / 2;
  const int rchunks = (h2 + rows - 1) / rows, cchunks = (w2 + kCols - 1) / kCols;
  const bool aligned = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const DwArgs a{x, g, static_cast<float*>(part), n, h, width, co, h2, w2, slots, rows, rchunks,
                 cchunks, static_cast<long long>(n) * rchunks * cchunks,
                 !bf16 && co % 4 == 0 && aligned, c * (2 * rows + 2) * kXS + rows * kCols * kCO};
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(c, a, w, b, blocks, st);
  return dispatch<float>(c, a, w, b, blocks, st);
}
