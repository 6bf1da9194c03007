// The 1x1 shortcut's weight gradient (K3-dW) on the CUDA cores: the
// float32 route (bf16 runs on the tensor cores in conv1x1_tc.cu; this entry
// point takes bf16 too).
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:2361
// _conv1x1_chw_dw (kernel _dw1x1_kernel :2326):
//   dW[o, c] = sum g[o] x[c] and db[o] = sum g[o] over (N, H, W)
// for channels-major x (N, C, H, W) and g (N, Co, H, W), C * Co <= 4096 and
// C + Co <= 96.
//
// What bounds it on the H100: 2 C Co FLOPs per pixel against 4 (C + Co)
// bytes in float32. At the Experiment-1 shortcut (52 -> 26) that is 2704
// FLOPs against 312 bytes, 8.7 FLOP/byte, under the float32 FFMA ridge of
// 20 (67 TFLOP/s over 3.35 TB/s): the bound is one read of x and g. Its
// operands come from shared memory, whose load pipe serves one 4-byte word
// a lane a cycle (a 16-byte load takes four cycles even as a broadcast), so
// the design counts loaded words per FMA. What it does:
// - Persistent blocks. The planner in ops/kernels.py
//   (conv1x1_dw_f32_plan) sizes the grid to the card, one block of 256
//   threads an SM. A block walks a contiguous range of 64-pixel chunks;
//   a chunk never leaves its image (the last one of an image is padded
//   with zeros).
// - One pass over x and g. A chunk's C rows of x and Co rows of g land in
//   shared memory by 16-byte cp.async copies, in a ring of kStages stages:
//   while this chunk's FMAs run, the next three chunks' copies are in
//   flight. Where HW is not a multiple of 4 (or a row is not 16-byte
//   aligned, or the activations are bf16) the chunk is copied element by
//   element instead.
// - Register outer products. A thread owns a tile of 7 output x 13 input
//   channels and one pixel slot of the chunk (every S-th pixel). Per pixel
//   it loads 7 g and 13 x values and does 91 FMAs: 4.55 FMAs a loaded
//   word. The rows past C and Co are zero rows, staged once, so every
//   tile's loads are plain offsets. A row of the stage is 72 floats: the
//   tiles of a warp then read distinct banks at the Experiment-1 shapes.
//   The threads of the first input-channel tile also sum db.
// - Fixed-order sums. The pixel slots of a block are added in a fixed
//   tree through shared memory; each block writes its dW and db partials,
//   and a second launch adds the blocks' partials in one fixed order (as
//   the bf16 route does). No atomics: two calls give the same bits.
#include "common.cuh"
#include "mma.cuh"  // cp.async groups

namespace {

using itg::cp_async16z;
using itg::cp_async4;
using itg::to_f32;

constexpr int kThreads = 256;
constexpr int kTO = 7;          // output channels of a thread's tile
constexpr int kTC = 13;         // input channels of a thread's tile
constexpr int kP = 64;          // pixels a chunk
constexpr int kSP = kP + 8;     // floats a staged row (72 = 8 mod 32: conflict-free tiles)
constexpr int kStages = 4;
constexpr int kVals = kTO * kTC + kTO;  // a thread's sums: its dW tile, then db
constexpr int kRedCols = kThreads / 2;  // threads that write in the reduction's first level

struct DwArgs {
  const void* x;  // (N, C, HW)
  const void* g;  // (N, Co, HW)
  float* part;    // (gridDim.x, Co C + Co)
  int N, C, HW, Co;
  int tiles_c, tiles_o;  // ceil(C / kTC), ceil(Co / kTO)
  int Cp, Cop;           // kTC tiles_c, kTO tiles_o: the staged rows of x and g
  long long chunks;      // N ceil(HW / kP)
  int vec;               // 16-byte copies (float32, HW % 4 == 0, aligned rows)
};

// Chunk q (image q / per_image, pixels kP (q % per_image) ..) into stage s:
// the C rows of x, then the Co rows of g (rows Cp .. of the stage).
template <typename T>
__device__ __forceinline__ void stage_chunk(const DwArgs& a, long long q, int per_image,
                                            float* s) {
  const int n = static_cast<int>(q / per_image);
  const int p0 = static_cast<int>(q % per_image) * kP;
  const int rows = a.C + a.Co;
  const T* xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * a.C * a.HW;
  const T* gn = static_cast<const T*>(a.g) + static_cast<size_t>(n) * a.Co * a.HW;
  if constexpr (sizeof(T) == 4) {
    if (a.vec) {
      for (int u = threadIdx.x; u < rows * (kP / 4); u += kThreads) {
        const int row = u / (kP / 4), p = p0 + 4 * (u % (kP / 4));
        const bool ok = p < a.HW;
        const T* src = row < a.C ? xn + static_cast<size_t>(row) * a.HW
                                 : gn + static_cast<size_t>(row - a.C) * a.HW;
        const int srow = row < a.C ? row : a.Cp + row - a.C;
        cp_async16z(s + srow * kSP + 4 * (u % (kP / 4)), src + (ok ? p : 0), ok);
      }
      return;
    }
  }
  for (int u = threadIdx.x; u < rows * kP; u += kThreads) {
    const int row = u / kP, j = u % kP, p = p0 + j;
    const bool ok = p < a.HW;
    const T* src = row < a.C ? xn + static_cast<size_t>(row) * a.HW
                             : gn + static_cast<size_t>(row - a.C) * a.HW;
    float* dst = s + (row < a.C ? row : a.Cp + row - a.C) * kSP + j;
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst, src + (ok ? p : 0), ok);
    } else {
      *dst = ok ? to_f32<T>(src[p]) : 0.f;
    }
  }
}

// Grid (blocks), kThreads threads; dynamic shared memory: kStages stages of
// (Cp + Cop) rows of kSP floats, or the reduction's kVals x kRedCols floats
// if larger. Block b takes chunks [b chunks / B, (b + 1) chunks / B).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) conv1x1_dw_f32_kernel(const DwArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int stage_floats = (a.Cp + a.Cop) * kSP;
  const int per_image = (a.HW + kP - 1) / kP;
  const long long q0 = a.chunks * blockIdx.x / gridDim.x;
  const long long q1 = a.chunks * (blockIdx.x + 1) / gridDim.x;
  const int count = static_cast<int>(q1 - q0);

  // the zero rows past C and Co, in every stage (no copy writes them)
  for (int s = 0; s < kStages; ++s) {
    float* st = smem + s * stage_floats;
    for (int i = tid; i < (a.Cp - a.C) * kSP; i += kThreads) st[a.C * kSP + i] = 0.f;
    for (int i = tid; i < (a.Cop - a.Co) * kSP; i += kThreads) st[(a.Cp + a.Co) * kSP + i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) stage_chunk<T>(a, q0 + i, per_image, smem + i * stage_floats);
    itg::cp_async_commit();
  }

  // thread (t, s): tile t = (to, tc), pixel slot s of S
  const int T_ = a.tiles_o * a.tiles_c;
  const int S = kThreads / T_;
  const int t = tid % T_, slot = tid / T_;
  const bool active = slot < S;
  const int to = t / a.tiles_c, tc = t % a.tiles_c;
  const int xoff = kTC * tc * kSP, goff = (a.Cp + kTO * to) * kSP;
  float acc[kTO][kTC], db[kTO];
#pragma unroll
  for (int i = 0; i < kTO; ++i) {
    db[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
  }

  for (int k = 0; k < count; ++k) {
    itg::cp_async_wait_group<kStages - 2>();
    __syncthreads();  // chunk k is in; every thread is done with the stage refilled below
    if (k + kStages - 1 < count) {
      stage_chunk<T>(a, q0 + k + kStages - 1, per_image,
                     smem + ((k + kStages - 1) % kStages) * stage_floats);
    }
    itg::cp_async_commit();
    if (!active) continue;
    const float* sx = smem + (k % kStages) * stage_floats + xoff;
    const float* sg = smem + (k % kStages) * stage_floats + goff;
#pragma unroll 2
    for (int p = slot; p < kP; p += S) {
      float gv[kTO], xv[kTC];
#pragma unroll
      for (int i = 0; i < kTO; ++i) gv[i] = sg[i * kSP + p];
#pragma unroll
      for (int j = 0; j < kTC; ++j) xv[j] = sx[j * kSP + p];
#pragma unroll
      for (int i = 0; i < kTO; ++i) {
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
      if (tc == 0) {
#pragma unroll
        for (int i = 0; i < kTO; ++i) db[i] = __fadd_rn(db[i], gv[i]);
      }
    }
  }
  itg::cp_async_wait_all();

  // -- the block's sums: the pixel slots added in a fixed tree (slot s +
  // half onto slot s), entry e of thread w of a level at red[e kRedCols + w]
  float* red = smem;
#pragma unroll 1
  for (int m = S; m > 1;) {
    const int half = (m + 1) / 2;
    __syncthreads();  // the stages (or the last level) are read
    if (active && slot >= half && slot < m) {
      const int w = (slot - half) * T_ + t;
#pragma unroll
      for (int i = 0; i < kTO; ++i) {
#pragma unroll
        for (int j = 0; j < kTC; ++j) red[(i * kTC + j) * kRedCols + w] = acc[i][j];
        red[(kTO * kTC + i) * kRedCols + w] = db[i];
      }
    }
    __syncthreads();
    if (active && slot + half < m) {
      const int w = slot * T_ + t;
#pragma unroll
      for (int i = 0; i < kTO; ++i) {
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], red[(i * kTC + j) * kRedCols + w]);
        }
        db[i] = __fadd_rn(db[i], red[(kTO * kTC + i) * kRedCols + w]);
      }
    }
    m = half;
  }
  if (active && slot == 0) {
    const size_t E = static_cast<size_t>(a.Co) * a.C + a.Co;
    float* out = a.part + blockIdx.x * E;
#pragma unroll
    for (int i = 0; i < kTO; ++i) {
      const int o = kTO * to + i;
      if (o >= a.Co) break;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = kTC * tc + j;
        if (c < a.C) out[static_cast<size_t>(o) * a.C + c] = acc[i][j];
      }
      if (tc == 0) out[static_cast<size_t>(a.Co) * a.C + o] = db[i];
    }
  }
}

// dW (Co, C) and db (Co): entry e of the partials (dW row-major, then db),
// the blocks' rows summed in one fixed order. A block takes 32 entries (a
// warp's coalesced columns) x 32 segments: segment s adds the rows s, s +
// 32, ..., then the segments are added in order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
conv1x1_dw_f32_reduce(const float* __restrict__ part, float* __restrict__ dw,
                      float* __restrict__ db, int blocks, int C, int Co) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int E = Co * C + Co;
  const int le = threadIdx.x % kRedEntries, seg = threadIdx.x / kRedEntries;
  const int e = blockIdx.x * kRedEntries + le;
  float v = 0.f;
  if (e < E) {
    for (int b = seg; b < blocks; b += kRedSegs) {
      v = __fadd_rn(v, part[static_cast<size_t>(b) * E + e]);
    }
  }
  s_sum[seg][le] = v;
  __syncthreads();
  if (seg == 0 && e < E) {
#pragma unroll
    for (int s = 1; s < kRedSegs; ++s) v = __fadd_rn(v, s_sum[s][le]);
    if (e < Co * C) {
      dw[e] = v;
    } else {
      db[e - Co * C] = v;
    }
  }
}

template <typename T>
int launch(const DwArgs& a, float* dw, float* db, int blocks, cudaStream_t st) {
  const size_t ring = sizeof(float) * kStages * (a.Cp + a.Cop) * kSP;
  const size_t reduce = sizeof(float) * kVals * kRedCols;
  const size_t smem = ring > reduce ? ring : reduce;
  const auto kernel = conv1x1_dw_f32_kernel<T>;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  const int E = a.Co * a.C + a.Co;
  conv1x1_dw_f32_reduce<<<(E + kRedEntries - 1) / kRedEntries, kRedEntries * kRedSegs, 0, st>>>(
      a.part, dw, db, blocks, a.C, a.Co);
  return itg::last_error();
}

}  // namespace

// x (n, c, hw), g (n, co, hw): activation type (float32, or bfloat16 when
// bf16 != 0). part (blocks, co c + co) float32 scratch; dw (co, c) and db
// (co) float32, written (not accumulated). blocks: the persistent grid
// (ops/kernels.py: conv1x1_dw_f32_plan; any count from 1 gives a valid
// result). Needs c * co <= 4096 and c + co <= 96. Two launches; returns the
// first CUDA error (cudaErrorInvalidValue for a shape it does not take).
extern "C" int itg_conv1x1_chw_dw(const void* x, const void* g, void* part, void* dw, void* db,
                                  int n, int c, int hw, int co, int bf16, int blocks,
                                  void* stream) {
  if (n < 1 || c < 1 || co < 1 || hw < 1 || c * co > 4096 || c + co > 96 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_c = (c + kTC - 1) / kTC, tiles_o = (co + kTO - 1) / kTO;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  DwArgs a{x, g, static_cast<float*>(part), n, c, hw, co, tiles_c, tiles_o, kTC * tiles_c,
           kTO * tiles_o, static_cast<long long>(n) * ((hw + kP - 1) / kP),
           !bf16 && hw % 4 == 0 && aligned};
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, w, b, blocks, st);
  return launch<float>(a, w, b, blocks, st);
}
