// The weight-side gradient of the subpixel-fused up-conv (K9 dW) on the CUDA
// cores: the float32 route (bf16 runs on the tensor cores in
// upconv_dw_tc.cu; this entry point takes bf16 too).
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:1777 _upconv3x3_dw
// (kernel _updw_kernel :1673): for x (N, C, H, W) at half resolution and g
// (N, Co, 2H, 2W), the cotangent of the forward's y,
//   D[o, c, (di, dj, r, s)] = sum g[o, 2i + di, 2j + dj] A[c, i - 1 + di + r, j - 1 + dj + s]
// over (N, H, W), the gradient of the forward's combined phase taps (A the
// padded post-norm half-res slab the forward read, act(scale * x + shift)
// recomputed with its rounding, its ring the edge it replicates or zero),
// folded back to dW (Co, C, 3, 3) by the transpose of the combination (row
// slots then column slots: K0 <- slots (0, 0) + (1, 0), K1 <- (0, 1) + (1,
// 0), K2 <- (0, 1) + (1, 1); ops/kernels.py: _upconv_unpack_dw), and db[o]
// = sum g[o] over (N, 2H, 2W).
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per half-res pixel
// against 4 (C + 4 Co) bytes in float32. At the Experiment-1 shapes (52 ->
// 26 at a 96^2 half resolution, 26 -> 13 at 192^2, N = 8) FFMA issue bounds
// it (67 TFLOP/s outside the tensor cores: 0.048 ms a call), not the bytes
// (0.014 ms). Its operands come from shared memory, whose load pipe serves
// one 4-byte word a lane a cycle, so the design counts loaded words per FMA.
// It is K7's design (conv3x3_dw_f32.cu) with the 16 phase taps:
// - Persistent blocks. The planner in ops/kernels.py (upconv_dw_f32_plan)
//   sizes the grid to the card, one block an SM, and picks the block's
//   threads and its chunk. A chunk is `rows` half-res rows x 32 columns of
//   one image (2 rows x 64 columns of g a half-res row); a block walks a
//   contiguous range of them.
// - Pixel chunks through a cp.async double buffer. A chunk's x with its
//   one-cell ring (rows + 2 rows x 34 columns a channel; the ring clamped to
//   the edge with replicate padding, zero with zeros) and its g rows land in
//   shared memory by cp.async copies while the previous chunk's FMAs run.
// - A normalised once a chunk, for every output channel of the block: when
//   a chunk is in, the block applies the BN fold and ReLU to its x cells in
//   place (__fmul_rn, __fadd_rn: the forward's bits). A block holds up to 32
//   output x 52 input channels (every channel of the Experiment-1 shapes),
//   so A is staged and normalised once; wider layers split the channels over
//   the grid's second axis.
// - Register outer products. A thread owns 2 output x 4 input channels at
//   one phase row di, with its 8 taps (dj, r, s): 64 sums. It walks a run
//   of 8 pixels along a half-res row with a 2-row x 3-column window of A in
//   registers: a pixel costs 4 g words (its two full-res columns 2 j + dj of
//   row 2 i + di) and 8 A words (the window's new column) for 64 FMAs, 5.3
//   FMAs a loaded word (the old body: 16 FMAs for 7). 4 output channels a
//   thread load fewer words per FMA but take 227 registers against 128, so
//   a block of at most 256 threads, and read 17% slower at 52 -> 26
//   (f32_route_study.py's plan table on an H100). Each pixel slot (a power
//   of two of them, so every slot takes the same number of runs, up to 512
//   threads) holds every (o, c, di) tile, and the threads past slots x tiles
//   idle. A stage holds each row's channels side by side, 35 (x) and 65 (g)
//   floats apart (odd): a thread's loads are constant offsets of one
//   address, and the tiles of a warp read distinct banks or one broadcast
//   address.
// - Fixed-order partials. A block adds its pixel slots in a fixed tree
//   through shared memory and writes its per-phase-tap dW and db partials; a
//   second launch adds the blocks' partials in one fixed order, folds the 16
//   taps to the 3 x 3 ones and writes dW and db. No atomics and no zero-fill:
//   two calls give the same bits.
// bf16 activations are loaded and converted (and A rounded to bf16, as the
// forward rounds it) on the way into shared memory.
#include "common.cuh"
#include "mma.cuh"  // cp.async groups

namespace {

using itg::cp_async4;
using itg::to_f32;

constexpr int kTO = 2;               // output channels of a thread's tile
constexpr int kTC = 4;               // input channels of a thread's tile
constexpr int kTaps = 8;             // a phase row's taps: (dj 2 + r) 2 + s
constexpr int kCols = 32;            // half-res columns of a chunk
constexpr int kSeg = 8;              // pixels of a run
constexpr int kSegs = kCols / kSeg;  // runs a chunk row
constexpr int kXW = kCols + 2;       // staged x cells a row
constexpr int kXRS = kCols + 3;      // floats a staged x row (odd)
constexpr int kGW = 2 * kCols;       // staged g cells a full-res row
constexpr int kGRS = kGW + 1;        // floats a staged g row (odd)
constexpr int kMaxThreads = 512;
constexpr int kMaxTilesC = 13;       // a block's input channels: up to 52
constexpr int kMaxTilesO = 16;       // a block's output tiles: up to 32 channels
constexpr int kVals = kTO * kTC * kTaps + kTO;  // a thread's sums: its dW tile, then db
constexpr int kRedCols = kMaxThreads / 2;       // threads that write in the reduction's first level
constexpr int kStages = 2;

struct DwArgs {
  const void* x;  // (N, C, H, W)
  const void* g;  // (N, Co, 2H, 2W)
  const float* scale;
  const float* shift;
  float* part;  // (gridDim.x, Co C 16 + Co)
  int N, C, H, W, Co, relu, zeros;
  int tiles_c, tiles_o;  // the block's tiles: ceil(C_b / kTC), ceil(Co_b / kTO)
  int cblocks;           // channel blocks along C (the grid's second axis: cblocks x oblocks)
  int slots, rows;       // pixel slots; half-res rows a chunk
  int rchunks, cchunks;  // ceil(H / rows), ceil(W / kCols) chunks an image
  long long chunks;      // N rchunks cchunks
  int xrs, grs;          // floats a staged row of x (kTC tiles_c channels), of g (kTO tiles_o)
  int stage_floats;      // (rows + 2) xrs + 2 rows grs
};

// Where staged x cell u (row u / kXW, column u % kXW) of the chunk at (r0,
// c0) comes from: its offset in a channel's plane, and whether it is an x
// value (else zero).
__device__ __forceinline__ bool x_cell(const DwArgs& a, int r0, int c0, int u, size_t* off) {
  int i = r0 - 1 + u / kXW, j = c0 - 1 + u % kXW;
  if (a.zeros) {
    if (i < 0 || i >= a.H || j < 0 || j >= a.W) return false;
  } else {
    i = min(max(i, 0), a.H - 1);
    j = min(max(j, 0), a.W - 1);
  }
  *off = static_cast<size_t>(i) * a.W + j;
  return true;
}

// Chunk q into stage s: the block's input channels c_lo .. c_hi - 1 of x
// ((rows + 2) rows of xrs floats, channel c - c_lo of a row kXRS floats
// after channel 0, kXW cells each), then its output channels o_lo .. o_hi -
// 1 of g (2 rows full-res rows of grs floats, a channel kGRS floats, kGW
// cells). bf16 values are converted, and x normalised, on the way in.
template <typename T>
__device__ __forceinline__ void stage_chunk(const DwArgs& a, long long q, int c_lo, int c_hi,
                                            int o_lo, int o_hi, float* s) {
  const int per_image = a.rchunks * a.cchunks;
  const int n = static_cast<int>(q / per_image);
  const int rem = static_cast<int>(q % per_image);
  const int r0 = (rem / a.cchunks) * a.rows, c0 = (rem % a.cchunks) * kCols;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const int H2 = 2 * a.H, W2 = 2 * a.W;
  const T* xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * a.C * plane;
  const T* gn = static_cast<const T*>(a.g) + static_cast<size_t>(n) * a.Co * 4 * plane;
  for (int u = threadIdx.x; u < (a.rows + 2) * kXW; u += blockDim.x) {
    size_t off = 0;
    const bool ok = x_cell(a, r0, c0, u, &off);
    float* dst = s + (u / kXW) * a.xrs + u % kXW;
    for (int c = c_lo; c < c_hi; ++c, dst += kXRS) {
      const T* src = xn + (ok ? c * plane + off : 0);
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst, src, ok);
      } else {
        *dst = ok ? itg::prenorm<T>(to_f32<T>(*src), __ldg(a.scale + c), __ldg(a.shift + c),
                                    a.relu)
                  : 0.f;
      }
    }
  }
  float* sg = s + (a.rows + 2) * a.xrs;
  for (int u = threadIdx.x; u < 2 * a.rows * kGW; u += blockDim.x) {
    const int i = 2 * r0 + u / kGW, j = 2 * c0 + u % kGW;
    const bool ok = i < H2 && j < W2;
    const size_t off = ok ? static_cast<size_t>(i) * W2 + j : 0;
    float* dst = sg + (u / kGW) * a.grs + u % kGW;
    for (int o = o_lo; o < o_hi; ++o, dst += kGRS) {
      const T* src = gn + (ok ? o * 4 * plane + off : 0);
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst, src, ok);
      } else {
        *dst = ok ? to_f32<T>(*src) : 0.f;
      }
    }
  }
}

// The BN fold and ReLU on the x cells of the chunk at stage s (float32: the
// copies land raw), from the block's nc scales and shifts in s_ss (scales,
// then shifts at kSS). A cell's channels go kNorm at a time, their loads
// issued together. Zero cells (zeros padding) stay zero.
constexpr int kSS = kTC * kMaxTilesC;
constexpr int kNorm = 4;

__device__ __forceinline__ void normalise(const DwArgs& a, long long q, int nc,
                                          const float* s_ss, float* s) {
  const int rem = static_cast<int>(q % (a.rchunks * a.cchunks));
  const int r0 = (rem / a.cchunks) * a.rows, c0 = (rem % a.cchunks) * kCols;
  for (int u = threadIdx.x; u < (a.rows + 2) * kXW; u += blockDim.x) {
    size_t off;
    if (!x_cell(a, r0, c0, u, &off)) continue;
    float* p = s + (u / kXW) * a.xrs + u % kXW;
    int c = 0;
    for (; c + kNorm <= nc; c += kNorm) {
      float v[kNorm];
#pragma unroll
      for (int e = 0; e < kNorm; ++e) v[e] = p[(c + e) * kXRS];
#pragma unroll
      for (int e = 0; e < kNorm; ++e) {
        p[(c + e) * kXRS] = itg::prenorm<float>(v[e], s_ss[c + e], s_ss[kSS + c + e], a.relu);
      }
    }
    for (; c < nc; ++c) {
      p[c * kXRS] = itg::prenorm<float>(p[c * kXRS], s_ss[c], s_ss[kSS + c], a.relu);
    }
  }
}

// Grid (blocks, cblocks x oblocks), blockDim.x threads (<= kMaxThreads);
// dynamic shared memory: kStages stages of stage_floats, or the reduction's
// kVals x kRedCols floats if larger, then the block's scales and shifts (2
// kSS floats) and its db of phase row 1 (kTO kMaxTilesO floats). Block (b,
// cb) takes chunks [b chunks / B, (b + 1) chunks / B) for its channel
// block; thread tid is tile t = tid % T (output tile to, input tile tc,
// phase row di) of pixel slot tid / T.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) upconv_dw_f32_kernel(const DwArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int c_lo = (blockIdx.y % a.cblocks) * kTC * kMaxTilesC;
  const int o_lo = (blockIdx.y / a.cblocks) * kTO * kMaxTilesO;
  const int c_hi = min(a.C, c_lo + kTC * a.tiles_c), o_hi = min(a.Co, o_lo + kTO * a.tiles_o);
  const long long q0 = a.chunks * blockIdx.x / gridDim.x;
  const long long q1 = a.chunks * (blockIdx.x + 1) / gridDim.x;
  const int count = static_cast<int>(q1 - q0);
  const int ring = kStages * a.stage_floats;
  float* s_ss = smem + (ring > kVals * kRedCols ? ring : kVals * kRedCols);
  float* s_db = s_ss + 2 * kSS;
  for (int i = tid; i < c_hi - c_lo; i += blockDim.x) {
    s_ss[i] = __ldg(a.scale + c_lo + i);
    s_ss[kSS + i] = __ldg(a.shift + c_lo + i);
  }

  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) stage_chunk<T>(a, q0 + i, c_lo, c_hi, o_lo, o_hi, smem + i * a.stage_floats);
    itg::cp_async_commit();
  }

  const int T_ = a.tiles_o * a.tiles_c * 2;
  const int S = a.slots;
  const int t = tid % T_, slot = tid / T_;
  const bool active = slot < S;
  const int to = t % a.tiles_o, tc = (t / a.tiles_o) % a.tiles_c, di = t / (a.tiles_o * a.tiles_c);
  const int xoff = di * a.xrs + kTC * tc * kXRS;
  const int goff = (a.rows + 2) * a.xrs + di * a.grs + kTO * to * kGRS;
  const int per_image = a.rchunks * a.cchunks;
  float acc[kTO][kTC][kTaps], db[kTO];
#pragma unroll
  for (int m = 0; m < kTO; ++m) {
    db[m] = 0.f;
#pragma unroll
    for (int k = 0; k < kTC; ++k) {
#pragma unroll
      for (int e = 0; e < kTaps; ++e) acc[m][k][e] = 0.f;
    }
  }

  for (int k = 0; k < count; ++k) {
    float* cur = smem + (k % kStages) * a.stage_floats;
    itg::cp_async_wait_group<kStages - 2>();
    __syncthreads();  // chunk k is in; every thread is done with the stage refilled below
    if constexpr (sizeof(T) == 4) {
      normalise(a, q0 + k, c_hi - c_lo, s_ss, cur);
      __syncthreads();
    }
    if (k + kStages - 1 < count) {
      stage_chunk<T>(a, q0 + k + kStages - 1, c_lo, c_hi, o_lo, o_hi,
                     smem + ((k + kStages - 1) % kStages) * a.stage_floats);
    }
    itg::cp_async_commit();
    if (!active) continue;
    const int rem = static_cast<int>((q0 + k) % per_image);
    const int r0 = (rem / a.cchunks) * a.rows, c0 = (rem % a.cchunks) * kCols;
    const float* sx = cur + xoff;
    const float* sg = cur + goff;
#pragma unroll 1
    for (int run = slot; run < a.rows * kSegs; run += S) {
      const int r = run / kSegs, cs = (run % kSegs) * kSeg;
      if (r0 + r >= a.H || c0 + cs >= a.W) continue;  // g is zero there
      // A rows r + di + rr (staged), column cs + p + dj + s at pixel p; g
      // full-res row 2 r + di, column 2 (cs + p) + dj
      const float* xa = sx + r * a.xrs + cs;
      const float* ga = sg + 2 * r * a.grs + 2 * cs;
      float a0[kTC][2], a1[kTC][2];
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          a0[c][rr] = xa[c * kXRS + rr * a.xrs];
          a1[c][rr] = xa[c * kXRS + rr * a.xrs + 1];
        }
      }
#pragma unroll
      for (int p = 0; p < kSeg; ++p) {
        float a2[kTC][2], gv[kTO][2];
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) a2[c][rr] = xa[c * kXRS + rr * a.xrs + p + 2];
        }
#pragma unroll
        for (int m = 0; m < kTO; ++m) {
          gv[m][0] = ga[m * kGRS + 2 * p];
          gv[m][1] = ga[m * kGRS + 2 * p + 1];
        }
#pragma unroll
        for (int m = 0; m < kTO; ++m) {
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              // (dj, s) = (0, 0), (0, 1), (1, 0), (1, 1): window columns 0, 1, 1, 2
              acc[m][c][(0 * 2 + rr) * 2 + 0] = fmaf(gv[m][0], a0[c][rr], acc[m][c][(0 * 2 + rr) * 2 + 0]);
              acc[m][c][(0 * 2 + rr) * 2 + 1] = fmaf(gv[m][0], a1[c][rr], acc[m][c][(0 * 2 + rr) * 2 + 1]);
              acc[m][c][(1 * 2 + rr) * 2 + 0] = fmaf(gv[m][1], a1[c][rr], acc[m][c][(1 * 2 + rr) * 2 + 0]);
              acc[m][c][(1 * 2 + rr) * 2 + 1] = fmaf(gv[m][1], a2[c][rr], acc[m][c][(1 * 2 + rr) * 2 + 1]);
            }
          }
          db[m] = __fadd_rn(__fadd_rn(db[m], gv[m][0]), gv[m][1]);
        }
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            a0[c][rr] = a1[c][rr];
            a1[c][rr] = a2[c][rr];
          }
        }
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
        for (int j = 0; j < kTC; ++j) {
#pragma unroll
          for (int e = 0; e < kTaps; ++e) red[((i * kTC + j) * kTaps + e) * kRedCols + w] = acc[i][j][e];
        }
        red[(kVals - kTO + i) * kRedCols + w] = db[i];
      }
    }
    __syncthreads();
    if (active && slot + half < m) {
      const int w = slot * T_ + t;
#pragma unroll
      for (int i = 0; i < kTO; ++i) {
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
#pragma unroll
          for (int e = 0; e < kTaps; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], red[((i * kTC + j) * kTaps + e) * kRedCols + w]);
          }
        }
        db[i] = __fadd_rn(db[i], red[(kVals - kTO + i) * kRedCols + w]);
      }
    }
    m = half;
  }
  // db: phase row 1's half (g's odd full-res rows) onto phase row 0's
  const bool db_tile = active && slot == 0 && c_lo == 0 && tc == 0;
  if (db_tile && di == 1) {
#pragma unroll
    for (int i = 0; i < kTO; ++i) s_db[kTO * to + i] = db[i];
  }
  __syncthreads();
  if (active && slot == 0) {
    const size_t E = static_cast<size_t>(a.Co) * a.C * 16 + a.Co;
    float* out = a.part + blockIdx.x * E;
#pragma unroll
    for (int i = 0; i < kTO; ++i) {
      const int o = o_lo + kTO * to + i;
      if (o >= o_hi) break;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = c_lo + kTC * tc + j;
        if (c < c_hi) {
          float* d = out + (static_cast<size_t>(o) * a.C + c) * 16 + di * 8;
#pragma unroll
          for (int e = 0; e < kTaps; ++e) d[e] = acc[i][j][e];  // tap ((di 2 + dj) 2 + r) 2 + s
        }
      }
      if (db_tile && di == 0) {
        out[static_cast<size_t>(a.Co) * a.C * 16 + o] = __fadd_rn(db[i], s_db[kTO * to + i]);
      }
    }
  }
}

// dW (Co, C, 3, 3) and db (Co) from the partials (per phase tap, row-major,
// then db): the blocks' rows summed in one fixed order, then each (o, c)
// pair's 16 taps folded to 3 x 3. A block takes 32 entries (a warp's
// coalesced columns: two pairs, or 32 of db) x 32 segments: segment s adds
// the rows s, s + 32, ..., then the segments are added in order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;
constexpr int kPairs = kRedEntries / 16;

// The fold of one pair's summed taps D[((di 2 + dj) 2 + r) 2 + s]: the row
// slot rs = di 2 + r and the column slot cs = dj 2 + s of 3 x 3 tap (ky, kx)
// are kSlotA and kSlotB of ky and kx; rows are added first.
__device__ __constant__ int kSlotA[3] = {0, 1, 1};
__device__ __constant__ int kSlotB[3] = {2, 2, 3};

__device__ __forceinline__ float tap16(const float* d, int rs, int cs) {
  return d[(((rs >> 1) * 2 + (cs >> 1)) * 2 + (rs & 1)) * 2 + (cs & 1)];
}

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
upconv_dw_f32_reduce(const float* __restrict__ part, float* __restrict__ dw,
                     float* __restrict__ db, int blocks, long long pairs, int Co,
                     int pair_blocks) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int le = threadIdx.x % kRedEntries, seg = threadIdx.x / kRedEntries;
  const long long Ew = pairs * 16, E = Ew + Co;
  const bool taps = static_cast<int>(blockIdx.x) < pair_blocks;
  const long long e = taps ? static_cast<long long>(blockIdx.x) * kRedEntries + le
                           : Ew + static_cast<long long>(blockIdx.x - pair_blocks) * kRedEntries + le;
  const bool live = taps ? e < Ew : e < E;
  float v = 0.f;
  if (live) {
    for (int b = seg; b < blocks; b += kRedSegs) v = __fadd_rn(v, part[b * E + e]);
  }
  s_sum[seg][le] = v;
  __syncthreads();
  if (seg == 0) {
#pragma unroll
    for (int s = 1; s < kRedSegs; ++s) v = __fadd_rn(v, s_sum[s][le]);
    if (!taps && live) db[e - Ew] = v;
  }
  if (!taps) return;
  __syncthreads();  // every segment's row read
  if (seg == 0) s_sum[0][le] = v;
  __syncthreads();
  if (threadIdx.x < kPairs * 9) {
    const long long pair = static_cast<long long>(blockIdx.x) * kPairs + threadIdx.x / 9;
    const int ky = threadIdx.x % 9 / 3, kx = threadIdx.x % 3;
    if (pair < pairs) {
      const float* d = &s_sum[0][(threadIdx.x / 9) * 16];
      const int ra = kSlotA[ky], rb = kSlotB[ky], ca = kSlotA[kx], cb = kSlotB[kx];
      const float t0 = __fadd_rn(tap16(d, ra, ca), tap16(d, rb, ca));
      const float t1 = __fadd_rn(tap16(d, ra, cb), tap16(d, rb, cb));
      dw[pair * 9 + ky * 3 + kx] = __fadd_rn(t0, t1);
    }
  }
}

template <typename T>
int launch(const DwArgs& a, float* dw, float* db, int blocks, int oblocks, cudaStream_t st) {
  const size_t ring = sizeof(float) * kStages * static_cast<size_t>(a.stage_floats);
  const size_t reduce = sizeof(float) * kVals * kRedCols;
  const size_t smem = (ring > reduce ? ring : reduce) + sizeof(float) * (2 * kSS + kTO * kMaxTilesO);
  const auto kernel = upconv_dw_f32_kernel<T>;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const int threads = (a.slots * a.tiles_o * a.tiles_c * 2 + 31) / 32 * 32;
  kernel<<<dim3(blocks, a.cblocks * oblocks), threads, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  const long long pairs = static_cast<long long>(a.Co) * a.C;
  const int pair_blocks = static_cast<int>((pairs + kPairs - 1) / kPairs);
  const int db_blocks = (a.Co + kRedEntries - 1) / kRedEntries;
  upconv_dw_f32_reduce<<<pair_blocks + db_blocks, kRedEntries * kRedSegs, 0, st>>>(
      a.part, dw, db, blocks, pairs, a.Co, pair_blocks);
  return itg::last_error();
}

}  // namespace

// x (n, c, h, w) at half resolution, g (n, co, 2h, 2w): activation type
// (float32, or bfloat16 when bf16 != 0). scale/shift (c) float32. part
// (blocks, co c 16 + co) float32 scratch; dw (co, c, 3, 3) and db (co)
// float32, written (not accumulated). The plan (ops/kernels.py:
// upconv_dw_f32_plan): blocks, the persistent grid (any count from 1 gives a
// valid result); slots, pixel slots a block (a power of two, slots x the
// block's tiles <= 256); rows, half-res rows a chunk (slots <= 4 rows, so
// that every slot has a run; two stages of it must fit the card's shared
// memory). Two launches; returns the first CUDA error
// (cudaErrorInvalidValue for a shape or plan it does not take).
extern "C" int itg_upconv3x3_chw_dw(const void* x, const void* g, const void* scale,
                                    const void* shift, void* part, void* dw, void* db, int n,
                                    int c, int h, int width, int co, int relu, int zeros, int bf16,
                                    int blocks, int slots, int rows, void* stream) {
  if (n < 1 || n > 65535 || c < 1 || co < 1 || h < 1 || width < 1 || blocks < 1 ||
      static_cast<long long>(h) * width > 0x7fffffffLL || rows < 1 || slots < 1 ||
      (slots & (slots - 1)) != 0 || slots > kSegs * rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_c_all = (c + kTC - 1) / kTC, tiles_o_all = (co + kTO - 1) / kTO;
  const int tiles_c = tiles_c_all < kMaxTilesC ? tiles_c_all : kMaxTilesC;
  const int tiles_o = tiles_o_all < kMaxTilesO ? tiles_o_all : kMaxTilesO;
  if (slots * tiles_o * tiles_c * 2 > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int xrs = kTC * tiles_c * kXRS, grs = kTO * tiles_o * kGRS;
  const int rchunks = (h + rows - 1) / rows, cchunks = (width + kCols - 1) / kCols;
  DwArgs a{x, g, static_cast<const float*>(scale), static_cast<const float*>(shift),
           static_cast<float*>(part), n, c, h, width, co, relu, zeros, tiles_c, tiles_o,
           (tiles_c_all + kMaxTilesC - 1) / kMaxTilesC, slots, rows, rchunks, cchunks,
           static_cast<long long>(n) * rchunks * cchunks, xrs, grs,
           (rows + 2) * xrs + 2 * rows * grs};
  const int oblocks = (tiles_o_all + kMaxTilesO - 1) / kMaxTilesO;
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, w, b, blocks, oblocks, st);
  return launch<float>(a, w, b, blocks, oblocks, st);
}
