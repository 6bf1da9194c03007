// The SSM embed chain on channels-major arrays, forward and backward, for
// float32 activations (bfloat16 takes ssm_embed_tc.cu): the per-pixel
// gamma|beta of StochasticSpatialModulation,
//   y = conv3x3_valid(ReLU(conv3x3_valid(maps, w1) + b1), w2) + b2,
// maps (N, md, H + 4, W + 4), w1 (hid, md, 3, 3), w2 (Co, hid, 3, 3), the
// biases and y (N, Co, H, W) float32 (Co = 2C gamma|beta channels, hid = 128
// in the models).
//
// Replaces the TPU kernels of infinite_texture_gans_tpu/ops/pallas_ssm.py:
//   K15 forward  ssm_embed_fwd_call (:343, kernel _ssm_fwd_kernel :189);
//   K15 backward ssm_embed_bwd_call (:392, kernel _ssm_bwd_kernel :210),
//   which returns dW2, db2, dW1 and db1 (the maps' cotangent is zero by
//   contract and is not computed).
// The port has no lane padding, so there is no edge fill of pad columns and
// no adjoint of one.
//
// What bounds it on the H100: stage 2 (hid -> Co over 9 taps) is 2 * 9 * hid
// * Co FLOPs per output pixel against 4 * (md + Co) bytes in float32, some
// 1000 FLOPs per byte at the models' shapes: operations bound it, here the
// CUDA cores' float32 rate (these kernels round nothing but the output: the
// exactness route of step parity). FMA issue and shared-memory traffic bound
// them above that. What the design does about it:
// - The 128-channel hidden activation never reaches device memory (as in
//   the TPU kernel): every kernel recomputes it per tile, with its halo, from
//   the maps (9 * md FMAs a value, a few per cent of stage 2's work) with
//   `hidden_pre`'s arithmetic (the md x 9 fmaf in one order, then the bias),
//   so the backward's ReLU mask has exactly the forward's rounding.
// - Forward: a block computes a 16 x 32 output tile for up to 32 output
//   channels (8 a warp); each chunk of 8 hidden channels is computed once for
//   all of them into shared memory (18 x 34 with its halo), the next chunk
//   and its w2 slice (read from w2 as it lies, by cp.async) filling the
//   other half of a double buffer; a lane keeps 16 pixels of a row x 8
//   channels in registers, so 42 loaded words feed 384 FMAs. Each output
//   sums its (hidden channel, tap) products in one fixed order and then adds
//   the bias, whatever the tile, the channel blocking or the canvas
//   position: a raster sub-image and the one pass give the same bits for the
//   same maps.
// - Backward, three launches and no atomics. (1) d_act = conv3x3^T(g) on
//   the hidden grid (H + 2) x (W + 2), K6's transposed conv with the roles
//   of its channels taken by Co and hid: 16 pixels x 8 hidden channels a
//   lane, g and the flipped w2 by cp.async in a double buffer; masked by
//   hidden > 0 (the mask through hidden_pre's arithmetic on the tile's
//   staged maps) it is d_pre, whose products with the shifted maps and sum
//   are each tile's dW1 and db1 partials. (2) dW2 = g x hidden summed over
//   the pixels, K7's weight gradient: persistent blocks walk chunks of
//   output rows, compute each chunk's hidden activation once into shared
//   memory, and hold 4 output x 8 hidden channels x 3 taps a thread; db2
//   rides along; each block's slots are added in a fixed tree and written
//   as its partials. (3) The partials are summed in one fixed order, so
//   two calls give the same bits.
// The Mosaic-specific parts of the TPU kernels (128-lane padding and its edge
// fill, row-stacked partial matmuls, 8-row chunk reads) have no counterpart
// here.
#include "common.cuh"
#include "mma.cuh"  // cp.async groups

namespace {

using itg::cp_async16z;
using itg::cp_async4;
using itg::to_f32;

// The pre-activation hidden value at channel c, hidden row r and column j
// (0 <= r < H + 2, 0 <= j < W + 2) of one image's maps: the md x 9 products
// in one fixed order (map channel, then tap), then the bias. The forward
// applies it to its staged maps tile (its md = 1 path slides the same chain
// along a row); the backward's kernels repeat the same fmaf chain on the
// maps they stage.
template <typename T>
__device__ __forceinline__ float hidden_pre(const T* __restrict__ maps, const float* __restrict__ w1,
                                            const float* __restrict__ b1, int md, int Hm, int Wm,
                                            int c, int r, int j) {
  float acc = 0.f;
  for (int m = 0; m < md; ++m) {
    const T* p = maps + (static_cast<size_t>(m) * Hm + r) * Wm + j;
    const float* w = w1 + (static_cast<size_t>(c) * md + m) * 9;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) acc = fmaf(to_f32<T>(p[dy * Wm + dx]), w[dy * 3 + dx], acc);
    }
  }
  return __fadd_rn(acc, b1[c]);
}

// ---- forward: infinite_texture_gans_tpu/ops/pallas_ssm.py:343 ssm_embed_fwd_call
//
// A block owns a 16 x 32 output tile of one image and 8 output channels for
// each of its warps (1, 2 or 4: ops/ssm.py fwd_f32_plan), warp w the 8
// channels co0 + 8 w .., lane (tr, q) the 16 pixels 16 q .. of tile row tr.
// Hidden channels come in chunks of kKC. The block computes a chunk's
// hidden activation once for all its warps (18 rows of 36 floats a channel)
// from the maps tile, staged once, through hidden_pre's fmaf chain: a
// thread keeps one hidden channel and its 9 weights and takes items of 4
// cells of a row (a 3 x 6 window of the maps, one 16-byte store), so the
// items spread evenly over the block. The next chunk's hidden activation is
// computed and its w2 slice lands by cp.async (read from w2 as it lies) in
// the other half of a double buffer before this chunk's FMAs, one barrier
// a chunk. Per hidden channel and row tap a lane loads its 18 hidden values
// (four 16-byte loads and two words) and per tap its 8 weights (two 16-byte
// broadcasts) for 128 FMAs: 384 FMAs for 42 loaded words. Each output sums
// its (hidden channel, tap) products in that order, then adds b2, whatever
// the plan or the canvas position.
constexpr int kFR = 16;            // pixels of a lane, along a row
constexpr int kFTH = 16;           // rows of a tile: the 16 row lanes of a warp
constexpr int kFTW = 32;           // columns of a tile: 2 runs of kFR
constexpr int kFHR = kFTH + 2;     // hidden rows a tile reads
constexpr int kFHS = 36;           // floats a staged hidden row (34 cells), 9 16-byte units
constexpr int kFHC = kFHR * kFHS;  // floats a staged hidden channel
constexpr int kFMR = kFTH + 4;     // maps rows a tile reads
constexpr int kFMS = kFTW + 4;     // floats a staged maps row: its 36 cells
constexpr int kKC = 8;             // hidden channels a chunk
constexpr int kFCO = 8;            // output channels a warp
constexpr int kFMaxWarps = 4;

struct FwdArgs {
  const float* maps;  // (N, md, H + 4, W + 4)
  const float* w1;    // (hid, md, 3, 3)
  const float* b1;    // (hid)
  const float* w2;    // (Co, hid, 3, 3)
  const float* b2;    // (Co)
  float* y;           // (N, Co, H, W)
  int md, hid, H, W, Co, tiles_w, yvec;
};

// Floats between two rows (hidden channel, tap) of a staged w2 slice: the
// block's 8 x warps output channels, padded to 8 or 24 modulo 32, so the
// copies' lanes (8 output channels x 4 rows) write 32 banks.
__host__ __device__ constexpr int fwd_wrow(int warps) {
  return warps % 2 ? 8 * warps : 8 * warps + 8;
}

size_t fwd_smem(int md, int warps) {
  return sizeof(float) * (2 * kKC * kFHC + 2 * kKC * 9 * fwd_wrow(warps) + md * kFMR * kFMS + 4);
}

// Grid (tiles of an image, ceil(Co / (8 WARPS)), N), 32 WARPS threads.
// Dynamic shared memory (floats): two stages of a chunk's hidden activation
// (channel cc, row r, column k at cc kFHC + r kFHS + k: hidden row ty0 + r,
// column tx0 + k), two stages of its w2 (row 9 cc + tap, column k at (9 cc +
// tap) wrow + k: w2[co0 + k, c0 + cc, tap]), then the maps tile (md x kFMR
// rows of kFMS: maps row ty0 + r, column tx0 + k).
template <int WARPS>
__global__ void __launch_bounds__(32 * kFMaxWarps, 2) ssm_fwd_f32_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int nthr = 32 * WARPS, wrow = fwd_wrow(WARPS), wstage = kKC * 9 * wrow;
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / a.tiles_w) * kFTH, tx0 = (blockIdx.x % a.tiles_w) * kFTW;
  const int co0 = blockIdx.y * kFCO * WARPS;
  const int H = a.H, W = a.W, md = a.md, hid = a.hid;
  const int Hm = H + 4, Wm = W + 4;
  float* s_h = smem;
  float* s_w = s_h + 2 * kKC * kFHC;
  float* s_m = s_w + 2 * wstage;

  const float* mn = a.maps + static_cast<size_t>(n) * md * Hm * Wm;
  for (int i = tid; i < md * kFMR * kFMS; i += nthr) {
    const int m = i / (kFMR * kFMS), r = ty0 + (i / kFMS) % kFMR, k = tx0 + i % kFMS;
    const bool ok = r < Hm && k < Wm;
    cp_async4(s_m + i, mn + (ok ? (static_cast<size_t>(m) * Hm + r) * Wm + k : 0), ok);
  }
  // the w2 slice of hidden channels c0 .. c0 + kKC - 1 into stage s (zero
  // past Co and hid): thread t copies column 8 (t / 32) + t % 8, rows (t /
  // 8) % 4 + 4 i, so a warp's copies are 8 consecutive columns x 4 rows
  constexpr int nrow = kKC * 9;
  const int wk = 8 * (tid / 32) + tid % 8, wo = co0 + wk;
  auto stage_w = [&](int c0, float* s) {
    const int rows = wo < a.Co ? min(nrow, (hid - c0) * 9) : 0;
    const float* src = a.w2 + (static_cast<size_t>(wo < a.Co ? wo : 0) * hid + c0) * 9;
#pragma unroll 6
    for (int r = (tid / 8) % 4; r < nrow; r += 4) {
      cp_async4(s + r * wrow + wk, r < rows ? src + r : a.w2, r < rows);
    }
  };
  // the hidden activation ReLU(hidden_pre) of channels c0 .. c0 + kKC - 1
  // into stage s (zero past hid), each cell summed in hidden_pre's order
  // (map channel, tap), then the bias. A thread keeps one channel (nthr is
  // a multiple of kKC) and takes items of 4 cells of a row: for md = 1 a 3 x
  // 6 window of the maps tile gives 4 cells, stored as one 16-byte vector
  // (cells 34 and 35 of a row are never read)
  constexpr int quads = (kFTW + 4) / 4;
  auto hidden = [&](int c0, float* s) {
    const int cc = tid % kKC, c = c0 + cc;
    float* sc = s + cc * kFHC;
    if (c >= hid) {
      for (int it = tid / kKC; it < kFHR * quads; it += nthr / kKC) {
        *reinterpret_cast<float4*>(sc + (it / quads) * kFHS + 4 * (it % quads)) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
    if (md == 1) {
      const float* w = a.w1 + c * 9;
      float wv[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) wv[t] = __ldg(w + t);
      const float bias = __ldg(a.b1 + c);
      for (int it = tid / kKC; it < kFHR * quads; it += nthr / kKC) {
        const int rr = it / quads, k0 = 4 * (it % quads);
        float out[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* mr = s_m + (rr + dy) * kFMS + k0;
          const float4 f0 = *reinterpret_cast<const float4*>(mr);
          const float2 f1 = *reinterpret_cast<const float2*>(mr + 4);
          const float win[6] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int e = 0; e < 4; ++e) out[e] = fmaf(win[e + dx], wv[dy * 3 + dx], out[e]);
          }
        }
        *reinterpret_cast<float4*>(sc + rr * kFHS + k0) =
            make_float4(fmaxf(__fadd_rn(out[0], bias), 0.f), fmaxf(__fadd_rn(out[1], bias), 0.f),
                        fmaxf(__fadd_rn(out[2], bias), 0.f), fmaxf(__fadd_rn(out[3], bias), 0.f));
      }
      return;
    }
    for (int it = tid / kKC; it < kFHR * (kFTW + 2); it += nthr / kKC) {
      const int rr = it / (kFTW + 2), k = it % (kFTW + 2);
      sc[rr * kFHS + k] = fmaxf(hidden_pre(s_m, a.w1, a.b1, md, kFMR, kFMS, c, rr, k), 0.f);
    }
  };

  const int grp = tid / 32, lane = tid % 32;
  const int tr = lane / 2, q = lane % 2;
  const bool active = co0 + kFCO * grp < a.Co;  // the same for the whole warp
  float acc[kFR][kFCO];
#pragma unroll
  for (int p = 0; p < kFR; ++p) {
#pragma unroll
    for (int c = 0; c < kFCO; ++c) acc[p][c] = 0.f;
  }

  stage_w(0, s_w);
  itg::cp_async_commit();
  itg::cp_async_wait_all();
  __syncthreads();  // the maps tile and chunk 0's w2 are in
  hidden(0, s_h);
  __syncthreads();
  const int chunks = (hid + kKC - 1) / kKC;
  for (int k = 0; k < chunks; ++k) {
    const int cur = k & 1;
    if (k + 1 < chunks) {  // the other stages were read before the last barrier
      stage_w((k + 1) * kKC, s_w + (cur ^ 1) * wstage);
      itg::cp_async_commit();
      hidden((k + 1) * kKC, s_h + (cur ^ 1) * kKC * kFHC);
    }
    if (active) {
      const float* hs = s_h + cur * kKC * kFHC + tr * kFHS + kFR * q;
      const float* ws = s_w + cur * wstage + kFCO * grp;
#pragma unroll 1
      for (int cc = 0; cc < kKC; ++cc) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // pixel p at tap dx reads hidden column 16 q + p + dx: v[p + dx]
          const float* row = hs + cc * kFHC + dy * kFHS;
          float v[kFR + 2];
#pragma unroll
          for (int e = 0; e < kFR; e += 4) {
            const float4 f = *reinterpret_cast<const float4*>(row + e);
            v[e] = f.x, v[e + 1] = f.y, v[e + 2] = f.z, v[e + 3] = f.w;
          }
          v[kFR] = row[kFR];
          v[kFR + 1] = row[kFR + 1];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float* wp = ws + (cc * 9 + dy * 3 + dx) * wrow;
            const float4 wa = *reinterpret_cast<const float4*>(wp);
            const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
            const float wv[kFCO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int c = 0; c < kFCO; ++c) {
#pragma unroll
              for (int p = 0; p < kFR; ++p) acc[p][c] = fmaf(v[p + dx], wv[c], acc[p][c]);
            }
          }
        }
      }
    }
    itg::cp_async_wait_all();
    __syncthreads();  // chunk k + 1 is in; every thread is done with chunk k's stages
  }

  const int oy = ty0 + tr, ox0 = tx0 + kFR * q;
  if (!active || oy >= H || ox0 >= W) return;
#pragma unroll
  for (int c = 0; c < kFCO; ++c) {
    const int o = co0 + kFCO * grp + c;
    if (o >= a.Co) break;
    const float bias = __ldg(a.b2 + o);
    float* yp = a.y + ((static_cast<size_t>(n) * a.Co + o) * H + oy) * W + ox0;
    if (a.yvec && ox0 + kFR <= W) {
#pragma unroll
      for (int p = 0; p < kFR; p += 4) {
        *reinterpret_cast<float4*>(yp + p) =
            make_float4(__fadd_rn(acc[p][c], bias), __fadd_rn(acc[p + 1][c], bias),
                        __fadd_rn(acc[p + 2][c], bias), __fadd_rn(acc[p + 3][c], bias));
      }
    } else {
#pragma unroll
      for (int p = 0; p < kFR; ++p) {
        if (ox0 + p < W) yp[p] = __fadd_rn(acc[p][c], bias);
      }
    }
  }
}

// ---- backward: infinite_texture_gans_tpu/ops/pallas_ssm.py:392 ssm_embed_bwd_call
//
// (1) d_act, d_pre and the dW1 / db1 partials, on the (H + 2) x (W + 2)
// hidden grid: K6's transposed conv (conv3x3_dx_f32.cu) from the Co output
// channels to the hidden ones. A block owns a 16 x 32 tile of the hidden
// grid and kHB hidden channels, a warp (group) kCC of them; lane (tr, q)
// the 16 pixels 16 q .. of tile row tr. Output channels come in chunks of
// kOC: the next chunk's g tile (18 rows of 36 floats: columns tx0 - 4 ..
// tx0 + 31, rows ty0 - 2 .. ty0 + 15, zeros outside g) and its flipped w2
// land by cp.async in the other half of a double buffer while this chunk's
// FMAs run. Per output channel and row tap a lane loads its 18 g values
// (two words, four 16-byte loads) and per tap its 8 weights (two 16-byte
// broadcasts) for 128 FMAs: 384 FMAs for 42 loaded words. Then the ReLU
// mask, recomputed through the forward's arithmetic from the tile's maps
// (staged once, 18 rows of 36 floats a map channel), gives d_pre; its
// products with the shifted maps and its sum, each added over the lane's
// 16 pixels in order and over the warp by a fixed shuffle tree, are the
// tile's partials of dW1 and db1: part1 row n tiles + tile.
constexpr int kB1R = 16;              // pixels of a lane, along a row
constexpr int kB1TH = 16;             // rows of a tile: the 16 row lanes of a warp
constexpr int kB1TW = 32;             // columns of a tile: 2 runs of kB1R
constexpr int kB1GR = kB1TH + 2;      // staged g (and maps) rows
constexpr int kB1GS = 36;             // floats a staged row: 16-byte aligned, 9 units apart
constexpr int kB1GC = kB1GR * kB1GS;  // floats a staged channel
constexpr int kOC = 4;                // output channels a chunk
constexpr int kCC = 8;                // hidden channels a warp
constexpr int kHG = 4;                // warps a block
constexpr int kHB = kCC * kHG;        // hidden channels a block
constexpr int kB1Stage = kOC * kB1GC + kOC * 9 * kHB;

struct Bwd1Args {
  const float* maps;  // (N, md, H + 4, W + 4)
  const float* w1;    // (hid, md, 3, 3)
  const float* b1;    // (hid)
  const float* w2;    // (Co, hid, 3, 3)
  const float* g;     // (N, Co, H, W)
  float* part1;       // (N tiles, hid, 9 md + 1)
  int md, hid, H, W, Co, tiles_w, gvec;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, d));
  return v;
}

// Grid (tiles of an image's hidden grid, ceil(hid / kHB), N), 32 kHG
// threads. Dynamic shared memory (floats): two stages of [g: kOC channels of
// kB1GC][w: kOC x 9 taps x kHB], then the maps tile (md x kB1GC: row r,
// column k hold maps row ty0 + r, column tx0 + k), then w1 (kHB x 9 md) and
// b1 (kHB) of the block's channels (zero past hid).
__global__ void __launch_bounds__(32 * kHG, 3) ssm_dact_f32_kernel(const Bwd1Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / a.tiles_w) * kB1TH, tx0 = (blockIdx.x % a.tiles_w) * kB1TW;
  const int cb0 = blockIdx.y * kHB;
  const int H = a.H, W = a.W, Co = a.Co, md = a.md, hid = a.hid;
  const int Hh = H + 2, Wh = W + 2, Hm = H + 4, Wm = W + 4;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* gn = a.g + static_cast<size_t>(n) * Co * plane;
  float* s_m = smem + 2 * kB1Stage;
  float* s_w1 = s_m + md * kB1GC;
  float* s_b1 = s_w1 + kHB * 9 * md;

  // the maps tile, w1 and b1 (in the first chunk's copy group)
  const float* mn = a.maps + static_cast<size_t>(n) * md * Hm * Wm;
  for (int i = tid; i < md * kB1GC; i += 32 * kHG) {
    const int m = i / kB1GC, r = ty0 + (i % kB1GC) / kB1GS, k = tx0 + i % kB1GS;
    const bool ok = r < Hm && k < Wm;
    cp_async4(s_m + i, mn + (ok ? (static_cast<size_t>(m) * Hm + r) * Wm + k : 0), ok);
  }
  for (int i = tid; i < kHB * 9 * md; i += 32 * kHG) {
    const bool ok = cb0 + i / (9 * md) < hid;
    cp_async4(s_w1 + i, a.w1 + (ok ? static_cast<size_t>(cb0) * 9 * md + i : 0), ok);
  }
  for (int i = tid; i < kHB; i += 32 * kHG) {
    const bool ok = cb0 + i < hid;
    cp_async4(s_b1 + i, a.b1 + (ok ? cb0 + i : 0), ok);
  }

  // output channels o0 .. o0 + kOC - 1 of g (zeros past Co and outside g)
  // and their flipped weights into stage s: staged row r, column k hold g
  // row ty0 - 2 + r, column tx0 - 4 + k; the weights of tap t of output
  // channel oc at (9 oc + t) kHB: w2[o, c, 8 - t]
  auto stage = [&](int o0, float* s) {
    for (int t = tid; t < kB1GR * (kB1GS / 4); t += 32 * kHG) {
      const int r = t / (kB1GS / 4), u = t % (kB1GS / 4);
      const int gi = ty0 - 2 + r, j0 = tx0 - 4 + 4 * u;
      const bool row_ok = gi >= 0 && gi < H;
      // 16 bytes: four cells inside an aligned row, or four outside g
      const bool in4 = row_ok && j0 >= 0 && j0 + 4 <= W;
      const bool out4 = !row_ok || j0 + 4 <= 0 || j0 >= W;
      const size_t roff = row_ok ? static_cast<size_t>(gi) * W : 0;
#pragma unroll
      for (int oc = 0; oc < kOC; ++oc) {
        const int o = o0 + oc;
        const float* base = gn + (o < Co ? o * plane + roff : 0);
        float* dst = s + oc * kB1GC + r * kB1GS + 4 * u;
        if ((a.gvec && in4) || out4) {
          const bool ok = in4 && o < Co;
          cp_async16z(dst, base + (ok ? j0 : 0), ok);
          continue;
        }
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + e;
          const bool ok = row_ok && o < Co && j >= 0 && j < W;
          cp_async4(dst + e, base + (ok ? j : 0), ok);
        }
      }
    }
    float* s_w = s + kOC * kB1GC;
    for (int i = tid; i < kOC * 9 * kHB; i += 32 * kHG) {
      const int cl = i % kHB, k = i / kHB;  // k = 9 oc + tap
      const int o = o0 + k / 9, c = cb0 + cl;
      const bool ok = o < Co && c < hid;
      const float* src = ok ? a.w2 + (static_cast<size_t>(o) * hid + c) * 9 + (8 - k % 9) : a.w2;
      cp_async4(s_w + i, src, ok);
    }
  };

  const int grp = tid / 32, lane = tid % 32;
  const int tr = lane / 2, q = lane % 2;
  float acc[kB1R][kCC];
#pragma unroll
  for (int p = 0; p < kB1R; ++p) {
#pragma unroll
    for (int c = 0; c < kCC; ++c) acc[p][c] = 0.f;
  }

  stage(0, smem);
  itg::cp_async_commit();
  const int chunks = (Co + kOC - 1) / kOC;
  for (int k = 0; k < chunks; ++k) {
    const float* cur = smem + (k & 1) * kB1Stage;
    itg::cp_async_wait_all();
    __syncthreads();  // chunk k is in; every thread is done with the other stage
    if (k + 1 < chunks) stage((k + 1) * kOC, smem + ((k + 1) & 1) * kB1Stage);
    itg::cp_async_commit();
    const int noc = min(kOC, Co - k * kOC);
    const float* gs = cur + tr * kB1GS + kB1R * q + 2;
    const float* ws = cur + kOC * kB1GC + kCC * grp;
#pragma unroll 1
    for (int oc = 0; oc < noc; ++oc) {
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        // hidden row r reads g row r - dy at staged row tr + ty, dy = 2 - ty;
        // pixel p at tap tx reads g column j - dx, v[p + tx], dx = 2 - tx
        const float* row = gs + oc * kB1GC + ty * kB1GS;
        float v[kB1R + 2];
        v[0] = row[0];
        v[1] = row[1];
#pragma unroll
        for (int e = 0; e < kB1R; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(row + 2 + e);
          v[e + 2] = f.x, v[e + 3] = f.y, v[e + 4] = f.z, v[e + 5] = f.w;
        }
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const float* wp = ws + (oc * 9 + ty * 3 + tx) * kHB;
          const float4 wa = *reinterpret_cast<const float4*>(wp);
          const float4 wb = *reinterpret_cast<const float4*>(wp + 4);
          const float wv[kCC] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int c = 0; c < kCC; ++c) {
#pragma unroll
            for (int p = 0; p < kB1R; ++p) acc[p][c] = fmaf(v[p + tx], wv[c], acc[p][c]);
          }
        }
      }
    }
  }

  // -- d_pre = d_act where the forward's hidden value is > 0, and the
  // tile's dW1 / db1 partials
  const int r = ty0 + tr, j0 = tx0 + kB1R * q;
  const int valid = r < Hh ? min(kB1R, Wh - j0) : 0;
  const int per = 9 * md + 1;
  float* out = a.part1 + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * hid * per;
#pragma unroll
  for (int c = 0; c < kCC; ++c) {
    const int cl = kCC * grp + c, ch = cb0 + cl;
    if (ch >= hid) break;  // the same for the whole warp
    const float* w1c = s_w1 + cl * 9 * md;
    // the pre-activation of each pixel: the forward's hidden_pre, (m, dy,
    // dx) in order, then the bias; eight pixels at a time
#pragma unroll
    for (int h0 = 0; h0 < kB1R; h0 += 8) {
      float pre[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) pre[p] = 0.f;
      for (int m = 0; m < md; ++m) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* mr = s_m + m * kB1GC + (tr + dy) * kB1GS + kB1R * q + h0;
          const float4 f0 = *reinterpret_cast<const float4*>(mr);
          const float4 f1 = *reinterpret_cast<const float4*>(mr + 4);
          const float win[10] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, mr[8], mr[9]};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float wv = w1c[m * 9 + dy * 3 + dx];
#pragma unroll
            for (int p = 0; p < 8; ++p) pre[p] = fmaf(win[p + dx], wv, pre[p]);
          }
        }
      }
      const float bias = s_b1[cl];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (!(h0 + p < valid && __fadd_rn(pre[p], bias) > 0.f)) acc[h0 + p][c] = 0.f;
      }
    }
    // dW1[ch, m, dy, dx] = sum d_pre x maps[m, r + dy, j + dx]; db1[ch] = sum d_pre
    for (int m = 0; m < md; ++m) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* mr = s_m + m * kB1GC + (tr + dy) * kB1GS + kB1R * q;
        float s3[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int h0 = 0; h0 < kB1R; h0 += 8) {
          const float4 f0 = *reinterpret_cast<const float4*>(mr + h0);
          const float4 f1 = *reinterpret_cast<const float4*>(mr + h0 + 4);
          const float win[10] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, mr[h0 + 8],
                                 mr[h0 + 9]};
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
            for (int p = 0; p < 8; ++p) s3[dx] = fmaf(acc[h0 + p][c], win[p + dx], s3[dx]);
          }
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float v = warp_sum(s3[dx]);
          if (lane == 0) out[static_cast<size_t>(ch) * per + m * 9 + dy * 3 + dx] = v;
        }
      }
    }
    float sb = 0.f;
#pragma unroll
    for (int p = 0; p < kB1R; ++p) sb = __fadd_rn(sb, acc[p][c]);
    sb = warp_sum(sb);
    if (lane == 0) out[static_cast<size_t>(ch) * per + per - 1] = sb;
  }
}

// (2) dW2[o, c, dy, dx] = sum over the H x W output pixels of g[o, p] x
// hidden[c, p + (dy, dx)], db2[o] = sum g[o]: K7's weight gradient
// (conv3x3_dw_f32.cu) with the hidden activation in place of the post-norm
// input. Persistent blocks (the planner in ops/ssm.py, bwd_f32_plan, sizes
// the grid: s2 blocks for each block of up to kMaxTilesO x kTO output and
// kMaxTilesC x kTC hidden channels, the grid's second axis) walk a
// contiguous range of chunks, `rows` output rows x 32 columns of one image.
// A chunk's g rows (rows x 33 floats a channel) and maps tile (rows + 4 x
// 36 a map channel) land by cp.async in a double buffer; once in, the block
// computes the chunk's hidden activation (rows + 2 x 34 cells a channel, 35
// floats apart) from the maps through the forward's arithmetic, a thread
// per (channel, row) sliding its 3 x 3 window, then the FMAs run. A thread
// owns kTO output x kTC hidden channels at one row tap dy, with the 3
// column taps (96 sums), and walks runs of 8 pixels along a row with a
// 3-column window of the hidden activation in registers: a pixel costs 4 g
// and 8 hidden words for 96 FMAs. The pixel slots (a power of two) are added
// in a fixed tree through shared memory; each block writes its partials of
// dW2 and db2 (rows of part2 and partb2).
constexpr int kTO = 4;               // output channels of a thread's tile
constexpr int kTC = 8;               // hidden channels of a thread's tile
constexpr int kCols2 = 32;           // output columns of a chunk
constexpr int kSeg = 8;              // pixels of a run
constexpr int kSegs = kCols2 / kSeg;  // runs a chunk row
constexpr int kAW = kCols2 + 2;      // hidden cells a staged row
constexpr int kARS = kCols2 + 3;     // floats a staged hidden row (odd)
constexpr int kGRS2 = kCols2 + 1;    // floats a staged g row (odd)
constexpr int kMW = kCols2 + 4;      // maps cells a staged row
constexpr int kMaxTilesO = 13;       // a block's output channels: up to 52
constexpr int kMaxTilesC = 4;        // a block's hidden channels: up to 32
constexpr int kMaxThreads2 = 384;
constexpr int kVals2 = kTO * kTC * 3 + kTO;  // a thread's sums: its dW2 tile, then db2
constexpr int kRedCols2 = kMaxThreads2 / 2;
constexpr int kStages2 = 2;

struct Bwd2Args {
  const float* maps;  // (N, md, H + 4, W + 4)
  const float* w1;
  const float* b1;
  const float* g;     // (N, Co, H, W)
  float* part2;       // (gridDim.x, Co, hid, 9)
  float* partb2;      // (gridDim.x, Co)
  int N, md, hid, H, W, Co;
  int tiles_o, tiles_c, cblocks;  // a block's tiles; hidden-channel blocks (grid y = cblocks x oblocks)
  int slots, rows, rchunks, cchunks;
  long long chunks;
  int ars, grs;           // floats a staged row of the hidden activation, of g
  int stage_floats;       // (rows + 2) ars + rows grs + md (rows + 4) kMW
};

// The hidden (c, row) items of a chunk, then its copies: chunk q's g rows
// (channels o_lo .. o_hi - 1, kCols2 cells each) and maps tile into stage s.
__device__ __forceinline__ void stage_chunk2(const Bwd2Args& a, long long q, int o_lo, int o_hi,
                                             float* s) {
  const int per_image = a.rchunks * a.cchunks;
  const int n = static_cast<int>(q / per_image);
  const int rem = static_cast<int>(q % per_image);
  const int r0 = (rem / a.cchunks) * a.rows, c0 = (rem % a.cchunks) * kCols2;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const float* gn = a.g + static_cast<size_t>(n) * a.Co * plane;
  float* sg = s + (a.rows + 2) * a.ars;
  for (int u = threadIdx.x; u < a.rows * kCols2; u += blockDim.x) {
    const int i = r0 + u / kCols2, j = c0 + u % kCols2;
    const bool ok = i < a.H && j < a.W;
    const size_t off = ok ? static_cast<size_t>(i) * a.W + j : 0;
    float* dst = sg + (u / kCols2) * a.grs + u % kCols2;
    for (int o = o_lo; o < o_hi; ++o, dst += kGRS2) cp_async4(dst, gn + (ok ? o * plane + off : 0), ok);
  }
  const int Hm = a.H + 4, Wm = a.W + 4, mr = a.rows + 4;
  const float* mn = a.maps + static_cast<size_t>(n) * a.md * Hm * Wm;
  float* sm = sg + a.rows * a.grs;
  for (int u = threadIdx.x; u < a.md * mr * kMW; u += blockDim.x) {
    const int m = u / (mr * kMW), i = r0 + (u / kMW) % mr, j = c0 + u % kMW;
    const bool ok = i < Hm && j < Wm;
    cp_async4(sm + u, mn + (ok ? (static_cast<size_t>(m) * Hm + i) * Wm + j : 0), ok);
  }
}

// The chunk's hidden activation ReLU(hidden_pre) into stage s: channel c -
// c_lo of staged row rr (hidden row r0 + rr) at rr ars + (c - c_lo) kARS,
// its kAW cells; zero for channels past hid. A thread per (channel, row),
// each cell summed in the forward's order (map channel, tap), then the bias.
__device__ __forceinline__ void hidden_chunk(const Bwd2Args& a, int c_lo, int nc, float* s) {
  const float* sm = s + (a.rows + 2) * a.ars + a.rows * a.grs;
  const int mr = a.rows + 4;
  for (int it = threadIdx.x; it < kTC * a.tiles_c * (a.rows + 2); it += blockDim.x) {
    const int cl = it % (kTC * a.tiles_c), rr = it / (kTC * a.tiles_c);
    float* dst = s + rr * a.ars + cl * kARS;
    if (cl >= nc) {
      for (int k = 0; k < kAW; ++k) dst[k] = 0.f;
      continue;
    }
    const float* w = a.w1 + static_cast<size_t>(c_lo + cl) * 9 * a.md;
    const float bias = __ldg(a.b1 + c_lo + cl);
    if (a.md == 1) {  // one map channel: the 3 x 3 window slides along the row
      float wv[9], win[3][3];
#pragma unroll
      for (int t = 0; t < 9; ++t) wv[t] = __ldg(w + t);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        win[dy][0] = sm[(rr + dy) * kMW];
        win[dy][1] = sm[(rr + dy) * kMW + 1];
      }
      for (int k = 0; k < kAW; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][2] = sm[(rr + dy) * kMW + k + 2];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) acc = fmaf(win[dy][dx], wv[dy * 3 + dx], acc);
        }
        dst[k] = fmaxf(__fadd_rn(acc, bias), 0.f);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          win[dy][0] = win[dy][1];
          win[dy][1] = win[dy][2];
        }
      }
      continue;
    }
    for (int k = 0; k < kAW; ++k) {
      float acc = 0.f;
      for (int m = 0; m < a.md; ++m) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            acc = fmaf(sm[(m * mr + rr + dy) * kMW + k + dx], __ldg(w + m * 9 + dy * 3 + dx), acc);
          }
        }
      }
      dst[k] = fmaxf(__fadd_rn(acc, bias), 0.f);
    }
  }
}

// Grid (blocks, cblocks x oblocks), blockDim.x threads (<= kMaxThreads2);
// dynamic shared memory: kStages2 stages of stage_floats, or the
// reduction's kVals2 x kRedCols2 floats if larger. Block (b, cb) takes
// chunks [b chunks / B, (b + 1) chunks / B) for its channel block; thread
// tid is tile t = tid % T (output tile to, hidden tile tc, row tap dy) of
// pixel slot tid / T.
__global__ void __launch_bounds__(kMaxThreads2, 1) ssm_dw2_f32_kernel(const Bwd2Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int c_lo = (blockIdx.y % a.cblocks) * kTC * kMaxTilesC;
  const int o_lo = (blockIdx.y / a.cblocks) * kTO * kMaxTilesO;
  const int c_hi = min(a.hid, c_lo + kTC * a.tiles_c), o_hi = min(a.Co, o_lo + kTO * a.tiles_o);
  const long long q0 = a.chunks * blockIdx.x / gridDim.x;
  const long long q1 = a.chunks * (blockIdx.x + 1) / gridDim.x;
  const int count = static_cast<int>(q1 - q0);

  for (int i = 0; i < kStages2 - 1; ++i) {
    if (i < count) stage_chunk2(a, q0 + i, o_lo, o_hi, smem + i * a.stage_floats);
    itg::cp_async_commit();
  }

  const int T_ = a.tiles_o * a.tiles_c * 3;
  const int S = a.slots;
  const int t = tid % T_, slot = tid / T_;
  const bool active = slot < S;
  const int to = t % a.tiles_o, tc = (t / a.tiles_o) % a.tiles_c, dy = t / (a.tiles_o * a.tiles_c);
  const int aoff = dy * a.ars + kTC * tc * kARS;
  const int goff = (a.rows + 2) * a.ars + kTO * to * kGRS2;
  const int per_image = a.rchunks * a.cchunks;
  float acc[kTO][kTC][3], db[kTO];
#pragma unroll
  for (int m = 0; m < kTO; ++m) {
    db[m] = 0.f;
#pragma unroll
    for (int k = 0; k < kTC; ++k) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) acc[m][k][dx] = 0.f;
    }
  }

  for (int k = 0; k < count; ++k) {
    float* cur = smem + (k % kStages2) * a.stage_floats;
    itg::cp_async_wait_group<kStages2 - 2>();
    __syncthreads();  // chunk k is in; every thread is done with the stage refilled below
    hidden_chunk(a, c_lo, c_hi - c_lo, cur);
    __syncthreads();  // the hidden activation is in
    if (k + kStages2 - 1 < count) {
      stage_chunk2(a, q0 + k + kStages2 - 1, o_lo, o_hi,
                   smem + ((k + kStages2 - 1) % kStages2) * a.stage_floats);
    }
    itg::cp_async_commit();
    if (!active) continue;
    const int rem = static_cast<int>((q0 + k) % per_image);
    const int r0 = (rem / a.cchunks) * a.rows, c0 = (rem % a.cchunks) * kCols2;
    const float* sa = cur + aoff;
    const float* sg = cur + goff;
#pragma unroll 1
    for (int run = slot; run < a.rows * kSegs; run += S) {
      const int r = run / kSegs, cs = (run % kSegs) * kSeg;
      if (r0 + r >= a.H || c0 + cs >= a.W) continue;  // g is zero there
      const float* xa = sa + r * a.ars + cs;  // hidden row r + dy, column cs + dx at dx
      const float* ga = sg + r * a.grs + cs;
      float a0[kTC], a1[kTC];
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        a0[c] = xa[c * kARS];
        a1[c] = xa[c * kARS + 1];
      }
#pragma unroll
      for (int p = 0; p < kSeg; ++p) {
        float a2[kTC], gv[kTO];
#pragma unroll
        for (int c = 0; c < kTC; ++c) a2[c] = xa[c * kARS + p + 2];
#pragma unroll
        for (int m = 0; m < kTO; ++m) gv[m] = ga[m * kGRS2 + p];
#pragma unroll
        for (int m = 0; m < kTO; ++m) {
#pragma unroll
          for (int c = 0; c < kTC; ++c) {
            acc[m][c][0] = fmaf(gv[m], a0[c], acc[m][c][0]);
            acc[m][c][1] = fmaf(gv[m], a1[c], acc[m][c][1]);
            acc[m][c][2] = fmaf(gv[m], a2[c], acc[m][c][2]);
          }
          db[m] = __fadd_rn(db[m], gv[m]);
        }
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          a0[c] = a1[c];
          a1[c] = a2[c];
        }
      }
    }
  }
  itg::cp_async_wait_all();

  // -- the block's sums: the pixel slots added in a fixed tree (slot s +
  // half onto slot s), entry e of thread w of a level at red[e kRedCols2 + w]
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
          for (int dx = 0; dx < 3; ++dx) red[((i * kTC + j) * 3 + dx) * kRedCols2 + w] = acc[i][j][dx];
        }
        red[(kVals2 - kTO + i) * kRedCols2 + w] = db[i];
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
          for (int dx = 0; dx < 3; ++dx) {
            acc[i][j][dx] = __fadd_rn(acc[i][j][dx], red[((i * kTC + j) * 3 + dx) * kRedCols2 + w]);
          }
        }
        db[i] = __fadd_rn(db[i], red[(kVals2 - kTO + i) * kRedCols2 + w]);
      }
    }
    m = half;
  }
  if (active && slot == 0) {
    float* out = a.part2 + static_cast<size_t>(blockIdx.x) * a.Co * a.hid * 9;
#pragma unroll
    for (int i = 0; i < kTO; ++i) {
      const int o = o_lo + kTO * to + i;
      if (o >= o_hi) break;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = c_lo + kTC * tc + j;
        if (c < c_hi) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            out[(static_cast<size_t>(o) * a.hid + c) * 9 + dy * 3 + dx] = acc[i][j][dx];
          }
        }
      }
      if (c_lo == 0 && tc == 0 && dy == 0) a.partb2[static_cast<size_t>(blockIdx.x) * a.Co + o] = db[i];
    }
  }
}

// (3) The partials summed in one fixed order: dW2 (n2 entries of s2
// rows), db2 (nb2 entries of s2 rows), then dW1 | db1 (hid per entries of
// s1 rows; entry (c, k) goes to dW1[c][k] for k < per - 1, else db1[c]).
__global__ void ssm_f32_reduce_kernel(const float* __restrict__ p2, const float* __restrict__ pb2,
                                      const float* __restrict__ p1, float* __restrict__ dw2,
                                      float* __restrict__ db2, float* __restrict__ dw1,
                                      float* __restrict__ db1, int s2, int s1, int n2, int nb2,
                                      int hid, int per) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  const float* p;
  int count, rows;
  float* dst;
  if (e < n2) {
    p = p2, count = n2, rows = s2, dst = dw2 + e;
  } else if ((e -= n2) < nb2) {
    p = pb2, count = nb2, rows = s2, dst = db2 + e;
  } else if ((e -= nb2) < hid * per) {
    const int c = e / per, k = e % per;
    p = p1, count = hid * per, rows = s1;
    dst = k < per - 1 ? dw1 + c * (per - 1) + k : db1 + c;
  } else {
    return;
  }
  float v = 0.f;
#pragma unroll 8
  for (int s = 0; s < rows; ++s) v = __fadd_rn(v, p[static_cast<size_t>(s) * count + e]);
  *dst = v;
}

size_t bwd1_smem(int md) {
  return sizeof(float) * (2 * kB1Stage + md * kB1GC + kHB * 9 * md + kHB);
}

int dispatch_bwd(const float* maps, const float* w1, const float* b1, const float* w2,
                 const float* g, float* part1, float* part2, float* partb2, float* dw2,
                 float* db2, float* dw1, float* db1, int n, int md, int hid, int h, int w, int co,
                 int s2, int rows2, cudaStream_t st) {
  // (1): one block per (hidden tile, 32 hidden channels, image)
  const size_t smem1 = bwd1_smem(md);
  if (cudaError_t e = cudaFuncSetAttribute(ssm_dact_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem1))) {
    return static_cast<int>(e);
  }
  const int tiles_w = (w + 2 + kB1TW - 1) / kB1TW, tiles_h = (h + 2 + kB1TH - 1) / kB1TH;
  const bool gvec = (reinterpret_cast<uintptr_t>(g) & 15) == 0 && w % 4 == 0;
  const Bwd1Args a1{maps, w1, b1, w2, g, part1, md, hid, h, w, co, tiles_w, gvec};
  ssm_dact_f32_kernel<<<dim3(tiles_h * tiles_w, (hid + kHB - 1) / kHB, n), 32 * kHG, smem1, st>>>(
      a1);
  if (int rc = itg::last_error()) return rc;
  // (2): s2 persistent blocks for each channel block
  const int tiles_o_all = (co + kTO - 1) / kTO, tiles_c_all = (hid + kTC - 1) / kTC;
  const int tiles_o = min(tiles_o_all, kMaxTilesO), tiles_c = min(tiles_c_all, kMaxTilesC);
  const int per_slot = tiles_o * tiles_c * 3;
  int slots = 1;
  while (2 * slots * per_slot <= kMaxThreads2 && 2 * slots <= kSegs * rows2) slots *= 2;
  const int cblocks = (tiles_c_all + kMaxTilesC - 1) / kMaxTilesC;
  const int oblocks = (tiles_o_all + kMaxTilesO - 1) / kMaxTilesO;
  const int rchunks = (h + rows2 - 1) / rows2, cchunks = (w + kCols2 - 1) / kCols2;
  const int ars = kTC * tiles_c * kARS, grs = kTO * tiles_o * kGRS2;
  const Bwd2Args a2{maps, w1, b1, g, part2, partb2, n, md, hid, h, w, co, tiles_o, tiles_c,
                    cblocks, slots, rows2, rchunks, cchunks,
                    static_cast<long long>(n) * rchunks * cchunks, ars, grs,
                    (rows2 + 2) * ars + rows2 * grs + md * (rows2 + 4) * kMW};
  const size_t ring = sizeof(float) * kStages2 * static_cast<size_t>(a2.stage_floats);
  const size_t red = sizeof(float) * kVals2 * kRedCols2;
  const size_t smem2 = ring > red ? ring : red;
  if (cudaError_t e = cudaFuncSetAttribute(ssm_dw2_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem2))) {
    return static_cast<int>(e);
  }
  const int threads = (slots * per_slot + 31) / 32 * 32;
  ssm_dw2_f32_kernel<<<dim3(s2, cblocks * oblocks), threads, smem2, st>>>(a2);
  if (int rc = itg::last_error()) return rc;
  // (3)
  const int per = 9 * md + 1;
  const int s1 = n * tiles_h * tiles_w;
  const int total = co * hid * 9 + co + hid * per;
  ssm_f32_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(part2, partb2, part1, dw2, db2, dw1,
                                                              db1, s2, s1, co * hid * 9, co, hid,
                                                              per);
  return itg::last_error();
}

template <int WARPS>
int launch_fwd(const float* maps, const float* w1, const float* b1, const float* w2,
               const float* b2, float* y, int n, int md, int hid, int h, int w, int co,
               cudaStream_t st) {
  const size_t smem = fwd_smem(md, WARPS);
  if (cudaError_t e = cudaFuncSetAttribute(ssm_fwd_f32_kernel<WARPS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  const int tiles_w = (w + kFTW - 1) / kFTW, tiles_h = (h + kFTH - 1) / kFTH;
  const bool yvec = (reinterpret_cast<uintptr_t>(y) & 15) == 0 && w % 4 == 0;
  const FwdArgs a{maps, w1, b1, w2, b2, y, md, hid, h, w, co, tiles_w, yvec};
  const int cblocks = (co + kFCO * WARPS - 1) / (kFCO * WARPS);
  ssm_fwd_f32_kernel<WARPS><<<dim3(tiles_h * tiles_w, cblocks, n), 32 * WARPS, smem, st>>>(a);
  return itg::last_error();
}

int dispatch_fwd(const float* maps, const float* w1, const float* b1, const float* w2,
                 const float* b2, float* y, int n, int md, int hid, int h, int w, int co,
                 int warps, cudaStream_t st) {
  switch (warps) {
    case 1: return launch_fwd<1>(maps, w1, b1, w2, b2, y, n, md, hid, h, w, co, st);
    case 2: return launch_fwd<2>(maps, w1, b1, w2, b2, y, n, md, hid, h, w, co, st);
    case 4: return launch_fwd<4>(maps, w1, b1, w2, b2, y, n, md, hid, h, w, co, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// maps (N, md, h + 4, w + 4), y (N, co, h, w), w1 (hid, md, 3, 3), b1 (hid),
// w2 (co, hid, 3, 3), b2 (co): float32. warps (1, 2 or 4: the block's
// 8-channel groups) from ops/ssm.py fwd_f32_plan; any gives the same bits. md
// is bounded by the shared memory (68 KB + 2.9 KB a map channel). Returns
// cudaGetLastError() after the launch.
extern "C" int itg_ssm_embed_fwd(const void* maps, const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* y, int n, int md, int hid, int h, int w,
                                 int co, int warps, void* stream) {
  if (n < 1 || md < 1 || hid < 1 || h < 1 || w < 1 || co < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_fwd(static_cast<const float*>(maps), static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(b2), static_cast<float*>(y), n, md, hid, h, w, co,
                      warps, static_cast<cudaStream_t>(stream));
}

// maps as the forward's, g (n, co, h, w), w1, b1 and w2 (co, hid, 3, 3):
// float32. part1 (n ceil((h + 2) / 16) ceil((w + 2) / 32), hid, 9 md + 1),
// part2 (s2, co, hid, 9) and partb2 (s2, co) float32 scratch; dw2 (co, hid,
// 3, 3), db2 (co), dw1 (hid, md, 3, 3), db1 (hid) float32, all written (no
// zeroing needed). s2 (the persistent blocks of each channel block of dW2)
// and rows2 (output rows a dW2 chunk): ops/ssm.py bwd_f32_plan (any s2 from
// 1 gives a valid result; two stages of rows2 rows must fit the card's
// shared memory). md is bounded by the first launch's shared memory (30 KB
// + 3.7 KB a map channel). Three launches; returns the first CUDA error.
extern "C" int itg_ssm_embed_bwd(const void* maps, const void* w1, const void* b1, const void* w2,
                                 const void* g, void* part1, void* part2, void* partb2, void* dw2,
                                 void* db2, void* dw1, void* db1, int n, int md, int hid, int h,
                                 int w, int co, int s2, int rows2, void* stream) {
  if (n < 1 || md < 1 || hid < 1 || h < 1 || w < 1 || co < 1 || s2 < 1 || rows2 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_bwd(static_cast<const float*>(maps), static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<const float*>(w2),
                      static_cast<const float*>(g), static_cast<float*>(part1),
                      static_cast<float*>(part2), static_cast<float*>(partb2),
                      static_cast<float*>(dw2), static_cast<float*>(db2), static_cast<float*>(dw1),
                      static_cast<float*>(db1), n, md, hid, h, w, co, s2, rows2,
                      static_cast<cudaStream_t>(stream));
}
