// The SSM embed chain K15 on the tensor cores, for bfloat16 activations:
//   y = conv3x3_valid(ReLU(conv3x3_valid(maps, w1) + b1), w2) + b2,
// maps (N, md, H + 4, W + 4) and y (N, Co, H, W) bfloat16, channels-major;
// w1 (hid, md, 3, 3), b1 and b2 float32; w2 packed by the wrapper into
// bfloat16 tiles (see the entry points).
//
// Replaces the TPU kernels of infinite_texture_gans_tpu/ops/pallas_ssm.py:
//   K15 forward  ssm_embed_fwd_call (:343, kernel _ssm_fwd_kernel :189);
//   K15 backward ssm_embed_bwd_call (:392, kernel _ssm_bwd_kernel :210):
//   dW2, db2, dW1 and db1 (the maps' cotangent is zero by contract).
// Float32 activations keep the CUDA-core kernels of ssm_embed_chw.cu.
//
// What bounds it on the H100: stage 2 (hid -> Co over 9 taps) does
// 2 * 9 * hid * Co FLOPs per output pixel against 2 * (md + Co) bytes, some
// 2000 FLOPs per byte at the models' shapes, so operations bound it, on the
// tensor cores (989 bf16 TFLOP/s); stage 1 (md -> hid) is about 1% of the
// FLOPs but runs on the CUDA cores. Every large GEMM here is an implicit
// GEMM on Hopper's warpgroup wgmma (bf16 operands, float32 sums): A from
// registers, filled by ldmatrix with one row address per lane, so a tap's
// (dy, dx) shift is an address offset; B from shared memory through a
// descriptor (no swizzle). No im2col copy exists.
// - The 128-channel hidden activation never reaches device memory: every
//   kernel recomputes it for its tile and halo from the maps on the CUDA
//   cores through `hidden_pre_at` (float32 weights, one fixed order), rounds
//   the ReLU to bf16 as the reference does (pallas_ssm.py:143-147), and the
//   backward's ReLU mask is the same function's sign.
// - Forward: M = a TH x 16 output tile (a warp per tile row, TH / 4
//   warpgroups), N = the block's output channels (NT x 8, Co padded with
//   zero weights), K = (chunk of 32 hidden channels, tap, channel); A the
//   hidden tile, B the packed w2 chunk (cp.async while the CUDA cores
//   compute the chunk's hidden tile). Every output sums its products in that
//   one order and then adds the bias, wherever its tile lies: a window of
//   the maps gives the bits of the same window of the whole output.
// - Backward, three launches and no atomics. (1) d_act = conv3x3^T(g) on the
//   (H + 2) x (W + 2) hidden grid: M = an 8 x 16 hidden tile, N = 128 hidden
//   channels, K = (chunk of 16 output channels, tap, channel), A the g tile
//   with a zero halo of 2, B the flipped w2; masked by hidden > 0 and
//   rounded to bf16 (pallas_ssm.py:295) it is d_pre, which a second small
//   GEMM (mma.sync) reduces against the shifted maps and a column of ones
//   into dW1 and db1. The chunks of g and w2 are double-buffered. (2) dW2 =
//   g^T x im2col(hidden): M = output channels, A = g; N = (dx, 16 hidden
//   channels), B = three dx-shifted copies of the hidden tile, so that each
//   dy is a descriptor offset; K = the tile's pixels; db2 rides along; the
//   products run while the next tile is staged. Each block of (1) and (2)
//   walks a fixed share of the tiles, keeps its sums in registers and
//   shared memory, then writes one float32 partial. (3) The partials are
//   summed in a fixed order. So two calls give the same bits, as the TPU's
//   sequential grid did.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::cp_async16;
using itg::ldmatrix_x2;
using itg::ldmatrix_x4;
using itg::mma_bf16;
using itg::smem_addr;

constexpr int kKC = 32;       // hidden channels per chunk (two k16 steps)
constexpr int kKS = kKC + 8;  // bf16 row stride of a 32-channel row (80 B: conflict-free ldmatrix)

// forward: TH x 16 output pixels (TH 16, or 8 where 16 would leave SMs idle),
// hidden tile (TH + 2) x 18, maps tile (TH + 4) x 20, a warp per two rows
constexpr int kFW = 16;
constexpr int kFHW = kFW + 2;
constexpr int kFMW = kFW + 4;

// backward (1): 8 x 16 hidden pixels, g tile 10 x 18, maps tile 10 x 18
constexpr int kAH = 8, kAW = 16;
constexpr int kAGH = kAH + 2, kAGW = kAW + 2;
constexpr int kOC = 16;         // output channels per chunk (one k16 step)
constexpr int kOS = kOC + 8;    // bf16 row stride of a 16-channel row (48 B)
constexpr int kHB = 128;        // hidden channels per block
constexpr int kDS = kAH * kAW + 8;  // bf16 row stride of the staged d_pre (272 B)
constexpr int kAThreads = 256;  // 8 warps: 4 along the pixels x 2 along the channels

// backward (2): 8 x 16 output pixels, hidden tile 10 x 18, maps tile 12 x 20
constexpr int kWH = 8, kWW = 16;
constexpr int kWHH = kWH + 2, kWHW = kWW + 2;
constexpr int kWMH = kWH + 4, kWMW = kWW + 4;
constexpr int kGS = kWH * kWW + 8;  // bf16 row stride of the staged g (272 B)
constexpr int kWThreads = 576;      // 18 warps: a tap each, in two halves of the channels

// The pre-activation hidden value at one pixel: map_at(k, dy, dx) gives the
// maps at the pixel's tap (dy, dx) of map channel k, w_at(9 k + 3 dy + dx)
// the channel's float32 weight. The products in one fixed order (map
// channel, then tap), then the bias. Every kernel of this file takes its
// hidden values, and the mask, from here.
template <typename MapAt, typename WAt>
__device__ __forceinline__ float hidden_pre_at(MapAt map_at, WAt w_at, float b, int md) {
  float acc = 0.f;
  for (int k = 0; k < md; ++k) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) acc = fmaf(map_at(k, dy, dx), w_at(k * 9 + dy * 3 + dx), acc);
    }
  }
  return __fadd_rn(acc, b);
}

// ... with `m` pointing at the maps tile's (row, column) of the pixel
// (plane: elements per map channel, stride: per row) and `w` at the
// channel's md x 9 weights, both in shared memory.
__device__ __forceinline__ float hidden_pre(const float* __restrict__ m, int plane, int stride,
                                            const float* __restrict__ w, float b, int md) {
  return hidden_pre_at([=](int k, int dy, int dx) { return m[k * plane + dy * stride + dx]; },
                       [=](int i) { return w[i]; }, b, md);
}

// s_m[k][r][j] = maps[k][r0 + r][c0 + j] as float32 (zero outside).
__device__ __forceinline__ void stage_maps(float* __restrict__ s_m, const bf16* __restrict__ mp,
                                           int md, int Hm, int Wm, int r0, int c0, int rows,
                                           int cols, int tid, int nthreads) {
  const int plane = rows * cols;
  for (int i = tid; i < md * plane; i += nthreads) {
    const int k = i / plane;
    const int r = r0 + (i % plane) / cols;
    const int j = c0 + (i % plane) % cols;
    s_m[i] = (r < Hm && j < Wm) ? __bfloat162float(mp[(static_cast<size_t>(k) * Hm + r) * Wm + j])
                                : 0.f;
  }
}

// The chunk's float32 stage-1 weights and biases: s_w1[cc][md * 9],
// s_b1[cc] for channels c0 + cc, cc < count (zero past hid).
__device__ __forceinline__ void stage_w1(float* __restrict__ s_w1, float* __restrict__ s_b1,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ b1, int c0, int count, int hid,
                                         int md, int tid, int nthreads) {
  for (int i = tid; i < count * 9 * md; i += nthreads) {
    s_w1[i] = c0 + i / (9 * md) < hid ? w1[static_cast<size_t>(c0) * 9 * md + i] : 0.f;
  }
  for (int i = tid; i < count; i += nthreads) s_b1[i] = c0 + i < hid ? b1[c0 + i] : 0.f;
}

// bf16(ReLU(hidden)) of the chunk's channels cc and cc + 1 at every local
// hidden pixel of a rows x cols tile whose origin is hidden (r0, j0), zero
// outside the Hh x Wh hidden grid and for cc >= valid, handed packed to
// store(px, cc, pair), for the pixels px0 <= px < px1 (all by default), C
// channels. Thread tid takes the channel pair 2 (tid % (C / 2)) and every
// (nthreads / (C / 2))-th pixel (nthreads a multiple of C / 2); with one map
// channel the pair's weights and each pixel's 3 x 3 maps window sit in
// registers.
template <int C = kKC, typename Store>
__device__ __forceinline__ void stage_hidden(Store store, const float* __restrict__ s_m, int mplane,
                                             int mstride, const float* __restrict__ s_w1,
                                             const float* __restrict__ s_b1, int md, int rows,
                                             int cols, int r0, int j0, int Hh, int Wh, int valid,
                                             int tid, int nthreads, int px0 = 0, int px1 = -1) {
  if (px1 < 0) px1 = rows * cols;
  constexpr int kPairs = C / 2;
  const int cc = 2 * (tid % kPairs);
  float wa[9], wb[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    wa[k] = md == 1 ? s_w1[cc * 9 + k] : 0.f;
    wb[k] = md == 1 ? s_w1[(cc + 1) * 9 + k] : 0.f;
  }
  const float ba = s_b1[cc], bb = s_b1[cc + 1];
  for (int px = px0 + tid / kPairs; px < px1; px += nthreads / kPairs) {
    const int r = px / cols;
    const int j = px % cols;
    float v0 = 0.f, v1 = 0.f;
    if (r0 + r < Hh && j0 + j < Wh) {
      const float* m = s_m + r * mstride + j;
      if (md == 1) {
        float mv[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) mv[k] = m[(k / 3) * mstride + k % 3];
        auto at = [&](int, int dy, int dx) { return mv[dy * 3 + dx]; };
        if (cc < valid) v0 = fmaxf(hidden_pre_at(at, [&](int q) { return wa[q]; }, ba, 1), 0.f);
        if (cc + 1 < valid) v1 = fmaxf(hidden_pre_at(at, [&](int q) { return wb[q]; }, bb, 1), 0.f);
      } else {
        if (cc < valid) v0 = fmaxf(hidden_pre(m, mplane, mstride, s_w1 + cc * 9 * md, ba, md), 0.f);
        if (cc + 1 < valid) {
          v1 = fmaxf(hidden_pre(m, mplane, mstride, s_w1 + (cc + 1) * 9 * md, bb, md), 0.f);
        }
      }
    }
    store(px, cc, itg::pack_bf16x2(v0, v1));
  }
}

// B fragments of NT n8 tiles at one k16 step: rows n of `s` (row stride
// `stride` bf16, k contiguous from column k0) feed acc[mt][nt] += a[mt] x B.
template <int MT, int NT>
__device__ __forceinline__ void mma_row(float (&acc)[MT][NT][4], const uint32_t (&a)[MT][4],
                                        const bf16* s, int stride, int k0, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    uint32_t b[4];
    ldmatrix_x4(b, smem_addr(s + (16 * j + rr + 8 * (mi >> 1)) * stride + k0 + 8 * (mi & 1)));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * j], a[mt], b[0], b[1]);
      mma_bf16(acc[mt][2 * j + 1], a[mt], b[2], b[3]);
    }
  }
  if constexpr (NT % 2 == 1) {
    uint32_t b[2];
    ldmatrix_x2(b, smem_addr(s + (8 * (NT - 1) + rr) * stride + k0 + 8 * (mi & 1)));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b[0], b[1]);
  }
}

// A chunk of packed weights (`count` bf16, a multiple of 8) by cp.async.
__device__ __forceinline__ void copy_async(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                           int count, int tid, int nthreads) {
  for (int i = tid; i < count / 8; i += nthreads) cp_async16(dst + 8 * i, src + 8 * i);
}

// Forward. w2p (ncb, nch, 9, 2, NT, 2, 8, 8) bf16: w2 as wgmma's K-major B
// core matrices, w2[o, c, tap] at [o / NB][c / kKC][tap][(c % kKC) / 16]
// [(o % NB) / 8][(c % 16) / 8][o % 8][c % 8], zero past Co and hid. Warp w
// computes tile row w (16 pixels); the TH / 4 warpgroups each issue
// m64nNBk16 products, A (the hidden tile, shifted by the tap) from
// registers, double-buffered so that step s + 1's fragment loads while step
// s multiplies. Grid (output tiles, ncb, N); dynamic shared memory
// fwd_smem(NT, TH, md).
template <int NT, int TH>
__global__ void __launch_bounds__(TH * 32)
ssm_tc_fwd_kernel(const bf16* __restrict__ maps, const float* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2p,
                  const float* __restrict__ b2, bf16* __restrict__ y, int md, int hid, int H,
                  int W, int Co) {
  constexpr int NB = NT * 8;
  constexpr int kFThreads = TH * 32;
  constexpr int kFH = TH, kFHH = TH + 2, kFMH = TH + 4;
  constexpr int kStep = NB * 16;  // bf16 of B per k16 step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);                         // [9][2][kStep]
  bf16* s_h = s_w + 9 * NB * kKC;                                    // [TH + 2][18][kKS]
  float* s_m = reinterpret_cast<float*>(s_h + kFHH * kFHW * kKS);    // [md][TH + 4][20]
  float* s_w1 = s_m + md * kFMH * kFMW;                              // [kKC][9 md]
  float* s_b1 = s_w1 + kKC * 9 * md;                                 // [kKC]

  const int n = blockIdx.z;
  const int cb = blockIdx.y;
  const int tiles_w = (W + kFW - 1) / kFW;
  const int ty0 = (blockIdx.x / tiles_w) * kFH;
  const int tx0 = (blockIdx.x % tiles_w) * kFW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hm = H + 4, Wm = W + 4;
  const int nch = (hid + kKC - 1) / kKC;
  stage_maps(s_m, maps + static_cast<size_t>(n) * md * Hm * Wm, md, Hm, Wm, ty0, tx0, kFMH, kFMW,
             tid, kFThreads);

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  // A rows are pixels of one tile row: lane -> (column, k offset)
  const int a_x = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_k = 8 * (lane >> 4);

  for (int ch = 0; ch < nch; ++ch) {
    __syncthreads();  // the previous chunk's products have read s_w and s_h
    copy_async(s_w, w2p + static_cast<size_t>(cb * nch + ch) * 9 * NB * kKC, 9 * NB * kKC, tid,
               kFThreads);
    stage_w1(s_w1, s_b1, w1, b1, ch * kKC, kKC, hid, md, tid, kFThreads);
    __syncthreads();
    stage_hidden([&](int px, int cc, uint32_t v) {
                   *reinterpret_cast<uint32_t*>(s_h + px * kKS + cc) = v;
                 },
                 s_m, kFMH * kFMW, kFMW, s_w1, s_b1, md, kFHH, kFHW, ty0, tx0, H + 2, W + 2,
                 hid - ch * kKC, tid, kFThreads);
    itg::cp_async_wait_all();
    __syncthreads();
    uint32_t a[2][4];
#pragma unroll
    for (int s = 0; s < 9 * (kKC / 16); ++s) {  // (tap, k16 step)
      const int tap = s / (kKC / 16), ks = s % (kKC / 16);
      const int dy = tap / 3, dx = tap % 3;
      ldmatrix_x4(a[s & 1],
                  smem_addr(s_h + ((warp + dy) * kFHW + a_x + dx) * kKS + 16 * ks + a_k));
      itg::wgmma_fence();
      itg::Wgmma<NB>::run(acc, a[s & 1], itg::wgmma_desc(s_w + s * kStep, 128, 256));
      itg::wgmma_commit();
      itg::wgmma_wait<1>();
    }
    itg::wgmma_wait<0>();
  }
  itg::fence_regs(acc);

  const int gq = lane >> 2, t = lane & 3;
  const int oy = ty0 + warp;
  if (oy < H) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ox = tx0 + gq + 8 * (e >> 1);
        const int o = cb * NB + 8 * j + 2 * t + (e & 1);
        if (ox < W && o < Co) {
          y[((static_cast<size_t>(n) * Co + o) * H + oy) * W + ox] =
              __float2bfloat16_rn(__fadd_rn(acc[4 * j + e], b2[o]));
        }
      }
    }
  }
}

size_t fwd_smem(int nt, int th, int md) {
  return (9 * nt * 8 * kKC + (th + 2) * kFHW * kKS) * sizeof(bf16) +
         (md * (th + 4) * kFMW + kKC * 9 * md + kKC) * sizeof(float);
}

constexpr int kAG = kAGH * kAGW;                           // g tile pixels (180)
constexpr int kGL = (kOC * kAG + kAThreads - 1) / kAThreads;  // g values a thread loads per chunk
constexpr int kWChunk = 9 * kHB * kOC;                     // bf16 of one weight buffer

// This thread's share of g chunk oc for a tile at hidden (ty0, tx0):
// g[o][ty0 - 2 + i][tx0 - 2 + j] for the chunk's 16 channels, zero outside g.
__device__ __forceinline__ void load_g_chunk(bf16 (&v)[kGL], const bf16* __restrict__ gp, int oc,
                                             int Co, int H, int W, int ty0, int tx0, int tid) {
#pragma unroll
  for (int u = 0; u < kGL; ++u) {
    const int i = tid + u * kAThreads;
    const int o = oc * kOC + i / kAG;
    const int r = ty0 - 2 + (i % kAG) / kAGW;
    const int j = tx0 - 2 + (i % kAG) % kAGW;
    v[u] = (i < kOC * kAG && o < Co && r >= 0 && r < H && j >= 0 && j < W)
               ? gp[(static_cast<size_t>(o) * H + r) * W + j]
               : __float2bfloat16_rn(0.f);
  }
}

// ... stored pixel-major, s_g[px][o]: the A operand's rows are pixels.
__device__ __forceinline__ void store_g_chunk(bf16* __restrict__ s_g, const bf16 (&v)[kGL],
                                              int tid) {
#pragma unroll
  for (int u = 0; u < kGL; ++u) {
    const int i = tid + u * kAThreads;
    if (i < kOC * kAG) s_g[(i % kAG) * kOS + i / kAG] = v[u];
  }
}

// Backward (1). w2t (nhb, noc, 9, kHB / 8, 2, 8, 8) bf16: the flipped w2 as
// wgmma's B core matrices, w2[o, c, 2 - sy, 2 - sx] at [c / kHB][o / kOC]
// [sy * 3 + sx][(c % kHB) / 8][(o % kOC) / 8][c % 8][o % 8], zero past Co and
// hid. Grid (S1, nhb): block x walks the hidden-grid tiles x, x + S1, ... and
// writes part1[x][c][md * 9 + 1] (dW1's entries, then db1's) for its kHB
// channels. Two warpgroups, each 64 pixels (four tile rows) x 128 channels
// on wgmma; the chunks of g (through registers) and of the weights
// (cp.async) are double-buffered: chunk oc + 1 loads while chunk oc's
// products run. dW1 | db1 is a second small GEMM per tile (mma.sync): d_pre
// (kHB x pixels) times the shifted maps with a column of ones. Dynamic
// shared memory dact_smem(md).
__global__ void __launch_bounds__(kAThreads)
ssm_tc_dact_kernel(const bf16* __restrict__ maps, const float* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2t,
                   const bf16* __restrict__ g, float* __restrict__ part1, int n_img, int md,
                   int hid, int H, int W, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);          // [2][kWChunk]; later d_pre [kHB][kDS]
  bf16* s_dp = s_w;
  bf16* s_g = s_w + 2 * kWChunk;                      // [2][180][kOS]; later the maps operand
  bf16* s_mb = s_g;                                   // [16][kDS]
  const int per = 9 * md + 1;
  float* s_acc = reinterpret_cast<float*>(s_g + 2 * kAG * kOS);  // [kHB][per]
  float* s_m = s_acc + kHB * per;                     // [md][10][18]
  float* s_w1 = s_m + md * kAG;                       // [kHB][9 md]
  float* s_b1 = s_w1 + kHB * 9 * md;                  // [kHB]

  const int hb = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hh = H + 2, Wh = W + 2, Hm = H + 4, Wm = W + 4;
  const int tiles_w = (Wh + kAW - 1) / kAW;
  const int tiles_h = (Hh + kAH - 1) / kAH;
  const int n_tiles = n_img * tiles_h * tiles_w;
  const int noc = (Co + kOC - 1) / kOC;
  const bf16* wsrc = w2t + static_cast<size_t>(hb) * noc * kWChunk;
  stage_w1(s_w1, s_b1, w1, b1, hb * kHB, kHB, hid, md, tid, kAThreads);
  for (int i = tid; i < kHB * per; i += kAThreads) s_acc[i] = 0.f;
  const int a_x = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_k = 8 * (lane >> 4);
  const int gq = lane >> 2, t = lane & 3;
  bf16 gv[kGL];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / (tiles_h * tiles_w);
    const int ty0 = ((tile / tiles_w) % tiles_h) * kAH;
    const int tx0 = (tile % tiles_w) * kAW;
    const bf16* gp = g + static_cast<size_t>(n) * Co * H * W;
    __syncthreads();  // the last tile's epilogue is done with s_w, s_g, s_m
    copy_async(s_w, wsrc, kWChunk, tid, kAThreads);
    load_g_chunk(gv, gp, 0, Co, H, W, ty0, tx0, tid);
    store_g_chunk(s_g, gv, tid);
    stage_maps(s_m, maps + static_cast<size_t>(n) * md * Hm * Wm, md, Hm, Wm, ty0, tx0, kAGH, kAGW,
               tid, kAThreads);
    itg::cp_async_wait_all();
    __syncthreads();
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int oc = 0; oc < noc; ++oc) {
      const int cur = oc & 1;
      const bool more = oc + 1 < noc;
      if (more) {  // chunk oc + 1 into the other buffers while chunk oc multiplies
        copy_async(s_w + (cur ^ 1) * kWChunk, wsrc + static_cast<size_t>(oc + 1) * kWChunk, kWChunk,
                   tid, kAThreads);
        load_g_chunk(gv, gp, oc + 1, Co, H, W, ty0, tx0, tid);
      }
      const bf16* wc = s_w + cur * kWChunk;
      const bf16* gc = s_g + cur * kAG * kOS;
      // hidden (r, x) takes g at (r + sy - 2, x + sx - 2) with w2's tap (2 - sy,
      // 2 - sx); warp w's 16 pixels are tile row w. A double-buffered in
      // registers: the wgmma of tap k runs while tap k + 1's fragment loads.
      uint32_t a[2][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int sy = tap / 3, sx = tap % 3;
        ldmatrix_x4(a[tap & 1], smem_addr(gc + ((warp + sy) * kAGW + a_x + sx) * kOS + a_k));
        itg::wgmma_fence();
        itg::Wgmma<kHB>::run(acc, a[tap & 1], itg::wgmma_desc(wc + tap * kHB * kOC, 128, 256));
        itg::wgmma_commit();
        itg::wgmma_wait<1>();
      }
      itg::wgmma_wait<0>();
      itg::fence_regs(acc);
      if (more) store_g_chunk(s_g + (cur ^ 1) * kAG * kOS, gv, tid);
      itg::cp_async_wait_all();
      __syncthreads();
    }
    // d_pre = d_act where the recomputed hidden value is > 0, rounded to bf16.
    // With one map channel (the models' map_dim) the thread's two 3 x 3 maps
    // windows and each channel's weights sit in registers.
    const int r = warp;
    float mv[2][9];
    if (md == 1) {
#pragma unroll
      for (int hx = 0; hx < 2; ++hx) {
#pragma unroll
        for (int k = 0; k < 9; ++k) mv[hx][k] = s_m[(r + k / 3) * kAGW + gq + 8 * hx + k % 3];
      }
    }
#pragma unroll
    for (int j = 0; j < kHB / 8; ++j) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const int cl = 8 * j + 2 * t + par;
        float wv[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wv[k] = md == 1 ? s_w1[cl * 9 + k] : 0.f;
#pragma unroll
        for (int hx = 0; hx < 2; ++hx) {
          const int x = gq + 8 * hx;
          const float pre =
              md == 1 ? hidden_pre_at([&](int, int dy, int dx) { return mv[hx][dy * 3 + dx]; },
                                      [&](int i) { return wv[i]; }, s_b1[cl], 1)
                      : hidden_pre(s_m + r * kAGW + x, kAG, kAGW, s_w1 + cl * 9 * md, s_b1[cl], md);
          const bool live = hb * kHB + cl < hid && ty0 + r < Hh && tx0 + x < Wh && pre > 0.f;
          s_dp[cl * kDS + r * kAW + x] = __float2bfloat16_rn(live ? acc[4 * j + 2 * hx + par] : 0.f);
        }
      }
    }
    // dW1[c, k, dy, dx] and db1[c], 16 entries at a time: d_pre (rows c, k =
    // pixels) times s_mb[e][p] = maps[k][p + (dy, dx)] for e = 9k + 3dy + dx,
    // 1 for e = 9 md; warp w owns channels 16w .. 16w + 15
    for (int e0 = 0; e0 < per; e0 += 16) {
      __syncthreads();  // d_pre is staged; the last group's products have read s_mb
      for (int i = tid; i < 16 * kAH * kAW; i += kAThreads) {
        const int e = e0 + i / (kAH * kAW);
        const int px = i % (kAH * kAW);
        float v = 0.f;
        if (e < per - 1) {
          const int k = e / 9, dy = (e % 9) / 3, dx = e % 3;
          v = s_m[k * kAG + (px / kAW + dy) * kAGW + px % kAW + dx];
        } else if (e == per - 1) {
          v = 1.f;
        }
        s_mb[(i / (kAH * kAW)) * kDS + px] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      float acc1[1][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kAH * kAW / 16; ++ks) {
        uint32_t a1[1][4];
        ldmatrix_x4(a1[0], smem_addr(s_dp + (16 * warp + a_x) * kDS + 16 * ks + a_k));
        mma_row<1, 2>(acc1, a1, s_mb, kDS, 16 * ks, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 16 * warp + gq + 8 * (e >> 1);
          const int en = e0 + 8 * nt + 2 * t + (e & 1);
          if (en < per) s_acc[c * per + en] += acc1[0][nt][e];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kHB * per; i += kAThreads) {
    const int c = hb * kHB + i / per;
    if (c < hid) part1[(static_cast<size_t>(blockIdx.x) * hid + c) * per + i % per] = s_acc[i];
  }
}

size_t dact_smem(int md) {
  return (2 * kWChunk + 2 * kAGH * kAGW * kOS) * sizeof(bf16) +
         (kHB * (9 * md + 1) + md * kAGH * kAGW + kHB * 9 * md + kHB) * sizeof(float);
}

// g[o0 + o][ty0 + r][tx0 .. tx0 + 15] for o < rows into s_g[o][16 r + x],
// zero outside g and for o >= valid: whole 16-byte pieces by cp.async where
// they lie in g and g's rows are 16-byte aligned (W % 8 == 0), else element
// by element.
__device__ __forceinline__ void load_g_tile(bf16* __restrict__ s_g, const bf16* __restrict__ gp,
                                            int rows, int valid, int o0, int H, int W, int ty0,
                                            int tx0, int tid, int nthreads) {
  const bool aligned = W % 8 == 0;
  for (int i = tid; i < rows * kWH * 2; i += nthreads) {
    const int o = i / (kWH * 2);
    const int r = ty0 + (i % (kWH * 2)) / 2;
    const int x0 = 8 * (i % 2);
    bf16* dst = s_g + o * kGS + (i % (kWH * 2)) / 2 * kWW + x0;
    const bf16* src = gp + (static_cast<size_t>(o0 + o) * H + r) * W + tx0 + x0;
    if (o < valid && r < H && aligned && tx0 + x0 + 8 <= W) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        dst[x] = (o < valid && r < H && tx0 + x0 + x < W) ? src[x] : __float2bfloat16_rn(0.f);
      }
    }
  }
  itg::cp_async_commit();
}

constexpr int kWPX = kWHH * kWHW;  // hidden pixels of a dW2 tile (180)
constexpr int kWC = 16;            // hidden channels of a dW2 block

// Backward (2): dW2[o, c, tap] = sum over pixels p of g[o, p] * hidden[c, p + tap],
// db2[o] = sum of g[o]. On wgmma with M = output channels (64 per
// warpgroup, WG warpgroups), N = 48 = (dx, 16 hidden channels), K = the
// tile's pixels, one tile row per k16 step and one product per dy. A is g
// from registers (ldmatrix on s_g[o][p]); B is the hidden tile MN-major, in
// three copies shifted by dx (s_h[dx][c / 8][q][c % 8] = hidden[c][q + dx]),
// so a tap's shift is the descriptor's start: (r + dy) x 18 pixel rows of
// 16 bytes. Grid (hidden chunks of kWC, S2, output blocks of 64 WG), the
// chunks fastest so that the blocks of one share read g from L2 together:
// block (c, x) walks the output tiles x, x + S2, ... and writes
// part2[x][o][c][tap] (and partb2[x][o] from the first chunk). The products
// run asynchronously while the CUDA cores stage the next tile (its maps, g
// and hidden activation, into the other buffers), in two halves of four
// tile rows each; two blocks share an SM. Dynamic shared memory
// dw2_smem(WG, md).
template <int WG>
__global__ void __launch_bounds__(WG * 128, 2)
ssm_tc_dw2_kernel(const bf16* __restrict__ maps, const float* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ g,
                  float* __restrict__ part2, float* __restrict__ partb2, int n_img, int md,
                  int hid, int H, int W, int Co) {
  constexpr int OB = 64 * WG;
  constexpr int kThreads = 128 * WG;
  constexpr int kHBuf = 3 * kWC * kWPX;  // bf16 of one hidden buffer
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_h = reinterpret_cast<bf16*>(smem);                     // [2][3][kWC / 8][kWPX][8]
  bf16* s_g = s_h + 2 * kHBuf;                                   // [2][OB][kGS]
  float* s_m = reinterpret_cast<float*>(s_g + 2 * OB * kGS);     // [md][12][20]
  float* s_w1 = s_m + md * kWMH * kWMW;                          // [kWC][9 md]
  float* s_b1 = s_w1 + kWC * 9 * md;                             // [kWC]

  const int c0 = blockIdx.x * kWC;
  const int share = blockIdx.y, shares = gridDim.y;
  const int o0 = blockIdx.z * OB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hm = H + 4, Wm = W + 4;
  const int tiles_w = (W + kWW - 1) / kWW;
  const int tiles_h = (H + kWH - 1) / kWH;
  const int n_tiles = n_img * tiles_h * tiles_w;
  const int valid = Co - o0 < OB ? Co - o0 : OB;
  const bool sums_b = blockIdx.x == 0;
  stage_w1(s_w1, s_b1, w1, b1, c0, kWC, hid, md, tid, kThreads);

  float acc[3][24];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int i = 0; i < 24; ++i) acc[dy][i] = 0.f;
  }
  float accb = 0.f;
  // A rows are this warp's 16 output channels, k the tile row's 16 pixels
  const int a_o = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_k = 8 * (lane >> 4);
  // a tile's maps (s_m) and g (cp.async into gbuf), then its hidden
  // activation into hbuf in two halves around `between`
  auto stage_tile = [&](int tile, bf16* gbuf, bf16* hbuf, auto between) {
    const int n = tile / (tiles_h * tiles_w);
    const int ty0 = ((tile / tiles_w) % tiles_h) * kWH;
    const int tx0 = (tile % tiles_w) * kWW;
    load_g_tile(gbuf, g + static_cast<size_t>(n) * Co * H * W, OB, valid, o0, H, W, ty0, tx0, tid,
                kThreads);
    stage_maps(s_m, maps + static_cast<size_t>(n) * md * Hm * Wm, md, Hm, Wm, ty0, tx0, kWMH, kWMW,
               tid, kThreads);
    __syncthreads();
    auto store = [&](int px, int cc, uint32_t v) {
      for (int dx = 0; dx < 3 && dx <= px; ++dx) {
        *reinterpret_cast<uint32_t*>(hbuf + ((dx * (kWC / 8) + cc / 8) * kWPX + px - dx) * 8 +
                                     cc % 8) = v;
      }
    };
    stage_hidden<kWC>(store, s_m, kWMH * kWMW, kWMW, s_w1, s_b1, md, kWHH, kWHW, ty0, tx0, H + 2,
                      W + 2, hid - c0, tid, kThreads, 0, kWPX / 2);
    between();
    stage_hidden<kWC>(store, s_m, kWMH * kWMW, kWMW, s_w1, s_b1, md, kWHH, kWHW, ty0, tx0, H + 2,
                      W + 2, hid - c0, tid, kThreads, kWPX / 2, kWPX);
    itg::cp_async_wait_group<0>();
  };
  // this tile's products for tile rows r0 .. r0 + 3, issued and left running
  auto issue = [&](const bf16* gc, const bf16* hc, int r0) {
    uint32_t a[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ldmatrix_x4(a[r], smem_addr(gc + a_o * kGS + 16 * (r0 + r) + a_k));
    itg::wgmma_fence();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        itg::WgmmaT<48>::run(acc[dy], a[r],
                             itg::wgmma_desc(hc + (r0 + r + dy) * kWHW * 8, 128, kWPX * 16));
      }
    }
    itg::wgmma_commit();
  };

  if (share < n_tiles) {
    stage_tile(share, s_g, s_h, [] {});
    __syncthreads();
  }
  int it = 0;
  for (int tile = share; tile < n_tiles; tile += shares, ++it) {
    const int cur = it & 1;
    const bf16* gc = s_g + cur * OB * kGS;
    const bf16* hc = s_h + cur * kHBuf;
    issue(gc, hc, 0);
    if (sums_b) {  // two threads a channel, half a tile each, joined in one order
      const uint32_t* row = reinterpret_cast<const uint32_t*>(gc + (tid >> 1) * kGS) +
                            (tid & 1) * (kWH * kWW / 4);
      float s = 0.f;
      for (int q = 0; q < kWH * kWW / 4; ++q) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + q);
        s += __low2float(v);
        s += __high2float(v);
      }
      const float other = __shfl_xor_sync(0xffffffffu, s, 1);
      accb += (tid & 1) ? other + s : s + other;
    }
    // the second half's A registers replace the first's once those products end
    auto second = [&] {
      itg::wgmma_wait<0>();
      issue(gc, hc, 4);
    };
    if (tile + shares < n_tiles) {
      stage_tile(tile + shares, s_g + (cur ^ 1) * OB * kGS, s_h + (cur ^ 1) * kHBuf, second);
    } else {
      second();
    }
    itg::wgmma_wait<0>();
    __syncthreads();
  }
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) itg::fence_regs(acc[dy]);

  const int gq = lane >> 2, t = lane & 3;
  float* out = part2 + static_cast<size_t>(share) * Co * hid * 9;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ol = 16 * warp + gq + 8 * (e >> 1);
        const int c = c0 + 8 * (j % 2) + 2 * t + (e & 1);
        if (ol < valid && c < hid) {
          out[(static_cast<size_t>(o0 + ol) * hid + c) * 9 + 3 * dy + j / 2] = acc[dy][4 * j + e];
        }
      }
    }
  }
  if (sums_b && (tid & 1) == 0 && (tid >> 1) < valid) {
    partb2[static_cast<size_t>(share) * Co + o0 + (tid >> 1)] = accb;
  }
}

size_t dw2_smem(int wg, int md) {
  return (2 * 3 * kWC * kWPX + 2 * 64 * wg * kGS) * sizeof(bf16) +
         (md * kWMH * kWMW + kWC * 9 * md + kWC) * sizeof(float);
}

// Backward (3): the partials summed in share order. dW2 (n2 entries, s2
// shares), db2 (nb2 entries, s2 shares), then dW1 | db1 (hid * per entries,
// s1 shares; entry (c, k) goes to dW1[c][k] for k < per - 1, else db1[c]).
__global__ void ssm_tc_reduce_kernel(const float* __restrict__ p2, const float* __restrict__ pb2,
                                     const float* __restrict__ p1, float* __restrict__ dw2,
                                     float* __restrict__ db2, float* __restrict__ dw1,
                                     float* __restrict__ db1, int s2, int s1, int n2, int nb2,
                                     int hid, int per) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  const float* p;
  int count, shares;
  float* dst;
  if (e < n2) {
    p = p2, count = n2, shares = s2, dst = dw2 + e;
  } else if ((e -= n2) < nb2) {
    p = pb2, count = nb2, shares = s2, dst = db2 + e;
  } else if ((e -= nb2) < hid * per) {
    const int c = e / per, k = e % per;
    p = p1, count = hid * per, shares = s1;
    dst = k < per - 1 ? dw1 + c * (per - 1) + k : db1 + c;
  } else {
    return;
  }
  float v = 0.f;
#pragma unroll 8
  for (int s = 0; s < shares; ++s) v += p[static_cast<size_t>(s) * count + e];
  *dst = v;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

template <int NT, int TH>
int launch_fwd_th(const bf16* maps, const float* w1, const float* b1, const bf16* w2p,
                  const float* b2, bf16* y, int n, int md, int hid, int h, int w, int co,
                  cudaStream_t stream) {
  const size_t smem = fwd_smem(NT, TH, md);
  if (int rc = set_smem(reinterpret_cast<const void*>(ssm_tc_fwd_kernel<NT, TH>), smem)) return rc;
  const int tiles = ((h + TH - 1) / TH) * ((w + kFW - 1) / kFW);
  const dim3 grid(tiles, (co + NT * 8 - 1) / (NT * 8), n);
  ssm_tc_fwd_kernel<NT, TH><<<grid, TH * 32, smem, stream>>>(maps, w1, b1, w2p, b2, y, md, hid,
                                                              h, w, co);
  return itg::last_error();
}

// 16-row tiles, or 8-row ones where 16-row tiles would give fewer blocks
// than SMs (the raster's 96^2 sub-images). Each output sums in the same
// order under either, so the choice changes no bit.
template <int NT>
int launch_fwd(const bf16* maps, const float* w1, const float* b1, const bf16* w2p,
               const float* b2, bf16* y, int n, int md, int hid, int h, int w, int co,
               cudaStream_t stream) {
  const long blocks = static_cast<long>((h + 15) / 16) * ((w + kFW - 1) / kFW) *
                      ((co + NT * 8 - 1) / (NT * 8)) * n;
  if (blocks < itg::sm_count()) {
    return launch_fwd_th<NT, 8>(maps, w1, b1, w2p, b2, y, n, md, hid, h, w, co, stream);
  }
  return launch_fwd_th<NT, 16>(maps, w1, b1, w2p, b2, y, n, md, hid, h, w, co, stream);
}

template <int WG>
int launch_dw2(const bf16* maps, const float* w1, const float* b1, const bf16* g, float* part2,
               float* partb2, int n, int md, int hid, int h, int w, int co, int s2,
               cudaStream_t stream) {
  const size_t smem = dw2_smem(WG, md);
  if (int rc = set_smem(reinterpret_cast<const void*>(ssm_tc_dw2_kernel<WG>), smem)) return rc;
  const dim3 grid((hid + kWC - 1) / kWC, s2, (co + 64 * WG - 1) / (64 * WG));
  ssm_tc_dw2_kernel<WG><<<grid, 128 * WG, smem, stream>>>(maps, w1, b1, g, part2, partb2, n, md,
                                                          hid, h, w, co);
  return itg::last_error();
}

}  // namespace

// maps (n, md, h + 4, w + 4) and y (n, co, h, w) bfloat16; w1 (hid, md, 3,
// 3), b1 (hid), b2 (co) float32; w2p as ssm_tc_fwd_kernel reads it, for
// output blocks of nt * 8 channels (nt 7 or 13). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another nt).
extern "C" int itg_ssm_embed_tc_fwd(const void* maps, const void* w1, const void* b1,
                                    const void* w2p, const void* b2, void* y, int n, int md,
                                    int hid, int h, int w, int co, int nt, void* stream) {
  const auto* m = static_cast<const bf16*>(maps);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* wp = static_cast<const bf16*>(w2p);
  const auto* b2f = static_cast<const float*>(b2);
  auto* yb = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 7: return launch_fwd<7>(m, w1f, b1f, wp, b2f, yb, n, md, hid, h, w, co, st);
    case 13: return launch_fwd<13>(m, w1f, b1f, wp, b2f, yb, n, md, hid, h, w, co, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// maps as the forward's, g (n, co, h, w) bfloat16; w1, b1 float32; w2t as
// ssm_tc_dact_kernel reads it. part1 (s1, hid, 9 md + 1), part2 (s2, co,
// hid, 9) and partb2 (s2, co) float32 scratch; dw2 (co, hid, 3, 3), db2
// (co), dw1 (hid, md, 3, 3), db1 (hid) float32, all written (no zeroing
// needed). dW2 runs one warpgroup per block for co <= 64, else two. Three
// launches; returns the first CUDA error.
extern "C" int itg_ssm_embed_tc_bwd(const void* maps, const void* w1, const void* b1,
                                    const void* w2t, const void* g, void* part1, void* part2,
                                    void* partb2, void* dw2, void* db2, void* dw1, void* db1,
                                    int n, int md, int hid, int h, int w, int co, int s1, int s2,
                                    void* stream) {
  const auto* m = static_cast<const bf16*>(maps);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* gb = static_cast<const bf16*>(g);
  auto* p1 = static_cast<float*>(part1);
  auto* p2 = static_cast<float*>(part2);
  auto* pb2 = static_cast<float*>(partb2);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem1 = dact_smem(md);
  if (int rc = set_smem(reinterpret_cast<const void*>(ssm_tc_dact_kernel), smem1)) return rc;
  ssm_tc_dact_kernel<<<dim3(s1, (hid + kHB - 1) / kHB), kAThreads, smem1, st>>>(
      m, w1f, b1f, static_cast<const bf16*>(w2t), gb, p1, n, md, hid, h, w, co);
  if (int rc = itg::last_error()) return rc;
  const int rc = co <= 64 ? launch_dw2<1>(m, w1f, b1f, gb, p2, pb2, n, md, hid, h, w, co, s2, st)
                          : launch_dw2<2>(m, w1f, b1f, gb, p2, pb2, n, md, hid, h, w, co, s2, st);
  if (rc) return rc;
  const int per = 9 * md + 1;
  const int total = co * hid * 9 + co + hid * per;
  ssm_tc_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      p2, pb2, p1, static_cast<float*>(dw2), static_cast<float*>(db2), static_cast<float*>(dw1),
      static_cast<float*>(db1), s2, s1, co * hid * 9, co, hid, per);
  return itg::last_error();
}
