// The generator tail's fused up-conv forward on the tensor cores, for
// bfloat16 activations: one kernel body serves
//   K9 _upconv3x3_fwd (infinite_texture_gans_tpu/ops/pallas_conv.py:1430,
//      pallas_call :1457, kernel _upconv_kernel :1366, wrapper
//      upconv3x3_chw_p :1804), with the optional per-channel sums of the
//      STORED y and y^2 (_acc_stats :1423); and
//   K14 _upconv3x3_fwd_halo (:1958, pallas_call :2019, kernel
//      _upconv_halo_kernel :1879, step chw_upconv_halo_step :2032), the
//      raster-engine form whose half-res top row (N, C, W + 2, corners
//      included) and left column (N, C, H) come post-norm from the halo
//      cache and are used as given.
// x (N, C, H, W) is raw at HALF resolution and y (N, Co, 2H, 2W) =
// conv3x3(pad1(up2(act(scale * x + shift)))) + b. Nearest-2x commutes with
// the fold and the ReLU, and the full-res border is the half-res one
// doubled, so each output phase (di, dj), y[2i + di, 2j + dj], is a 2 x 2
// convolution of the padded half-res post-norm slab A at rows i - 1 + di + r
// and columns j - 1 + dj + s (slots r, s in {0, 1}) with combined kernels
// (ops/kernels.py: _upconv_phase_weights). A is K2's padded input on the
// half-res grid (chw_fwd_tc.cuh: stage_tile): act(scale * x + shift) with
// no FMA contraction, rounded to bf16; its border the own edge (replicate)
// or zeros but for the cached top row and left column. The combined
// weights are formed in float32 and rounded to bf16, as the reference
// rounds them on this path (_pack_w_upconv(w).astype(x.dtype), :1819 and
// :2094); the bias (float32) is added to the float32 sum before y's one
// rounding to bf16. Float32 activations take the CUDA-core kernel of
// upconv_fwd_f32.cu.
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per half-res pixel
// against 2 (C + 4 Co) bytes of x and y. At the tail's shapes (104 -> 52
// at 48^2 ... 26 -> 13 at 192^2, N = 1 at eval, N = 8 in training) that is
// 24 to 800 FLOPs per byte, so the dense bound is bytes, and y is most of
// them. At N = 1 a 48^2 layer is 24 tiles of 4 x 32 half-res pixels for
// 132 SMs, so the fill of the card and a call's fixed cost weigh as much.
// The design:
// - Implicit GEMM on warp-level mma.sync m16n8k16 (bf16 operands, float32
//   sums), K1's scheme at half resolution: M = a tile of TH x 32 half-res
//   pixels (a warp a row, two m16 tiles), N = every output channel (Co
//   padded to NO x 8 with zero weights), K = the four slots x NC x 8
//   channels of one phase: 2 NC k16 steps a phase, 16 per channel group for
//   the four phases, not 36. The input tile is staged once, pixel-major
//   with an odd number of 16-byte units a pixel, the fold, ReLU and
//   rounding in registers on the way and the cached border in the same
//   pass; a slot's shift (di + r, dj + s) is an ldmatrix row address.
// - The phase row di is a second axis of the grid (blockIdx.y): a block
//   keeps the B operands of its two phases (di, 0) and (di, 1) resident in
//   shared memory for its whole life (95 KB at 104 -> 52, 133 KB at the
//   plan's widest C = 128, Co = 64; all four would not fit beside a tile)
//   and walks the tiles blockIdx.x, + gridDim.x, ... This doubles the
//   blocks at N = 1. An output belongs to one phase, so the split changes
//   no sum. The phases run one after the other, one phase's accumulators
//   live (8 NO registers).
// - Each phase's outputs, bias added and rounded once, go to a y tile in
//   shared memory at full-res column 2 j + dj, so that the two phases of a
//   row di fill whole full-res rows (2 x 32 columns); a warp then stores a
//   channel's rows 16 bytes a lane, eight lanes on a 128-byte run. Ragged
//   or unaligned rows store element by element.
// - Tiles are 8 rows where a block's shared memory holds them and there
//   are at least as many work items as the blocks the card holds at once,
//   else 4 rows (at N = 1 every flagship layer); the entry point decides
//   from the shape. Each y sums its (slot, channel group) k16 steps in one
//   fixed order whatever the tile's height or position, so the raster's
//   sub-images (K14) and the one pass (K9) give the same bits; K is never
//   split across blocks.
// - The sums (training) are kept per block in a fixed order (a warp owns a
//   channel per round), written as float32 partials, and a last launch adds
//   them in one fixed order. No atomics: two calls give the same bits.
// The TPU kernel's scatter matmuls (E0, E1), row stacks and lane padding
// have no counterpart.
#include "chw_fwd_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::aligned16;
using itg::bf16_bits_to_f32;
using itg::kRSL;
using itg::kTW;
using itg::ldmatrix_x2;
using itg::ldmatrix_x4;
using itg::mma_bf16;
using itg::smem_addr;
using itg::word;

constexpr int kYW = 2 * kTW;  // full-res columns of a y-tile row: both phases of a row
constexpr size_t kSmemPerBlock = 232448;  // the shared memory a block may take on an H100
constexpr int kMaxBlocks = 1024;  // the most blocks a launch takes: the rows of the
                                  // partials (ops/kernels.py: UPCONV_TC_MAX_BLOCKS)

// The shared-memory layout of NC channel groups, NO output-channel groups
// and TH tile rows: [B: phases (di, 0), (di, 1), 8 NO rows of WS bf16 each]
// [the A tile][the y tile: 8 NO channels of YC bf16][bias: 8 NO][scale,
// shift: 8 NC each][sums: 2 x 8 NO][A's K offsets: 2 phases x 2 KS ints].
struct Geo {
  int os;  // bf16 per staged pixel: NC x 8 channels, an odd number of 16-byte units
  int ks;  // k16 steps a phase: 2 NC (4 slots x NC chunks of 8)
  int ws;  // bf16 per B row: 16 KS + 8, an odd number of 16-byte units
  int yc;  // bf16 per output channel of the y tile: TH rows of kYW, and 8 (the
           // fragments' 2-byte stores of four channel pairs hit distinct banks)
  size_t w_bytes, a_bytes, y_bytes, smem;
};

__host__ __device__ inline Geo geo(int nc, int no, int th) {
  Geo g;
  g.os = nc % 2 ? 8 * nc : 8 * nc + 8;
  g.ks = 2 * nc;
  g.ws = 16 * g.ks + 8;
  g.yc = th * kYW + 8;
  g.w_bytes = sizeof(bf16) * 2 * 8 * no * g.ws;
  g.a_bytes = sizeof(bf16) * (th + 2) * kRSL * g.os;
  g.y_bytes = sizeof(bf16) * 8 * no * g.yc;
  g.smem = g.w_bytes + g.a_bytes + g.y_bytes + sizeof(float) * (8 * no + 16 * nc + 16 * no) +
           sizeof(int) * 4 * g.ks;
  return g;
}

struct UpArgs {
  const uint16_t* x;     // (N, C, H, W) half-res, bf16 bits
  const uint16_t* top;   // (N, C, W + 2) or null
  const uint16_t* left;  // (N, C, H) or null
  const bf16* wp;        // (4 phases, 8 NO, 4 slots, 8 NC) packed weights
  const float* bias;     // (Co)
  const float* scale;    // (C)
  const float* shift;    // (C)
  bf16* y;               // (N, Co, 2H, 2W)
  float* part;           // (2 gridDim.x, 2, Co): per-block sums of y | y^2, or null
  int N, C, H, W, Co, relu, zeros, nc;
};

// Registers a thread needs: NO n8 tiles of accumulators for two m16 tiles.
template <int NO>
constexpr int kMinBlocks = NO <= 4 ? 3 : 2;

// Grid (blocks per phase row, 2): blockIdx.y is the phase row di; 32 TH
// threads; dynamic shared memory geo(NC, NO, TH).smem.
template <int NO, int TH>
__global__ void __launch_bounds__(256, (kMinBlocks<NO>)) upconv_fwd_tc_kernel(const UpArgs a) {
  constexpr int Cop = 8 * NO, nthreads = 32 * TH;
  const int nc = a.nc, Cp = 8 * nc;
  const Geo g = geo(nc, NO, TH);
  const int OS = g.os, KS = g.ks, WS = g.ws, YC = g.yc;
  const int di = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  uint16_t* s_a = reinterpret_cast<uint16_t*>(smem + g.w_bytes);
  uint16_t* s_y = reinterpret_cast<uint16_t*>(smem + g.w_bytes + g.a_bytes);
  float* s_b = reinterpret_cast<float*>(smem + g.w_bytes + g.a_bytes + g.y_bytes);
  float* s_sc = s_b + Cop;
  float* s_sh = s_sc + Cp;
  float* s_acc = s_sh + Cp;
  int* s_koff = reinterpret_cast<int*>(s_acc + 2 * Cop);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, H = a.H, W = a.W, Co = a.Co;

  // the packed weights of phases (di, 0) and (di, 1), resident for every
  // tile: B row dj * Cop + o, K = (slot, channel) contiguous
  const int kr = 2 * KS;  // 8-wide K chunks a phase
  for (int i = tid; i < 2 * Cop * kr; i += nthreads) {
    const int row = i / kr, k8 = i % kr;
    itg::cp_async16(s_w + row * WS + 8 * k8,
                    a.wp + (static_cast<size_t>(2 * di) * Cop + row) * 8 * kr + 8 * k8);
  }
  itg::cp_async_commit();
  for (int i = tid; i < Cop; i += nthreads) s_b[i] = i < Co ? a.bias[i] : 0.f;
  for (int i = tid; i < Cp; i += nthreads) {
    s_sc[i] = i < C ? a.scale[i] : 0.f;
    s_sh[i] = i < C ? a.shift[i] : 0.f;
  }
  for (int i = tid; i < 2 * Cop; i += nthreads) s_acc[i] = 0.f;
  // the byte offset of phase (di, dj)'s K chunk kc = (slot (r, s), channel
  // group) from a pixel's A row: the staged pixel di + r rows down, dj + s
  // columns right
  for (int i = tid; i < 2 * kr; i += nthreads) {
    const int dj = i / kr, kc = i % kr;
    const int slot = kc / nc, og = kc % nc;
    s_koff[i] = 2 * (((di + (slot >> 1)) * kRSL + dj + (slot & 1)) * OS + 8 * og);
  }
  __syncthreads();

  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + kTW - 1) / kTW;
  const int n_tiles = a.N * tiles_h * tiles_w;
  const int W2 = 2 * W;
  const size_t plane2 = static_cast<size_t>(2 * H) * W2;
  const bool xvec = W % 8 == 0 && aligned16(a.x);
  const bool yvec = W2 % 8 == 0 && aligned16(a.y);
  // this lane's A rows: pixel m of each m16 tile, K half hsel; B rows rr of
  // matrix mi
  const int m = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int hsel = lane >> 4;
  const int mi = lane >> 3, rr = lane & 7;
  // the epilogue's lanes: a warp a channel; lane -> 8-column chunk ek of a
  // full-res row and tile rows er0, er0 + 4, ...
  const int ek = lane & 7, er0 = lane >> 3;
  const itg::StageSrc src{a.x, a.top, a.left, C, H, W, a.relu, a.zeros};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / (tiles_h * tiles_w);
    const int h0 = ((tile / tiles_w) % tiles_h) * TH;
    const int w0 = (tile % tiles_w) * kTW;

    itg::stage_tile<TH>(src, n, h0, w0, nc, OS, xvec, s_sc, s_sh, s_a);
    itg::cp_async_wait_all();
    __syncthreads();

    // -- the products, phase (di, 0) then (di, 1): warp w takes tile row w,
    // pixels 0..15 and 16..31. A's fragments of the next k16 step load
    // while this one's multiply.
    uint32_t abase[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) abase[mt] = smem_addr(s_a + (warp * kRSL + 16 * mt + m) * OS);
#pragma unroll 1
    for (int dj = 0; dj < 2; ++dj) {
      float acc[2][NO][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
        }
      }
      const int* koff = s_koff + dj * kr;
      const uint32_t wbase = smem_addr(s_w + dj * Cop * WS) + 2 * (rr * WS + 8 * (mi & 1));
      auto load_a = [&](int s, uint32_t (&af)[2][4]) {
        const uint32_t off = koff[2 * s + hsel];
        ldmatrix_x4(af[0], abase[0] + off);
        ldmatrix_x4(af[1], abase[1] + off);
      };
      auto step = [&](int s, const uint32_t (&af)[2][4]) {
        uint32_t b[NO / 2 + 1][4];
#pragma unroll
        for (int j = 0; j < NO / 2; ++j) {
          ldmatrix_x4(b[j], wbase + 2 * ((16 * j + 8 * (mi >> 1)) * WS + 16 * s));
        }
        if constexpr (NO % 2 == 1) {
          uint32_t b2[2];
          ldmatrix_x2(b2, wbase + 2 * (8 * (NO - 1) * WS + 16 * s));
          b[NO / 2][0] = b2[0], b[NO / 2][1] = b2[1];
        }
#pragma unroll
        for (int j = 0; j < NO / 2; ++j) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * j], af[mt], b[j][0], b[j][1]);
            mma_bf16(acc[mt][2 * j + 1], af[mt], b[j][2], b[j][3]);
          }
        }
        if constexpr (NO % 2 == 1) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NO - 1], af[mt], b[NO / 2][0], b[NO / 2][1]);
        }
      };
      uint32_t af0[2][4], af1[2][4];
      load_a(0, af0);
      for (int s = 0; s < KS; s += 2) {  // KS = 2 NC is even
        load_a(s + 1, af1);
        step(s, af0);
        if (s + 2 < KS) load_a(s + 2, af0);
        step(s + 1, af1);
      }
      // this phase's outputs: full-res column 2 col + dj of y-tile row warp
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 16 * mt + (lane >> 2) + 8 * (e >> 1);
            const int o = 8 * j + 2 * (lane & 3) + (e & 1);
            s_y[o * YC + warp * kYW + 2 * col + dj] =
                __bfloat16_as_ushort(__float2bfloat16_rn(acc[mt][j][e] + s_b[o]));
          }
        }
      }
    }
    __syncthreads();  // the y tile is complete and the A tile free

    // -- epilogue: warp w takes channels o = w, w + TH, ...; lane (er0, ek)
    // full-res columns 2 w0 + 8 ek .. + 7 of tile rows er0, er0 + 4, ...
    // (full-res row 2 (h0 + er) + di); stores and sums the stored values.
    // The next tile's staging may overwrite A meanwhile: its barrier comes
    // before any thread writes this y tile again.
    const int col0 = 2 * w0 + 8 * ek;
    const int valid = min(8, W2 - col0);
#pragma unroll 1
    for (int i = 0; i < Cop / TH; ++i) {
      const int o = warp + TH * i;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < TH / 4; ++q) {
        const int er = er0 + 4 * q, row = h0 + er;
        const uint4 v = *reinterpret_cast<const uint4*>(s_y + o * YC + er * kYW + 8 * ek);
        if (o < Co && row < H && valid > 0) {
          bf16* dst = a.y + (static_cast<size_t>(n) * Co + o) * plane2 +
                      static_cast<size_t>(2 * row + di) * W2;
          if (yvec && valid == 8) {
            *reinterpret_cast<uint4*>(dst + col0) = v;
          } else {
            for (int e = 0; e < valid; ++e) {
              dst[col0 + e] = __ushort_as_bfloat16(static_cast<uint16_t>(word(v, e / 2) >> (16 * (e & 1))));
            }
          }
          if (a.part) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const uint32_t w = word(v, e / 2);
              const float f = e < valid ? bf16_bits_to_f32((e & 1) ? w >> 16 : w & 0xffffu) : 0.f;
              s1 = __fadd_rn(s1, f);
              s2 = fmaf(f, f, s2);
            }
          }
        }
      }
      if (a.part) {  // the same for every thread of the launch
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, d));
          s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, d));
        }
        if (lane == 0 && o < Co) {
          s_acc[o] = __fadd_rn(s_acc[o], s1);
          s_acc[Cop + o] = __fadd_rn(s_acc[Cop + o], s2);
        }
      }
    }
  }
  if (a.part) {
    __syncthreads();
    float* out = a.part + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * Co;
    for (int i = tid; i < Co; i += nthreads) {
      out[i] = s_acc[i];
      out[Co + i] = s_acc[Cop + i];
    }
  }
}

// The B operand: wp[p][o][slot][c] (4 x 8 NO x 4 x 8 NC bf16, zero past Co
// and C) = bf16 of phase p = (di, dj)'s combined weight at slot (r, s) for
// w (Co, C, 3, 3) float32: the row taps K0 | K1 + K2 (di = 0) or K0 + K1 |
// K2 (di = 1) combined first, then the column taps the same way, in float32
// (ops/kernels.py: _upconv_phase_weights, whose additions these are).
__global__ void upconv_fwd_tc_pack_kernel(const float* __restrict__ w, bf16* __restrict__ wp,
                                          int C, int Co, int cp, int cop) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 4 * cop * 4 * cp) return;
  const int c = i % cp, slot = (i / cp) % 4, o = (i / (4 * cp)) % cop, p = i / (4 * cp * cop);
  float val = 0.f;
  if (c < C && o < Co) {
    // combined tap (d, t) of a 3-tap axis: K0, K1 + K2, K0 + K1, K2
    const int ri = 2 * (p >> 1) + (slot >> 1), ci = 2 * (p & 1) + (slot & 1);
    const int r0 = ri == 1 ? 1 : ri == 3 ? 2 : 0, c0 = ci == 1 ? 1 : ci == 3 ? 2 : 0;
    const bool r2 = ri == 1 || ri == 2, c2 = ci == 1 || ci == 2;
    const float* k = w + (static_cast<size_t>(o) * C + c) * 9;
    float rows[3];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      rows[kx] = r2 ? __fadd_rn(k[3 * r0 + kx], k[3 * (r0 + 1) + kx]) : k[3 * r0 + kx];
    }
    val = c2 ? __fadd_rn(rows[c0], rows[c0 + 1]) : rows[c0];
  }
  wp[i] = __float2bfloat16_rn(val);
}

template <int TH>
long tiles(const UpArgs& a) {
  return static_cast<long>(a.N) * ((a.H + TH - 1) / TH) * ((a.W + kTW - 1) / kTW);
}

// The blocks of upconv_fwd_tc_kernel<NO, TH> the card holds at once.
template <int NO, int TH>
int resident(const UpArgs& a, long* held) {
  const auto kernel = upconv_fwd_tc_kernel<NO, TH>;
  const size_t smem = geo(a.nc, NO, TH).smem;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * TH, smem)) {
    return static_cast<int>(e);
  }
  *held = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count();
  return 0;
}

// One call: the weights packed, the persistent grid (per phase row at most
// half the blocks the card holds, one per tile and kMaxBlocks / 2), then,
// with stats, the sums.
template <int NO, int TH>
int launch(const UpArgs& a, long held, const float* w, float* s1, float* s2, cudaStream_t st) {
  const int packed = 4 * 8 * NO * 4 * 8 * a.nc;
  upconv_fwd_tc_pack_kernel<<<(packed + 255) / 256, 256, 0, st>>>(
      w, const_cast<bf16*>(a.wp), a.C, a.Co, 8 * a.nc, 8 * NO);
  if (int rc = itg::last_error()) return rc;
  long per = (held + 1) / 2;
  per = per < tiles<TH>(a) ? per : tiles<TH>(a);
  per = per < kMaxBlocks / 2 ? per : kMaxBlocks / 2;
  upconv_fwd_tc_kernel<NO, TH>
      <<<dim3(static_cast<unsigned>(per), 2), 32 * TH, geo(a.nc, NO, TH).smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  if (!a.part) return 0;
  itg::sum_partials<<<2 * a.Co, itg::kReduceThreads, 0, st>>>(a.part, s1, s2,
                                                              static_cast<int>(2 * per), a.Co);
  return itg::last_error();
}

// 8-row tiles where a block's shared memory holds them and their work items
// (two phase rows a tile) are at least as many as the blocks the card holds
// at once, else 4-row tiles.
template <int NO>
int dispatch(const UpArgs& a, const float* w, float* s1, float* s2, cudaStream_t st) {
  long held = 0;
  if (geo(a.nc, NO, 8).smem <= kSmemPerBlock) {
    if (int rc = resident<NO, 8>(a, &held)) return rc;
    if (2 * tiles<8>(a) >= held) return launch<NO, 8>(a, held, w, s1, s2, st);
  }
  if (geo(a.nc, NO, 4).smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = resident<NO, 4>(a, &held)) return rc;
  return launch<NO, 4>(a, held, w, s1, s2, st);
}

}  // namespace

// K9 (with its sums) and K14 on the tensor cores. x (n, c, h, w) half-res,
// y (n, co, 2h, 2w), top (n, c, w + 2) and left (n, c, h) (each may be null)
// bfloat16; w (co, c, 3, 3), b (co), scale, shift (c) float32; wp (4, 8 no,
// 4, 8 nc) bfloat16 scratch, written with the packed combined weights (c <=
// 8 nc, nc <= 16; co <= 8 no, no in {1, 2, 4, 7, 8}); part (kMaxBlocks, 2,
// co) float32 scratch and s1, s2 (co) float32, written with Σy and Σy², or
// all three null for no stats. Two or three launches; returns the first
// CUDA error (cudaErrorInvalidValue for a plan the kernels do not take).
extern "C" int itg_upconv3x3_chw_tc(const void* x, const void* w, const void* b,
                                    const void* scale, const void* shift, const void* top,
                                    const void* left, void* wp, void* y, void* part, void* s1,
                                    void* s2, int n, int c, int h, int width, int co, int relu,
                                    int zeros, int nc, int no, void* stream) {
  if (nc < 1 || nc > 16 || c > 8 * nc || co > 8 * no) return static_cast<int>(cudaErrorInvalidValue);
  const UpArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(top),
                 static_cast<const uint16_t*>(left), static_cast<const bf16*>(wp),
                 static_cast<const float*>(b), static_cast<const float*>(scale),
                 static_cast<const float*>(shift), static_cast<bf16*>(y),
                 static_cast<float*>(part), n, c, h, width, co, relu, zeros, nc};
  const auto* wf = static_cast<const float*>(w);
  auto* a1 = static_cast<float*>(s1);
  auto* a2 = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  switch (no) {
    case 1: return dispatch<1>(a, wf, a1, a2, st);
    case 2: return dispatch<2>(a, wf, a1, a2, st);
    case 4: return dispatch<4>(a, wf, a1, a2, st);
    case 7: return dispatch<7>(a, wf, a1, a2, st);
    case 8: return dispatch<8>(a, wf, a1, a2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
