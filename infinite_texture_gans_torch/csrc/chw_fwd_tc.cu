// The generator tail's 3x3 convolution forward on the tensor cores, for
// bfloat16 activations: one kernel body serves
//   K1 _conv3x3_chw_fwd (infinite_texture_gans_tpu/ops/pallas_conv.py:395,
//      kernel _conv_kernel :275), the one-pass form, with K5's per-channel
//      sums (conv3x3_chw_stats :987 and conv3x3_chw_p :1086 through the same
//      :395 call); and
//   K2 _conv3x3_chw_fwd_halo (:539, kernel _conv_halo_kernel :421), the
//      raster-engine form whose top row and left column come, already
//      post-norm, from the halo cache.
// Both compute y = conv3x3(P) + b, where P is the post-norm input with its
// one-pixel border: act(scale * x + shift) with no FMA contraction
// (__fmul_rn, __fadd_rn, then ReLU) rounded to bf16, as ops/kernels.py:
// prenorm and the halo cache compute it. The border is the own edge
// (replicate) or zeros, except where the caller passes `top` (N, C, W + 2:
// the padded row above, corners included) or `left` (N, C, H: the padded
// column to the left), used as they are; the bottom row and right column are
// always the own edge. The weights are rounded to bf16, as the reference
// rounds them on this path (pallas_conv.py:615, :949, :999, :1093), the bias
// (float32) is added to the float32 sum before y's one rounding to bf16, and
// with stats (K5) the kernel gives the float32 per-channel sums of the STORED
// y and y^2. Float32 activations take the CUDA-core kernel of conv3x3_fwd_f32.cu.
//
// What bounds it on the H100: 2 * 9 * C * Co FLOPs per output pixel against
// 2 (C + Co) bytes of x and y; at the tail's shapes (C -> Co of 104 -> 52 down
// to 13 -> 3) that is 45 to 3,000 FLOPs per byte, so the dense bound is
// bytes at the narrow shapes and operations (989 bf16 TFLOP/s) at the wide
// ones. At N = 1 a 96^2 layer is 36 tiles of 8 x 32 pixels for 132 SMs, so
// a call's fixed cost (two launches, a block's weights, the epilogue) and
// the fill of the card weigh as much as either. The design:
// - Implicit GEMM on warp-level mma.sync m16n8k16 (bf16 operands, float32
//   sums). M = a tile of TH x 32 output pixels (one warp a row as two m16
//   tiles), N = every output channel of the layer (Co padded to NO x 8 with
//   zero weights: 3 -> 8, 13 -> 16, 26 -> 32, 52 -> 56), K = (tap, input
//   channel) with C padded to NC x 8 per tap. Each 8-wide half of a k16
//   step has its own (tap, channel group), read through ldmatrix's per-lane
//   row addresses, so 13 channels cost 9 k16 steps, not 18. A's fragments
//   of the next k16 step load while this one's multiply.
// - Every output channel is in one block, so each input tile is staged and
//   normed once. It goes to shared memory pixel-major, a row of NC x 8
//   channels per pixel with an odd number of 16-byte units (ldmatrix's eight
//   rows hit distinct banks): a tap's shift is then a row address. A
//   padded row's source (x, the edge row it replicates, the cached top row,
//   zero) is decided once per staged row and chunk of 8 columns: eight
//   16-byte loads of 8 channels, the fold, ReLU and rounding in registers
//   and a transpose to pixels by byte permutes, or, at the cached top row,
//   the replicate ring's column and ragged widths, a gather of the same 64
//   values; the two halo columns ride along in the same units, a pixel of 8
//   channels each, so a tile's loads go out in one round (at N = 1, a loop
//   of its own for the halo cost one more round trip per tile, and loads
//   issued one pixel at a time several).
// - B, the packed weights in bf16 (ops/kernels.py: pack_fwd_weights is the
//   plain version of the entry point's first launch), rows = output channel,
//   K contiguous, resident in shared memory for the block's whole life: 106
//   KB at 104 -> 52, beside an A tile of 73 KB.
// - Tiles are 8 rows, or 4 where 8-row tiles would not fit a block's shared
//   memory (C > 120 with Co > 56) or would be fewer than the blocks the card
//   holds at once, which leaves SMs idle (at N = 1, the 96^2 and 192^2
//   layers); the entry point decides from the shape. Each y sums its
//   (tap, channel) products in one fixed order of k16 steps whatever the
//   tile's height or position, so the raster's sub-images and the one pass's
//   grid give the same bits; K is never split across blocks.
// - Blocks are persistent: each walks the tiles blockIdx.x, + gridDim.x, ...
//   The y tile is staged in shared memory as bf16 (bias added, rounded once)
//   and written 16 bytes a lane where rows keep the alignment. K5's sums
//   are kept per block in a fixed order (one warp, or half a warp at TH = 4,
//   owns a channel per round), written as float32 partials, and a last
//   launch sums the partials in one fixed order. No atomics: two calls give
//   the same bits.
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

constexpr int kYR = kTW;      // bf16 per y-tile row (64 bytes: the epilogue's
                              // 16-byte reads of two rows hit distinct banks)
constexpr size_t kSmemPerBlock = 232448;  // the shared memory a block may take on an H100
constexpr int kMaxBlocks = 1024;  // the most blocks a launch takes: the rows of the
                                  // partials (ops/kernels.py: FWD_TC_MAX_BLOCKS)

// The shared-memory layout of NC channel groups, NO output-channel groups
// and TH tile rows: [B: 8 NO rows of WS bf16][the A tile | the y tile][bias:
// 8 NO][scale, shift: 8 NC each][sums: 2 x 8 NO][A's K offsets: 2 KS ints].
struct Geo {
  int os;  // bf16 per staged pixel: NC x 8 channels, an odd number of 16-byte units
  int kr;  // 8-wide K chunks: 9 NC
  int ks;  // k16 steps
  int ws;  // bf16 per B row: 16 KS + 8, an odd number of 16-byte units
  int yc;  // bf16 per output channel of the y tile: TH rows of kYR, and 8 (the
           // fragments' 2-byte stores of four channel pairs hit distinct banks)
  size_t w_bytes, region, smem;
};

__host__ __device__ inline Geo geo(int nc, int no, int th) {
  Geo g;
  g.os = nc % 2 ? 8 * nc : 8 * nc + 8;
  g.kr = 9 * nc;
  g.ks = (g.kr + 1) / 2;
  g.ws = 16 * g.ks + 8;
  g.yc = th * kYR + 8;
  g.w_bytes = sizeof(bf16) * 8 * no * g.ws;
  const size_t a = sizeof(bf16) * (th + 2) * kRSL * g.os;
  const size_t y = sizeof(bf16) * 8 * no * g.yc;
  g.region = a > y ? a : y;
  g.smem = g.w_bytes + g.region + sizeof(float) * (8 * no + 16 * nc + 16 * no) +
           sizeof(int) * 2 * g.ks;
  return g;
}

struct FwdArgs {
  const uint16_t* x;     // (N, C, H, W), bf16 bits
  const uint16_t* top;   // (N, C, W + 2) or null
  const uint16_t* left;  // (N, C, H) or null
  const bf16* wp;        // (8 NO, 3, 3, 8 NC) packed weights
  const float* bias;     // (Co)
  const float* scale;    // (C)
  const float* shift;    // (C)
  bf16* y;               // (N, Co, H, W)
  float* part;           // (gridDim.x, 2, Co): per-block sums of y | y^2, or null
  int N, C, H, W, Co, relu, zeros, nc;
};

// Registers a thread needs: NO n8 tiles of accumulators for two m16 tiles.
template <int NO>
constexpr int kMinBlocks = NO <= 4 ? 3 : 2;

// Grid (blocks), 32 TH threads, dynamic shared memory geo(NC, NO, TH).smem.
template <int NO, int TH>
__global__ void __launch_bounds__(256, (kMinBlocks<NO>)) chw_fwd_tc_kernel(const FwdArgs a) {
  constexpr int Cop = 8 * NO, nthreads = 32 * TH;
  const int nc = a.nc, Cp = 8 * nc;
  const Geo g = geo(nc, NO, TH);
  const int OS = g.os, KS = g.ks, WS = g.ws, YC = g.yc;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  uint16_t* s_a = reinterpret_cast<uint16_t*>(smem + g.w_bytes);
  uint16_t* s_y = s_a;  // the y tile, after the products
  float* s_b = reinterpret_cast<float*>(smem + g.w_bytes + g.region);
  float* s_sc = s_b + Cop;
  float* s_sh = s_sc + Cp;
  float* s_acc = s_sh + Cp;
  int* s_koff = reinterpret_cast<int*>(s_acc + 2 * Cop);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, H = a.H, W = a.W, Co = a.Co;

  // the packed weights, resident for every tile; zero the K pad
  for (int i = tid; i < Cop * g.kr; i += nthreads) {
    const int o = i / g.kr, k8 = i % g.kr;
    itg::cp_async16(s_w + o * WS + 8 * k8, a.wp + static_cast<size_t>(o) * 8 * g.kr + 8 * k8);
  }
  itg::cp_async_commit();
  if (2 * KS > g.kr) {
    for (int o = tid; o < Cop; o += nthreads) {
      *reinterpret_cast<uint4*>(s_w + o * WS + 8 * g.kr) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int i = tid; i < Cop; i += nthreads) s_b[i] = i < Co ? a.bias[i] : 0.f;
  for (int i = tid; i < Cp; i += nthreads) {
    s_sc[i] = i < C ? a.scale[i] : 0.f;
    s_sh[i] = i < C ? a.shift[i] : 0.f;
  }
  for (int i = tid; i < 2 * Cop; i += nthreads) s_acc[i] = 0.f;
  // the byte offset of K chunk kc = (tap, channel group) from a pixel's A
  // row; the chunk past the last (an odd count) repeats the last, whose B
  // columns are zero
  for (int i = tid; i < 2 * KS; i += nthreads) {
    const int kc = i < g.kr ? i : g.kr - 1;
    const int tap = kc / nc, og = kc % nc;
    s_koff[i] = 2 * (((tap / 3) * kRSL + tap % 3) * OS + 8 * og);
  }
  __syncthreads();

  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + kTW - 1) / kTW;
  const int n_tiles = a.N * tiles_h * tiles_w;
  const size_t plane = static_cast<size_t>(H) * W;
  const bool xvec = W % 8 == 0 && aligned16(a.x);
  const bool yvec = W % 8 == 0 && aligned16(a.y);
  // this lane's A rows: pixel m of each m16 tile, K half hsel; B rows rr of
  // matrix mi
  const int m = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int hsel = lane >> 4;
  const int mi = lane >> 3, rr = lane & 7;
  // the epilogue's lanes: 4 TH lanes a channel (TH = 4: two channels, four
  // apart), lane -> tile row er and 8-column chunk ek
  constexpr int lanes_per_ch = 4 * TH;
  const int esub = lane / lanes_per_ch;
  const int er = (lane % lanes_per_ch) >> 2, ek = lane & 3;
  const itg::StageSrc src{a.x, a.top, a.left, C, H, W, a.relu, a.zeros};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / (tiles_h * tiles_w);
    const int h0 = ((tile / tiles_w) % tiles_h) * TH;
    const int w0 = (tile % tiles_w) * kTW;

    itg::stage_tile<TH>(src, n, h0, w0, nc, OS, xvec, s_sc, s_sh, s_a);
    itg::cp_async_wait_all();
    __syncthreads();

    // -- the products: warp w takes tile row w, pixels 0..15 and 16..31. A's
    // fragments of the next k16 step load while this one's multiply.
    float acc[2][NO][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      }
    }
    uint32_t abase[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) abase[mt] = smem_addr(s_a + (warp * kRSL + 16 * mt + m) * OS);
    const uint32_t wbase = smem_addr(s_w) + 2 * (rr * WS + 8 * (mi & 1));
    auto load_a = [&](int s, uint32_t (&af)[2][4]) {
      const uint32_t off = s_koff[2 * s + hsel];
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
    for (int s = 0; s < KS; s += 2) {
      if (s + 1 < KS) load_a(s + 1, af1);
      step(s, af0);
      if (s + 1 < KS) {
        if (s + 2 < KS) load_a(s + 2, af0);
        step(s + 1, af1);
      }
    }
    __syncthreads();  // every warp is done with the A tile: its space takes y
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * mt + (lane >> 2) + 8 * (e >> 1);
          const int o = 8 * j + 2 * (lane & 3) + (e & 1);
          s_y[o * YC + warp * kYR + col] =
              __bfloat16_as_ushort(__float2bfloat16_rn(acc[mt][j][e] + s_b[o]));
        }
      }
    }
    __syncthreads();

    // -- epilogue: lane (er, ek) takes columns w0 + 8 ek .. + 7 of tile row er
    // for channel o = warp + TH esub + 8 i; stores and sums the stored values
    const int row = h0 + er, col0 = w0 + 8 * ek;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int o = warp + TH * esub + 8 * i;
      const uint4 v = *reinterpret_cast<const uint4*>(s_y + o * YC + er * kYR + 8 * ek);
      float s1 = 0.f, s2 = 0.f;
      if (o < Co && row < H) {
        bf16* dst = a.y + (static_cast<size_t>(n) * Co + o) * plane + static_cast<size_t>(row) * W;
        const int valid = min(8, W - col0);
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
      if (a.part) {  // the same for every thread of the launch
        for (int d = lanes_per_ch / 2; d > 0; d >>= 1) {
          s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, d));
          s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, d));
        }
        if (lane % lanes_per_ch == 0 && o < Co) {
          s_acc[o] = __fadd_rn(s_acc[o], s1);
          s_acc[Cop + o] = __fadd_rn(s_acc[Cop + o], s2);
        }
      }
    }
    __syncthreads();  // the y tile is read before the next tile's A lands on it
  }
  if (a.part) {
    float* out = a.part + static_cast<size_t>(blockIdx.x) * 2 * Co;
    for (int i = tid; i < Co; i += nthreads) {
      out[i] = s_acc[i];
      out[Co + i] = s_acc[Cop + i];
    }
  }
}

// The B operand: wp[o][tap][c] (8 NO x 9 x 8 NC bf16, zero past Co and C) =
// bf16(w[o][c][tap / 3][tap % 3]) from w (Co, C, 3, 3) float32.
__global__ void chw_fwd_tc_pack_kernel(const float* __restrict__ w, bf16* __restrict__ wp, int C,
                                       int Co, int cp, int cop) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cop * 9 * cp) return;
  const int c = i % cp, tap = (i / cp) % 9, o = i / (9 * cp);
  const float val = c < C && o < Co ? w[(static_cast<size_t>(o) * C + c) * 9 + tap] : 0.f;
  wp[i] = __float2bfloat16_rn(val);
}

template <int TH>
long tiles(const FwdArgs& a) {
  return static_cast<long>(a.N) * ((a.H + TH - 1) / TH) * ((a.W + kTW - 1) / kTW);
}

// The blocks of chw_fwd_tc_kernel<NO, TH> the card holds at once.
template <int NO, int TH>
int resident(const FwdArgs& a, long* held) {
  const auto kernel = chw_fwd_tc_kernel<NO, TH>;
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

// One call: the weights packed, the persistent grid (at most `held` blocks,
// one per tile and kMaxBlocks), then, with stats, the sums.
template <int NO, int TH>
int launch(const FwdArgs& a, long held, const float* w, float* s1, float* s2, cudaStream_t st) {
  const int packed = 8 * NO * 9 * 8 * a.nc;
  chw_fwd_tc_pack_kernel<<<(packed + 255) / 256, 256, 0, st>>>(
      w, const_cast<bf16*>(a.wp), a.C, a.Co, 8 * a.nc, 8 * NO);
  if (int rc = itg::last_error()) return rc;
  long blocks = held < tiles<TH>(a) ? held : tiles<TH>(a);
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  chw_fwd_tc_kernel<NO, TH><<<static_cast<int>(blocks), 32 * TH, geo(a.nc, NO, TH).smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  if (!a.part) return 0;
  itg::sum_partials<<<2 * a.Co, itg::kReduceThreads, 0, st>>>(a.part, s1, s2,
                                                              static_cast<int>(blocks), a.Co);
  return itg::last_error();
}

// 8-row tiles where a block's shared memory holds them and they are at
// least as many as the blocks the card holds at once, else 4-row tiles.
template <int NO>
int dispatch(const FwdArgs& a, const float* w, float* s1, float* s2, cudaStream_t st) {
  long held = 0;
  if (geo(a.nc, NO, 8).smem <= kSmemPerBlock) {
    if (int rc = resident<NO, 8>(a, &held)) return rc;
    if (tiles<8>(a) >= held) return launch<NO, 8>(a, held, w, s1, s2, st);
  }
  if (int rc = resident<NO, 4>(a, &held)) return rc;
  return launch<NO, 4>(a, held, w, s1, s2, st);
}

}  // namespace

// K1 / K2 (/ K5) on the tensor cores. x (n, c, h, w), y (n, co, h, w), top
// (n, c, w + 2) and left (n, c, h) (each may be null) bfloat16; w (co, c, 3,
// 3), b (co), scale, shift (c) float32; wp (8 no, 3, 3, 8 nc) bfloat16
// scratch, written with the packed weights (c <= 8 nc, nc <= 16; co <= 8 no,
// no in {1, 2, 4, 7, 8}); part (kMaxBlocks, 2, co) float32 scratch and s1,
// s2 (co) float32, written with Σy and Σy², or all three null for no stats.
// Two or three launches; returns the first CUDA error (cudaErrorInvalidValue
// for a plan the kernels do not take).
extern "C" int itg_conv3x3_chw_tc(const void* x, const void* w, const void* b, const void* scale,
                                  const void* shift, const void* top, const void* left, void* wp,
                                  void* y, void* part, void* s1, void* s2, int n, int c, int h,
                                  int width, int co, int relu, int zeros, int nc, int no,
                                  void* stream) {
  if (nc < 1 || nc > 16 || c > 8 * nc || co > 8 * no) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(top),
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
