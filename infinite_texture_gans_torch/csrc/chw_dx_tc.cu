// The input-side gradients of the generator tail's 3x3 convolutions on the
// tensor cores, for bfloat16 activations: one kernel body serves
//   K6  _conv3x3_chw_dx (infinite_texture_gans_tpu/ops/pallas_conv.py:775,
//       kernel _dx_kernel :644), the gradient of conv3x3(pad1(act(scale * x +
//       shift))), stride 1 and 3 x 3 taps; and
//   K9 dx _upconv3x3_dx (:1642, kernel _updx_kernel :1491), the gradient of
//       the same conv of the nearest-2x upsample, which the phase algebra
//       turns into stride 2 and 4 x 4 taps on the half-resolution slab.
// Both compute, per input channel c:
//   dP = the transposed conv of g on the padded grid, (H + 2) x (W + 2) cells
//        (for K9 the padded half-res grid);
//   da = dP on the H x W interior with the replicate border folded back
//        onto the edge rows and columns (as ops/kernels.py: _fold_border: the
//        columns first, then the rows, so a corner reaches its edge cell through
//        both), or with the border dropped (zeros);
//   da = 0 where the forward's ReLU was off (scale * x + shift <= 0, with no
//        FMA contraction, as the forward computes it);
//   dx = bf16(da * scale), d(scale) = sum da * x, d(shift) = sum da.
// Float32 activations take the CUDA-core kernels of conv3x3_dx_f32.cu and
// upconv_dx_f32.cu.
//
// What bounds it on the H100: the transposed conv is 2 * T^2 * C * Co FLOPs
// per (padded) cell against about 2 * (2C + S^2 Co) bytes; at the training
// shapes (C, Co <= 52) that is under 300 FLOPs per byte, so bytes bound it on
// the tensor cores (989 bf16 TFLOP/s, 3.35 TB/s). The design:
// - Implicit GEMM on warp-level mma.sync m16n8k16 (bf16 operands, float32
//   sums). M = a tile of padded cells (TH rows x 32; a warp takes one row as
//   two m16 tiles), N = all C input channels of the block (padded to NT x 8
//   with zero weights: 13 -> 16, 26 -> 32, 52 -> 56), K = (tap, output
//   channel) with Co padded to NO x 8 per tap. Each 8-wide half of a k16 step
//   has its own (tap, channel group), read through ldmatrix's per-lane row
//   addresses, so Co = 3 costs 5 k16 steps for 9 taps, not 9.
// - g is staged in shared memory pixel-major, a row of output channels per
//   pixel with an odd number of 16-byte units (conflict-free ldmatrix): a
//   tap's shift is then a row-address offset. For stride 2 the staged
//   columns are split by parity, so that the 16 cells of a warp read 16
//   consecutive rows at every tap. A thread loads 8 channels x 8 columns with
//   16-byte loads and transposes them in registers (byte permutes).
// - B, the flipped (K6) or phase-combined (K9, combined in float32 and then
//   rounded, as the reference rounds it at :1637-1639) weights in bf16, is
//   packed by the entry point's first launch (ops/kernels.py: pack_dx_weights
//   is its plain version): rows = input channel, K contiguous, resident in
//   shared memory for the block's whole life.
// - Blocks are persistent: each walks the tiles blockIdx.x, + gridDim.x, ...
//   The tiling keeps each border ring in the tile of the edge it folds onto
//   (a tile row or column starts early where the far ring would start a tile
//   of its own), so the folds are adds of the tile's own accumulators in the
//   epilogue, staged in shared memory as float32: no per-thread fold loops,
//   and no warp waits on an edge lane. Column tiles start where x's columns
//   are a multiple of 8, so the epilogue reads x and writes dx 16 bytes a
//   lane, every channel's x of a lane in flight at once.
// - Each da sums its (tap, channel) products in one order and its folds in
//   one order, wherever its tile lies. The per-channel sums are kept per block
//   in a fixed order (one warp owns a channel), written as float32 partials,
//   and a last launch sums the partials in one fixed order. No atomics: two
//   calls give the same bits.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::ldmatrix_x2;
using itg::ldmatrix_x4;
using itg::mma_bf16;
using itg::smem_addr;

constexpr int kTW = 32;  // padded cells per tile row: a warp's two m16 tiles

// The geometry of stride S: T x T taps, TH tile rows (one warp each), the
// staged g tile of R rows x CC columns (NCH aligned 8-column chunks cover
// them), RSL pixel slots per staged row (odd: the 16-byte stores of eight
// consecutive rows hit distinct banks).
//   S = 1 (K6): cell (p, q) of the padded grid takes g[p - 2 + u][q - 2 + v]
//     through the flipped tap (u, v) = (2 - ky, 2 - kx); staged rows p0 - 2 ..,
//     columns q0 - 2 .., column cc at slot cc.
//   S = 2 (K9): padded half-res cell (p, q) takes g[2p - 3 + u][2q - 3 + v]
//     through the combined tap (u, v); staged rows 2p0 - 3 .., columns 2q0 - 4
//     .. (an even start), column cc at slot (cc & 1) * CC / 2 + (cc >> 1): the
//     parity halves, so that consecutive cells read consecutive slots.
template <int S>
struct Geo {
  static constexpr int T = S == 1 ? 3 : 4;
  static constexpr int TH = S == 1 ? 8 : 4;
  static constexpr int R = S == 1 ? TH + 2 : 2 * TH + 2;
  static constexpr int CC = S == 1 ? kTW + 2 : 2 * kTW + 4;
  static constexpr int NCH = S == 1 ? 6 : 10;
  static constexpr int RSL = CC + 1;
  static constexpr int kThreads = 32 * TH;
};

// bf16 per staged pixel: NO x 8 channels, padded to an odd number of 16-byte units
template <int NO>
constexpr int kOS = NO % 2 ? 8 * NO : 8 * NO + 8;

// K: T^2 NO 8-wide chunks, in k16 steps; B rows of KT + 8 bf16 (an odd number
// of 16-byte units)
template <int S, int NO>
struct Kdim {
  static constexpr int KR = Geo<S>::T * Geo<S>::T * NO;
  static constexpr int KS = (KR + 1) / 2;
  static constexpr int KT = 16 * KS;
  static constexpr int WS = KT + 8;
};

// The float32 da tile, channel-major per tile row: cell (r, col) of channel
// c at r * DRS + c * CS + col. CS = 36 (32 columns and a pad: the products'
// stores, 8 columns x 4 channel pairs a warp, hit distinct banks) and DRS = 8
// NT CS + 4 (the epilogue's 16-byte reads, two rows x four 8-column chunks a
// quarter warp, hit distinct banks).
template <int NT>
struct Dtile {
  static constexpr int CS = kTW + 4;
  static constexpr int DRS = 8 * NT * CS + 4;
};

template <int S>
__device__ __forceinline__ int g_slot(int r, int cc) {
  return r * Geo<S>::RSL + (S == 1 ? cc : (cc & 1) * (Geo<S>::CC / 2) + (cc >> 1));
}

// The staged-g offset (bf16) of the 8-wide K chunk kc for a cell at offset 0:
// chunk kc = tap * NO + channel group; the chunk past the last (an odd count)
// repeats the last, whose B rows are zero there.
template <int S, int NO>
__device__ constexpr int a_off(int kc) {
  constexpr int T = Geo<S>::T, CC = Geo<S>::CC;
  if (kc >= T * T * NO) kc = T * T * NO - 1;
  const int tap = kc / NO, og = kc % NO, u = tap / T, v = tap % T;
  const int col = S == 1 ? v : ((v + 1) & 1) * (CC / 2) + ((v + 1) >> 1);
  return (u * Geo<S>::RSL + col) * kOS<NO> + 8 * og;
}

template <int S, int NO, int NT>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t w = sizeof(bf16) * 8 * NT * Kdim<S, NO>::WS;
  constexpr size_t g = sizeof(bf16) * Geo<S>::R * Geo<S>::RSL * kOS<NO>;
  constexpr size_t d = sizeof(float) * Geo<S>::TH * Dtile<NT>::DRS;
  return w + (g > d ? g : d) + sizeof(float) * 2 * 8 * NT;
}

struct DxArgs {
  const bf16* x;       // (N, C, H, W)
  const uint16_t* g;   // (N, Co, S H, S W), bf16 bits
  const bf16* wp;      // (NT 8, T, T, NO 8) packed weights
  const float* scale;  // (C)
  const float* shift;  // (C)
  bf16* dx;            // (N, C, H, W)
  float* part;         // (gridDim.x, 2, C): per-block d(scale) | d(shift)
  int N, C, H, W, Co, relu, zeros;
  int sr, sc;          // the tiling's row shift (0 or 1) and column shift (0 or 8)
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Eight bf16 of x at row pointer `row`, columns j .. j + 7 (zero outside
// [0, W)), as float32, element by element (rows that are not 16-byte aligned).
__device__ __forceinline__ void load8(float (&v)[8], const bf16* row, int j, int W) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = (j + e >= 0 && j + e < W) ? __bfloat162float(row[j + e]) : 0.f;
}

// Grid (blocks), Geo<S>::kThreads threads, dynamic shared memory
// smem_bytes<S, NO, NT>(): [B: NT 8 rows of WS bf16][g tile | the da tile in
// float32][the block's sums: 2 NT 8 floats].
// Blocks per SM the register budget is sized for: the narrow configurations
// fit more blocks (more tiles in flight) than the shared memory of the wide
// ones allows.
template <int S, int NT>
constexpr int kMinBlocks = S == 1 ? (NT <= 2 ? 6 : NT <= 4 ? 4 : 2) : (NT <= 4 ? 8 : 3);

template <int S, int NO, int NT>
__global__ void __launch_bounds__(Geo<S>::kThreads, (kMinBlocks<S, NT>))
chw_dx_tc_kernel(const DxArgs a) {
  using G = Geo<S>;
  using K = Kdim<S, NO>;
  constexpr int TH = G::TH, R = G::R, CC = G::CC, RSL = G::RSL, kThreads = G::kThreads;
  constexpr int OS = kOS<NO>, Cp = 8 * NT, CS = Dtile<NT>::CS, DRS = Dtile<NT>::DRS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  bf16* s_g = s_w + Cp * K::WS;
  float* s_d = reinterpret_cast<float*>(s_g);  // the da tile, after the products
  float* s_acc = reinterpret_cast<float*>(smem + smem_bytes<S, NO, NT>()) - 2 * Cp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, H = a.H, W = a.W, Co = a.Co;
  const int H2 = S * H, W2 = S * W;
  const size_t plane = static_cast<size_t>(H2) * W2;
  // 16-byte loads of g and of x / stores of dx where rows keep the alignment
  const bool gvec = W2 % 8 == 0 && aligned16(a.g);
  const bool xvec = W % 8 == 0 && aligned16(a.x) && aligned16(a.dx);

  // the packed weights, resident for every tile; zero the K pad
  for (int i = tid; i < Cp * K::KR; i += kThreads) {
    const int c = i / K::KR, k8 = i % K::KR;
    itg::cp_async16(s_w + c * K::WS + 8 * k8, a.wp + static_cast<size_t>(c) * 8 * K::KR + 8 * k8);
  }
  itg::cp_async_commit();
  if constexpr (K::KT > 8 * K::KR) {
    for (int c = tid; c < Cp; c += kThreads) {
      *reinterpret_cast<uint4*>(s_w + c * K::WS + 8 * K::KR) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int i = tid; i < 2 * Cp; i += kThreads) s_acc[i] = 0.f;

  // column tiles start at q0 = 32 t - 7 - sc (so x's columns j = q - 1 of a
  // tile begin on a multiple of 8); row tiles at p0 = TH t - sr
  const int tiles_h = (H + 2 + a.sr + TH - 1) / TH;
  const int tiles_w = (W + 9 + a.sc + kTW - 1) / kTW;
  const int n_tiles = a.N * tiles_h * tiles_w;
  // this lane's A rows: cell m of each m16 tile, K half hsel
  const int m = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int hsel = lane >> 4;
  const int mi = lane >> 3, rr = lane & 7;
  // the epilogue's lanes: 4 TH lanes a channel (S = 2: two channels, TH
  // apart), lane -> tile row er and 8-column chunk ek
  constexpr int kLanesPerCh = 4 * TH;
  const int esub = lane / kLanesPerCh;
  const int er = (lane % kLanesPerCh) >> 2, ek = lane & 3;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n = tile / (tiles_h * tiles_w);
    const int p0 = ((tile / tiles_w) % tiles_h) * TH - a.sr;
    const int q0 = (tile % tiles_w) * kTW - 7 - a.sc;
    const int rbase = S == 1 ? p0 - 2 : 2 * p0 - 3;
    const int cbase = S == 1 ? q0 - 2 : 2 * q0 - 4;
    const uint16_t* gn = a.g + static_cast<size_t>(n) * Co * plane;

    // -- g tile, pixel-major: 8 channels of one pixel per 16-byte store
    if (gvec) {
      // a unit: 8 channels x 8 columns (one aligned chunk) of one row, eight
      // 16-byte loads, transposed in registers; consecutive threads take
      // consecutive rows
      const int cal = cbase - (cbase & 7);
      for (int u = tid; u < NO * G::NCH * R; u += kThreads) {
        const int r = u % R, ch = (u / R) % G::NCH, og = u / (R * G::NCH);
        const int gr = rbase + r, gc0 = cal + 8 * ch;
        const bool ok = gr >= 0 && gr < H2 && gc0 >= 0 && gc0 < W2;
        const uint16_t* src = gn + (static_cast<size_t>(8 * og) * H2 + gr) * W2 + gc0;
        uint4 in[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          in[e] = ok && 8 * og + e < Co ? *reinterpret_cast<const uint4*>(src + e * plane)
                                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int px = 0; px < 8; ++px) {
          const int cc = gc0 + px - cbase;
          if (cc < 0 || cc >= CC) continue;
          const uint32_t sel = (px & 1) ? 0x7632u : 0x5410u;
          const uint4 o = make_uint4(__byte_perm(word(in[0], px / 2), word(in[1], px / 2), sel),
                                     __byte_perm(word(in[2], px / 2), word(in[3], px / 2), sel),
                                     __byte_perm(word(in[4], px / 2), word(in[5], px / 2), sel),
                                     __byte_perm(word(in[6], px / 2), word(in[7], px / 2), sel));
          *reinterpret_cast<uint4*>(s_g + g_slot<S>(r, cc) * OS + 8 * og) = o;
        }
      }
    } else {
      for (int u = tid; u < NO * R * CC; u += kThreads) {
        const int og = u / (R * CC), pix = u % (R * CC);
        const int r = pix / CC, cc = pix % CC;
        const int gr = rbase + r, gc = cbase + cc;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (gr >= 0 && gr < H2 && gc >= 0 && gc < W2) {
          const uint16_t* src = gn + (static_cast<size_t>(8 * og) * H2 + gr) * W2 + gc;
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const uint32_t lo = 8 * og + e < Co ? src[e * plane] : 0u;
            const uint32_t hi = 8 * og + e + 1 < Co ? src[(e + 1) * plane] : 0u;
            v[e / 2] = lo | (hi << 16);
          }
        }
        *reinterpret_cast<uint4*>(s_g + g_slot<S>(r, cc) * OS + 8 * og) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    itg::cp_async_wait_all();
    __syncthreads();

    // -- the products: warp w takes tile row w, cells 0..15 and 16..31
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      }
    }
    uint32_t abase[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) abase[mt] = smem_addr(s_g + (S * warp * RSL + 16 * mt + m) * OS);
    const uint32_t wbase = smem_addr(s_w);
#pragma unroll
    for (int s = 0; s < K::KS; ++s) {
      const uint32_t off = 2 * (hsel ? a_off<S, NO>(2 * s + 1) : a_off<S, NO>(2 * s));
      uint32_t af[2][4];
      ldmatrix_x4(af[0], abase[0] + off);
      ldmatrix_x4(af[1], abase[1] + off);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, wbase + 2 * ((16 * j + rr + 8 * (mi >> 1)) * K::WS + 16 * s + 8 * (mi & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * j], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * j + 1], af[mt], b[2], b[3]);
        }
      }
      if constexpr (NT % 2 == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, wbase + 2 * ((8 * (NT - 1) + rr) * K::WS + 16 * s + 8 * (mi & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], af[mt], b[0], b[1]);
      }
    }
    __syncthreads();  // every warp is done with the g tile: its space takes dP
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 16 * mt + (lane >> 2) + 8 * (e >> 1);
          s_d[warp * DRS + (8 * j + 2 * (lane & 3) + (e & 1)) * CS + col] = acc[mt][j][e];
        }
      }
    }
    __syncthreads();

    // -- epilogue: lane (er, ek) takes x's columns jb .. jb + 7 (cells q0 + 8
    // ek .. + 7) of tile row er for channel c = warp + TH esub + 8 i; the
    // folds as _fold_border adds them, where the tile holds an edge cell
    const int p = p0 + er;
    const bool no_folds = a.zeros || (p0 > 1 && p0 + TH - 1 < H && q0 > 1 && q0 + kTW - 1 < W);
    const int jb = q0 - 1 + 8 * ek;
    const bool row_ok = p >= 1 && p <= H;
    const bf16* xrow = a.x + (static_cast<size_t>(n) * C * H + p - 1) * W;
    bf16* dxrow = a.dx + (static_cast<size_t>(n) * C * H + p - 1) * W;
    const size_t cstride = static_cast<size_t>(H) * W;
    const int cfirst = warp + TH * esub;
    uint4 xq[NT];  // the lane's x chunks of every channel it takes, one round trip
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int c = cfirst + 8 * i;
      xq[i] = make_uint4(0u, 0u, 0u, 0u);
      if (xvec && row_ok && c < C && jb >= 0 && jb < W) {
        xq[i] = *reinterpret_cast<const uint4*>(xrow + c * cstride + jb);
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (warp + 8 * i >= C) break;  // warp-uniform
      const int c = cfirst + 8 * i;
      float xv[8];
      if (xvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t w = word(xq[i], e / 2);
          xv[e] = __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
        }
      } else if (row_ok && c < C) {
        load8(xv, xrow + c * cstride, jb, W);
      }
      float s1 = 0.f, s2 = 0.f;
      if (row_ok && c < C) {
        const float scv = a.scale[c], shv = a.shift[c];
        const float* d = s_d + c * CS;
        float da[8];  // dP with the folds, zero outside the image
        if (no_folds && xvec) {  // the lane's chunk lies wholly inside or outside
          const bool in = jb >= 0 && jb < W;
          const float4 lo = in ? *reinterpret_cast<const float4*>(d + er * DRS + 8 * ek)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 hi = in ? *reinterpret_cast<const float4*>(d + er * DRS + 8 * ek + 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
          da[0] = lo.x, da[1] = lo.y, da[2] = lo.z, da[3] = lo.w;
          da[4] = hi.x, da[5] = hi.y, da[6] = hi.z, da[7] = hi.w;
        } else {
          auto at = [&](int pp, int qq) { return d[(pp - p0) * DRS + qq - q0]; };
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int q = jb + e + 1;
            auto rowsum = [&](int pp) {
              float v = at(pp, q);
              if (!a.zeros) {
                if (q == 1) v += at(pp, 0);
                if (q == W) v += at(pp, W + 1);
              }
              return v;
            };
            da[e] = 0.f;
            if (q >= 1 && q <= W) {
              da[e] = rowsum(p);
              if (!a.zeros) {
                if (p == 1) da[e] += rowsum(0);
                if (p == H) da[e] += rowsum(H + 1);
              }
            }
          }
        }
        float out[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (a.relu && !(__fadd_rn(__fmul_rn(xv[e], scv), shv) > 0.f)) da[e] = 0.f;
          out[e] = __fmul_rn(da[e], scv);
          s1 = fmaf(da[e], xv[e], s1);
          s2 = __fadd_rn(s2, da[e]);
        }
        bf16* dst = dxrow + c * cstride;
        if (xvec) {
          if (jb >= 0 && jb < W) {
            uint4 o;
            o.x = itg::pack_bf16x2(out[0], out[1]);
            o.y = itg::pack_bf16x2(out[2], out[3]);
            o.z = itg::pack_bf16x2(out[4], out[5]);
            o.w = itg::pack_bf16x2(out[6], out[7]);
            *reinterpret_cast<uint4*>(dst + jb) = o;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (jb + e >= 0 && jb + e < W) dst[jb + e] = __float2bfloat16_rn(out[e]);
          }
        }
      }
#pragma unroll
      for (int o = kLanesPerCh / 2; o > 0; o >>= 1) {
        s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, o));
        s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, o));
      }
      if (lane % kLanesPerCh == 0 && c < C) {
        s_acc[c] = __fadd_rn(s_acc[c], s1);
        s_acc[Cp + c] = __fadd_rn(s_acc[Cp + c], s2);
      }
    }
    __syncthreads();  // the da tile is read before the next tile's g lands on it
  }
  for (int i = tid; i < C; i += kThreads) {
    float* out = a.part + static_cast<size_t>(blockIdx.x) * 2 * C;
    out[i] = s_acc[i];
    out[C + i] = s_acc[Cp + i];
  }
}

// The B operand: wp[c][u][v][o] (8 NT x T x T x 8 NO bf16, zero past C and
// Co) from w (Co, C, 3, 3) float32. K6: the flipped tap w[o][c][2 - u][2 -
// v]. K9: the combined stride-2 kernel of ops/kernels.py: _upconv_dx_weights,
// the rows combined first (K2 | K1 + K2 | K0 + K1 | K0), then the columns,
// in float32 with the same adds, rounded to bf16 after combining.
template <int S>
__global__ void chw_dx_tc_pack_kernel(const float* __restrict__ w, bf16* __restrict__ wp, int C,
                                      int Co, int cp, int cop) {
  constexpr int T = Geo<S>::T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cp * T * T * cop) return;
  const int o = i % cop, v = (i / cop) % T, u = (i / (cop * T)) % T, c = i / (cop * T * T);
  float val = 0.f;
  if (c < C && o < Co) {
    const float* k = w + (static_cast<size_t>(o) * C + c) * 9;  // k[3 ky + kx]
    if (S == 1) {
      val = k[3 * (2 - u) + 2 - v];
    } else {
      auto row = [&](int kx) {  // the combined row tap u at column kx
        return u == 0 ? k[6 + kx] : u == 1 ? __fadd_rn(k[3 + kx], k[6 + kx])
                                 : u == 2 ? __fadd_rn(k[kx], k[3 + kx]) : k[kx];
      };
      val = v == 0 ? row(2) : v == 1 ? __fadd_rn(row(1), row(2)) : v == 2 ? __fadd_rn(row(0), row(1))
                                                                          : row(0);
    }
  }
  wp[i] = __float2bfloat16_rn(val);
}

// d(scale)[c] and d(shift)[c] (entry e = blockIdx.x of 2C): the blocks'
// partials summed in one fixed order, thread t taking the blocks t, t + 256,
// ..., then a fixed tree over the threads.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
chw_dx_tc_reduce_kernel(const float* __restrict__ part, float* __restrict__ dsc,
                        float* __restrict__ dsh, int blocks, int C) {
  __shared__ float s_w[kReduceThreads / 32];
  const int e = blockIdx.x, t = threadIdx.x;
  float v = 0.f;
  for (int b = t; b < blocks; b += kReduceThreads) {
    v = __fadd_rn(v, part[static_cast<size_t>(b) * 2 * C + e]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((t & 31) == 0) s_w[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceThreads / 32; ++w) sum = __fadd_rn(sum, s_w[w]);
    if (e < C) {
      dsc[e] = sum;
    } else {
      dsh[e - C] = sum;
    }
  }
}

// One call: the weights packed, the persistent grid (as many blocks as the
// SMs hold, at most one per tile and at most `cap`, the partials' rows), then
// the sums.
template <int S, int NO, int NT>
int launch(DxArgs a, const float* w, float* dsc, float* dsh, int cap, cudaStream_t st) {
  using G = Geo<S>;
  const int packed = 8 * NT * G::T * G::T * 8 * NO;
  chw_dx_tc_pack_kernel<S><<<(packed + 255) / 256, 256, 0, st>>>(
      w, const_cast<bf16*>(a.wp), a.C, a.Co, 8 * NT, 8 * NO);
  if (int rc = itg::last_error()) return rc;
  const auto kernel = chw_dx_tc_kernel<S, NO, NT>;
  constexpr size_t smem = smem_bytes<S, NO, NT>();
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::kThreads,
                                                                    smem)) {
    return static_cast<int>(e);
  }
  // shift the tiling where a far border ring would start a tile of its own
  a.sr = !a.zeros && (a.H + 1) % G::TH == 0;
  a.sc = !a.zeros && a.W % kTW == kTW - 8 ? 8 : 0;
  const long tiles = static_cast<long>(a.N) * ((a.H + 2 + a.sr + G::TH - 1) / G::TH) *
                     ((a.W + 9 + a.sc + kTW - 1) / kTW);
  long blocks = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count();
  blocks = blocks < tiles ? blocks : tiles;
  blocks = blocks < cap ? blocks : cap;
  kernel<<<static_cast<int>(blocks), G::kThreads, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  chw_dx_tc_reduce_kernel<<<2 * a.C, kReduceThreads, 0, st>>>(a.part, dsc, dsh,
                                                             static_cast<int>(blocks), a.C);
  return itg::last_error();
}

template <int S, int NO>
int dispatch_nt(int nt, const DxArgs& a, const float* w, float* dsc, float* dsh, int cap,
                cudaStream_t st) {
  switch (nt) {
    case 1: return launch<S, NO, 1>(a, w, dsc, dsh, cap, st);
    case 2: return launch<S, NO, 2>(a, w, dsc, dsh, cap, st);
    case 4: return launch<S, NO, 4>(a, w, dsc, dsh, cap, st);
    case 7: return launch<S, NO, 7>(a, w, dsc, dsh, cap, st);
    case 8: return launch<S, NO, 8>(a, w, dsc, dsh, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int S>
int dispatch(const void* x, const void* g, const void* wt, const void* scale, const void* shift,
             void* wp, void* dx, void* part, void* dsc, void* dsh, int n, int c, int h, int w,
             int co, int relu, int zeros, int nt, int no, int cap, void* stream) {
  if (c > 8 * nt || co > 8 * no) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wf = static_cast<const float*>(wt);
  const DxArgs a{static_cast<const bf16*>(x), static_cast<const uint16_t*>(g),
                 static_cast<const bf16*>(wp), static_cast<const float*>(scale),
                 static_cast<const float*>(shift), static_cast<bf16*>(dx),
                 static_cast<float*>(part), n, c, h, w, co, relu, zeros, 0, 0};
  auto* s = static_cast<float*>(dsc);
  auto* b = static_cast<float*>(dsh);
  auto st = static_cast<cudaStream_t>(stream);
  switch (no) {
    case 1: return dispatch_nt<S, 1>(nt, a, wf, s, b, cap, st);
    case 2: return dispatch_nt<S, 2>(nt, a, wf, s, b, cap, st);
    case 4: return dispatch_nt<S, 4>(nt, a, wf, s, b, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K6 on the tensor cores. x (n, c, h, w), g (n, co, h, w), dx (n, c, h, w)
// bfloat16; w (co, c, 3, 3), scale, shift (c) float32; wp (8 nt, 3, 3, 8 no)
// bfloat16 scratch, written with the packed weights wp[c, u, v, o] = w[o, c,
// 2 - u, 2 - v] (nt in {1, 2, 4, 7, 8}, no in {1, 2, 4}); part (cap, 2, c)
// float32 scratch; dsc, dsh (c) float32, written. Three launches; returns
// the first CUDA error (cudaErrorInvalidValue for an nt or no the kernels do
// not take).
extern "C" int itg_conv3x3_chw_dx_tc(const void* x, const void* g, const void* w,
                                     const void* scale, const void* shift, void* wp, void* dx,
                                     void* part, void* dsc, void* dsh, int n, int c, int h,
                                     int width, int co, int relu, int zeros, int nt, int no,
                                     int cap, void* stream) {
  return dispatch<1>(x, g, w, scale, shift, wp, dx, part, dsc, dsh, n, c, h, width, co, relu,
                     zeros, nt, no, cap, stream);
}

// K9 dx on the tensor cores. x (n, c, h, w) half-res, g (n, co, 2h, 2w), dx
// (n, c, h, w) bfloat16; w (co, c, 3, 3) float32; wp (8 nt, 4, 4, 8 no)
// bfloat16 scratch, written with bf16(wt[o, c, u, v]) of the combined
// stride-2 kernels (ops/kernels.py: _upconv_dx_weights); the rest as
// itg_conv3x3_chw_dx_tc.
extern "C" int itg_upconv3x3_chw_dx_tc(const void* x, const void* g, const void* w,
                                       const void* scale, const void* shift, void* wp, void* dx,
                                       void* part, void* dsc, void* dsh, int n, int c, int h,
                                       int width, int co, int relu, int zeros, int nt, int no,
                                       int cap, void* stream) {
  return dispatch<2>(x, g, w, scale, shift, wp, dx, part, dsc, dsh, n, c, h, width, co, relu,
                     zeros, nt, no, cap, stream);
}
