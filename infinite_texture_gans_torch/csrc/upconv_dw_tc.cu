// The weight-side gradient of the fused up-conv (K9 dW) on the tensor cores,
// for bfloat16 activations:
//   K9 dW _upconv3x3_dw (infinite_texture_gans_tpu/ops/pallas_conv.py:1777,
//      kernel _updw_kernel :1673), per phase tap of the half-res phase form
//      (csrc/upconv_fwd_f32.cu's header has the algebra):
//   dwc[o, c, ((di * 2 + dj) * 2 + r) * 2 + s] =
//       sum_{n, i, j} g[n, o, 2i + di, 2j + dj] * A[n, c, i + di + r, j + dj + s],
//   db[o] = sum g,
// where A is the padded post-norm half-res slab: act(scale * x + shift) with
// no FMA contraction, rounded to bf16 (common.cuh: prenorm), with a
// replicate or a zero ring. Both operands are bf16 values, so every product
// is exact in float32 and the kernel computes the plain version's function
// (ops/kernels.py: upconv3x3_chw_dw_plain, the 3 x 3 dW of the upsampled
// slab); only the order of the float32 sums differs. The wrapper folds dwc
// back to 3 x 3 in float32 (_upconv_unpack_dw). Float32 activations take the
// CUDA-core kernel of upconv_dw_f32.cu.
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per half-res pixel
// against 2 (C + 4 Co) bytes of x and g (at 52 -> 26: 43k FLOPs for 312
// bytes), so bytes (3.35 TB/s); g is two thirds of them. The design is K7's
// (chw_dw_tc.cu) at half resolution with four B operands:
// - Implicit GEMM on mma.sync m16n8k16 per (phase, tap): M = the input
//   channels (MT x 16), N = the output channels (NO x 8), K = the half-res
//   pixels of a tile of kTH x kTW.
// - A is staged by K7's code (chw_dw_tc.cuh: Slab): x's raw tile and its
//   halo land as one TMA box, a thread folds BN, ReLU and the bf16 rounding
//   into 8 channels x 8 columns in registers and stores them pixel-major
//   (odd 16-byte units a pixel, odd pixel slots a row), the replicate ring
//   copied from the edge.
//   A phase tap's shift (di + r, dj + s) is then a row address of
//   ldmatrix.trans: the 16 phase taps read 9 distinct shifts of one tile.
// - g's full-res rows of the tile (the phase rows the block takes, 2 kTW
//   columns each) land raw by 16-byte cp.async, channels-major as they lie
//   in device memory, each byte read once; a pass then splits each 16-byte
//   unit's columns by parity into the phase's B rows (four even, four odd
//   values, 8 bytes each). A B row (output channel o, phase (di, dj)) holds
//   the tile's pixels in order, so ldmatrix reads it without a transpose, as
//   K7 reads g.
// - Registers: all 16 phase taps make 16 MT NO m16n8 tiles (256 at 52 -> 26,
//   64 at 26 -> 13). A warp owns (phase, m16 tile) pairs with their 4 taps
//   and keeps at most 16 tiles (64 float registers). Where the 16 phase taps
//   do not fit the 8 warps that way (MT NO > 8), the phase row di is
//   blockIdx.y and the block stages only g's rows of parity di (A, the
//   smaller operand, is then read twice): 52 -> 26 takes di as a grid axis
//   (8 pairs, one a warp); 26 -> 13 keeps all four phases in a block (8 pairs,
//   two a warp, two k-slices).
// - Persistent blocks walk the tiles blockIdx.x, + gridDim.x, ... A ring of
//   stages (raw x and g of one tile each) keeps the next tiles' copies in
//   flight while a tile is staged and multiplied; two blocks an SM where the
//   shared memory holds them (26 -> 13), else one with more stages
//   (52 -> 26).
// - Each block adds its k-slices in a fixed order through shared memory and
//   writes float32 partials of dwc and db (fragment order); a last launch sums
//   the partials over the blocks (and, for db, over the phase rows) in one
//   fixed order. No atomics: two calls give the same bits. db is summed from
//   the staged B rows by 8 threads an output channel in a fixed order.
#include "chw_dw_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::ldmatrix_x2;
using itg::ldmatrix_x4;
using itg::ldmatrix_x4_trans;
using itg::mma_bf16;
using itg::smem_addr;
using itg::dw::bf16_hi;
using itg::dw::bf16_lo;
using itg::dw::DwArgs;
using itg::dw::kAP;
using itg::dw::kThreads;
using itg::dw::kTW;
using itg::dw::kWarps;
using itg::dw::Tile;
using itg::dw::word;

constexpr int kTH = 4;                  // half-res rows per tile
constexpr int kSteps = kTH * kTW / 16;
constexpr int kGW = 2 * kTW;            // full-res columns of a raw g row
constexpr int kBS = kTH * kTW + 8;      // bf16 per B row (an odd number of 16-byte units)

// The phase rows a block takes: both where all 16 phase taps of every m16
// tile fit 8 warps at 16 m16n8 tiles a warp (MT NO <= 8), else one (the
// phase row is blockIdx.y). ops/kernels.py: upconv_dw_tc_plan mirrors it.
__host__ __device__ constexpr int phase_rows(int mt, int no) { return mt * no <= 8 ? 2 : 1; }

// floats of a block's partial: the C fragments of every (phase, m16 tile)
// pair, tap and n8 tile in fragment order, then db (8 NO)
__host__ __device__ constexpr int part_entries(int mt, int no) {
  return 2 * phase_rows(mt, no) * mt * 4 * no * 128 + 8 * no;
}

// The configuration of MT m16 tiles of input channels and NO n8 tiles of
// output channels.
template <int MT, int NO>
struct Cfg {
  static constexpr int Cp = 16 * MT;
  static constexpr int AS = Cp + 8;  // bf16 per staged pixel: Cp / 8 + 1 units, odd
  using A = itg::dw::Slab<kTH, Cp, AS>;
  static constexpr int Cop = 8 * NO;
  static constexpr int PH = phase_rows(MT, NO);
  static constexpr int NPH = 2 * PH;  // phases per block
  static constexpr int P = NPH * MT;  // (phase, m16 tile) pairs, 4 taps each
  static constexpr int PG = P * 4 * NO <= 16 ? 1
                            : (P + 1) / 2 * 4 * NO <= 16 ? 2
                            : (P + 3) / 4 * 4 * NO <= 16 ? 4
                                                         : 8;
  static constexpr int PP = (P + PG - 1) / PG;  // pairs per warp (the last may be short)
  static constexpr int KS = kWarps / PG;        // k-slices
  static constexpr size_t a_bytes = A::a_bytes;
  static constexpr size_t b_bytes = sizeof(bf16) * NPH * Cop * kBS;
  static constexpr size_t box_bytes = A::box_bytes;  // a tile's raw x
  static constexpr size_t graw_bytes = sizeof(bf16) * Cop * PH * kTH * kGW;
  static constexpr size_t red_bytes = sizeof(float) * PG * PP * 4 * NO * 4 * 32;
  // scale | shift, then an mbarrier per stage
  static constexpr size_t fixed_bytes =
      sizeof(float) * 2 * Cp + sizeof(uint64_t) * itg::dw::kMaxStages;
  static constexpr size_t stage_bytes = box_bytes + graw_bytes;  // 128-byte multiples
  static constexpr int kStages =
      itg::dw::pick_stages(stage_bytes, a_bytes + b_bytes, red_bytes, fixed_bytes);
  static constexpr size_t smem =
      itg::dw::smem_for(kStages, stage_bytes, a_bytes + b_bytes, red_bytes, fixed_bytes);
  static constexpr int kMinBlocks =
      itg::dw::blocks_for(kStages, stage_bytes, a_bytes + b_bytes, red_bytes, fixed_bytes) >= 2
          ? 2
          : 1;
  static_assert(P * 4 * NO <= 16 * kWarps, "the accumulators do not fit 8 warps");
};

// Starts the copies of tile t into one stage of shared memory: its raw x
// (Slab::start_copy) and its raw g (for each output channel o < Cop, phase
// row d < PH and tile row tr, the full-res row 2 (h0 + tr) + di, columns 2
// w0 .. 2 w0 + kGW - 1; zeros outside the image and past Co) by 16-byte
// cp.async (element loads where unaligned), as one cp.async group.
// Consecutive threads take consecutive pieces of a row.
template <int MT, int NO>
__device__ __forceinline__ void start_copies(const DwArgs& a, const void* tmap, const Tile& t,
                                             bf16* s_raw, bf16* s_graw, uint64_t* bar, bool gvec) {
  constexpr int Cop = Cfg<MT, NO>::Cop, PH = Cfg<MT, NO>::PH;
  const int Co = a.Co, H2 = 2 * a.H, W2 = 2 * a.W;
  Cfg<MT, NO>::A::start_copy(a, tmap, t, s_raw, bar);
  const int di0 = PH == 1 ? static_cast<int>(blockIdx.y) : 0;
  const bf16* gn = a.g + static_cast<size_t>(t.n) * Co * H2 * W2;
  for (int u = threadIdx.x; u < Cop * PH * kTH * (kGW / 8); u += kThreads) {
    const int k8 = u % (kGW / 8), tr = (u / (kGW / 8)) % kTH, d = (u / (kGW / 8 * kTH)) % PH;
    const int o = u / (kGW / 8 * kTH * PH);
    const int gr = 2 * (t.h0 + tr) + di0 + d, gc = 2 * t.w0 + 8 * k8;
    bf16* dst = s_graw + ((o * PH + d) * kTH + tr) * kGW + 8 * k8;
    const bool ok = o < Co && gr < H2;
    const bf16* row = gn + (static_cast<size_t>(o < Co ? o : 0) * H2 + (ok ? gr : 0)) * W2;
    if (gvec && ok && gc < W2) {
      itg::cp_async16(dst, row + gc);
    } else if (gvec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      itg::dw::load_cols(dst, row, gc, 8, W2, ok);
    }
  }
  itg::cp_async_commit();
}

// Grid (blocks, 2 / PH), kThreads threads, dynamic shared memory Cfg::smem:
// [kStages x (raw x: Cp x (kTH + 2) x kRW bf16, raw g: Cop x PH x kTH x kGW
// bf16)][A: kTH + 2 rows of kAP pixels of AS bf16][B: NPH x Cop rows of kBS
// bf16] (the
// k-slices' sums reuse the space at the start)[scale | shift: 2 Cp
// floats][an mbarrier per stage]. A ring of kStages stages keeps kStages - 1
// tiles' copies in flight: per tile, the raw x that landed is turned into A
// (BN fold, ReLU, bf16, pixel-major) and the raw g into B (split by column
// parity), the stage then takes a later tile's copies, and the ring, db and
// the products of this tile run while they fly. tmap: x (N, C, H, W) as a
// 4-D tensor map with box (kRW, kTH + 2, Cp, 1), where a.tma. With PH = 1 the
// block takes phase row di = blockIdx.y.
template <int MT, int NO>
__global__ void __launch_bounds__(kThreads, (Cfg<MT, NO>::kMinBlocks))
upconv_dw_tc_kernel(const DwArgs a, const __grid_constant__ CUtensorMap tmap) {
  using K = Cfg<MT, NO>;
  using A = typename K::A;
  constexpr int AS = K::AS, Cp = K::Cp, Cop = K::Cop, PP = K::PP, PG = K::PG, KS = K::KS;
  constexpr int PH = K::PH, S = K::kStages;
  static_assert(K::box_bytes % 128 == 0 && K::stage_bytes % 128 == 0,
                "TMA boxes need 128-byte alignment");
  extern __shared__ __align__(128) unsigned char smem[];
  auto raw_of = [&](int i) { return reinterpret_cast<bf16*>(smem + (i % S) * K::stage_bytes); };
  auto graw_of = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (i % S) * K::stage_bytes + K::box_bytes);
  };
  bf16* s_a = reinterpret_cast<bf16*>(smem + S * K::stage_bytes);
  bf16* s_b = reinterpret_cast<bf16*>(smem + S * K::stage_bytes + K::a_bytes);
  float* s_red = reinterpret_cast<float*>(smem);  // after the last tile
  float* s_sc = reinterpret_cast<float*>(smem + K::smem - K::fixed_bytes);
  float* s_sh = s_sc + Cp;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_sh + Cp);
  const void* tmap_p = &tmap;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, H = a.H, W = a.W;
  const bool gvec = W % 4 == 0 && itg::dw::aligned16(a.g);  // full-res rows of 8-column units
  const int tiles_h = (H + kTH - 1) / kTH, tiles_w = (W + kTW - 1) / kTW;
  const int n_tiles = a.N * tiles_h * tiles_w;
  // this block's tiles blockIdx.x + gridDim.x i, i < mine
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto tile_of = [&](int i) {
    return itg::dw::tile_at<kTH>(blockIdx.x + static_cast<int>(gridDim.x) * i, tiles_h, tiles_w);
  };

  for (int i = tid; i < Cp; i += kThreads) {
    s_sc[i] = i < C ? a.scale[i] : 0.f;
    s_sh[i] = i < C ? a.shift[i] : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < S; ++i) itg::mbar_init(s_bar + i, 1);
    itg::mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < mine) {
      start_copies<MT, NO>(a, tmap_p, tile_of(i), raw_of(i), graw_of(i), s_bar + i % S, gvec);
    } else {
      itg::cp_async_commit();  // an empty group keeps the count
    }
  }

  // this warp's pairs p = pg + PG i: phase p / MT (local: the block's phase
  // row d = phase >> 1, column parity dj = phase & 1), m16 tile p % MT; the
  // byte offsets of the pair's B rows and of its taps' A rows from the k16
  // step's bases
  const int pg = warp % PG, ks = warp / PG;
  const int di0 = PH == 1 ? static_cast<int>(blockIdx.y) : 0;
  uint32_t boff[PP], aoff[PP][4];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    const int p = pg + PG * i;
    const int ph = p / MT, mt = p % MT;
    const int di = di0 + (ph >> 1), dj = ph & 1;
    boff[i] = 2 * (ph * Cop * kBS);
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int r = tap >> 1, s = tap & 1;
      aoff[i][tap] = 2 * (((di + r) * kAP + dj + s) * AS + 16 * mt);
    }
  }
  const bool last_ok = pg + PG * (PP - 1) < K::P;  // the warp's last pair exists
  // ldmatrix lanes: A (transposed) rows are pixels k = (lane & 7) + 8 (lane >>
  // 4) at channel offset 8 ((lane >> 3) & 1); B rows are output channels
  const int a_pix = (lane & 7) + 8 * (lane >> 4), a_ch = 8 * ((lane >> 3) & 1);
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t a_lane = 2 * (a_pix * AS + a_ch);

  float acc[PP][4][NO][4];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][tap][j][e] = 0.f;
      }
    }
  }
  // db: 8 threads per output channel, each an eighth of every B row's pixels
  const int db_o = tid >> 3, db_seg = tid & 7;
  float db_acc = 0.f;

  for (int it = 0; it < mine; ++it) {
    const Tile t = tile_of(it);
    const int h0 = t.h0, w0 = t.w0;
    const bf16* s_raw = raw_of(it);
    const bf16* s_graw = graw_of(it);
    if (a.tma) itg::mbar_wait(s_bar + it % S, (it / S) & 1);
    itg::cp_async_wait_group<S - 2>();
    __syncthreads();  // this tile's copies landed; the last tile's products are done

    // -- A (Slab::load and store): one unit, 8 channels of a staged row, at a
    // time
    for (int u = tid; u < A::kUnits; u += kThreads) {
      A::load(u, s_raw, s_sc, s_sh, h0, w0, H, W, a.relu,
              [&](int i, const uint4& v) { A::store(u, i, v, s_a); });
    }
    // -- B: each raw 16-byte unit (8 full-res columns 2 w0 + 8 k8 .. of one
    // row) gives 4 even columns to phase (d, 0) and 4 odd ones to (d, 1), at
    // pixels tr kTW + 4 k8 .. of the channel's B row
    for (int u = tid; u < Cop * PH * kTH * (kGW / 8); u += kThreads) {
      const int k8 = u % (kGW / 8), tr = (u / (kGW / 8)) % kTH, d = (u / (kGW / 8 * kTH)) % PH;
      const int o = u / (kGW / 8 * kTH * PH);
      const uint4 v = *reinterpret_cast<const uint4*>(s_graw + ((o * PH + d) * kTH + tr) * kGW +
                                                      8 * k8);
      bf16* even = s_b + ((2 * d) * Cop + o) * kBS + tr * kTW + 4 * k8;
      *reinterpret_cast<uint2*>(even) =
          make_uint2(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.z, v.w, 0x5410));
      *reinterpret_cast<uint2*>(even + Cop * kBS) =
          make_uint2(__byte_perm(v.x, v.y, 0x7632), __byte_perm(v.z, v.w, 0x7632));
    }
    __syncthreads();  // A and B are staged; this tile's stage is free

    // -- a later tile's copies (into the stage of the tile before this one),
    // in flight during this tile's products
    if (it + S - 1 < mine) {
      start_copies<MT, NO>(a, tmap_p, tile_of(it + S - 1), raw_of(it + S - 1),
                           graw_of(it + S - 1), s_bar + (it + S - 1) % S, gvec);
    } else {
      itg::cp_async_commit();
    }

    // -- the replicate ring inside this tile
    if (!a.zeros) A::ring(s_a, h0, w0, H, W);

    // -- db from the staged B rows (zero outside the image and past Co)
    if (db_o < Cop) {
      constexpr int kSeg = kTH * kTW / 8;  // pixels per thread and phase
#pragma unroll
      for (int ph = 0; ph < 2 * PH; ++ph) {
        const uint4* src =
            reinterpret_cast<const uint4*>(s_b + (ph * Cop + db_o) * kBS + kSeg * db_seg);
#pragma unroll
        for (int q = 0; q < kSeg / 8; ++q) {
          const uint4 v = src[q];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            db_acc = __fadd_rn(db_acc, bf16_lo(word(v, e)));
            db_acc = __fadd_rn(db_acc, bf16_hi(word(v, e)));
          }
        }
      }
    }

    // -- the products: k16 step st (tile row st / (kTW / 16), columns 16 (st %
    // (kTW / 16)) ..); per pair its phase's B, then its 4 taps
    const uint32_t a_base = smem_addr(s_a) + a_lane;
    const uint32_t b_base = smem_addr(s_b);
#pragma unroll 2
    for (int st = ks; st < kSteps; st += KS) {
      const int row = st / (kTW / 16), col = 16 * (st % (kTW / 16));
      const uint32_t a_step = a_base + 2 * ((row * kAP + col) * AS);
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        if (i == PP - 1 && !last_ok) break;  // warp-uniform
        const uint32_t b_pair = b_base + boff[i];
        uint32_t b[NO][2];
#pragma unroll
        for (int j = 0; j + 1 < NO; j += 2) {
          uint32_t f[4];
          ldmatrix_x4(f, b_pair + 2 * ((8 * j + rr + 8 * (mi >> 1)) * kBS + 16 * st + 8 * (mi & 1)));
          b[j][0] = f[0], b[j][1] = f[1], b[j + 1][0] = f[2], b[j + 1][1] = f[3];
        }
        if constexpr (NO % 2 == 1) {
          uint32_t f[2];
          ldmatrix_x2(f, b_pair + 2 * ((8 * (NO - 1) + rr) * kBS + 16 * st + 8 * (mi & 1)));
          b[NO - 1][0] = f[0], b[NO - 1][1] = f[1];
        }
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, a_step + aoff[i][tap]);
#pragma unroll
          for (int j = 0; j < NO; ++j) mma_bf16(acc[i][tap][j], af, b[j][0], b[j][1]);
        }
      }
    }
  }

  // -- the block's sums: k-slices KS - 1, ..., 1 added onto slice 0 in turn
  // through shared memory, then slice 0 writes the partial in fragment order
  // (part_entries: coalesced stores; the last launch maps it to dwc)
  float* out = a.part + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                            part_entries(MT, NO);
  constexpr int kPair = 4 * NO * 4 * 32;  // floats of a pair's fragments
  __syncthreads();
  float* red = s_red + static_cast<size_t>(pg) * PP * kPair;
#pragma unroll 1
  for (int k = KS - 1; k > 0; --k) {
    if (ks == k) {
#pragma unroll
      for (int i = 0; i < PP; ++i) {
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
#pragma unroll
          for (int j = 0; j < NO; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              red[i * kPair + ((tap * NO + j) * 4 + e) * 32 + lane] = acc[i][tap][j][e];
            }
          }
        }
      }
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < PP; ++i) {
#pragma unroll
        for (int tap = 0; tap < 4; ++tap) {
#pragma unroll
          for (int j = 0; j < NO; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][tap][j][e] = __fadd_rn(acc[i][tap][j][e],
                                            red[i * kPair + ((tap * NO + j) * 4 + e) * 32 + lane]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  if (ks == 0) {
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const int p = pg + PG * i;
      if (p >= K::P) break;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            out[(((p * 4 + tap) * NO + j) * 4 + e) * 32 + lane] = acc[i][tap][j][e];
          }
        }
      }
    }
  }
  // db: the 8 threads of a channel in a fixed tree
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) {
    db_acc = __fadd_rn(db_acc, __shfl_xor_sync(0xffffffffu, db_acc, m));
  }
  if (db_seg == 0 && db_o < Cop) out[K::P * kPair + db_o] = db_acc;
}

// dwc and db: an entry of the partials summed over the blocks in one fixed
// order, then mapped from fragment order to dwc (co, c, 16) and db. Entry v
// < gy Efrag is fragment entry v % Efrag of phase row block v / Efrag,
// summed over its `blocks` rows; entry gy Efrag + o is db[o], summed over
// all gy x blocks rows. A block takes 32 entries (a warp's coalesced
// columns) x 32 segments: segment s adds the rows s, s + 32, ..., then the
// segments are added in order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
upconv_dw_tc_reduce_kernel(const float* __restrict__ part, float* __restrict__ dwc,
                           float* __restrict__ db, int blocks, int gy, int mt_tiles, int no, int C,
                           int Co) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int E = part_entries(mt_tiles, no), Efrag = E - 8 * no;
  const int le = threadIdx.x % kRedEntries, seg = threadIdx.x / kRedEntries;
  const int v = blockIdx.x * kRedEntries + le;
  const bool is_db = v >= gy * Efrag;
  const bool valid = v < gy * Efrag + 8 * no;
  // the rows this entry sums and its column
  const int row0 = is_db ? 0 : v / Efrag, rows = is_db ? gy * blocks : blocks;
  const int e = is_db ? Efrag + (v - gy * Efrag) : v % Efrag;
  float sum = 0.f;
  if (valid) {
    for (int b = seg; b < rows; b += kRedSegs) {
      sum = __fadd_rn(sum, part[(static_cast<size_t>(row0) * blocks + b) * E + e]);
    }
  }
  s_sum[seg][le] = sum;
  __syncthreads();
  if (seg != 0 || !valid) return;
#pragma unroll
  for (int s = 1; s < kRedSegs; ++s) sum = __fadd_rn(sum, s_sum[s][le]);
  if (is_db) {
    if (e - Efrag < Co) db[e - Efrag] = sum;
    return;
  }
  // entry (((p 4 + tap) no + j) 4 + q) 32 + lane: pair p (the block's phase
  // p / mt, m16 tile p % mt), tap (r, s) = (tap >> 1, tap & 1), n8 tile j,
  // accumulator q of the lane's C fragment
  const int lane = e % 32, q = (e / 32) % 4, j = (e / 128) % no, tap = (e / (128 * no)) % 4;
  const int p = e / (512 * no);
  const int ph = (gy == 2 ? 2 * row0 : 0) + p / mt_tiles;  // (di, dj) = (ph >> 1, ph & 1)
  const int c = 16 * (p % mt_tiles) + lane / 4 + 8 * (q >> 1);
  const int o = 8 * j + 2 * (lane % 4) + (q & 1);
  if (c < C && o < Co) dwc[(static_cast<size_t>(o) * C + c) * 16 + ph * 4 + tap] = sum;
}

// One call: x's tensor map (where its rows are 16-byte aligned), the
// persistent grid (as many blocks as the SMs hold, split over the phase rows,
// at most one per tile and at most `cap` per phase row), then the sums.
template <int MT, int NO>
int launch(DwArgs a, float* dwc, float* db, int cap, cudaStream_t st) {
  using K = Cfg<MT, NO>;
  CUtensorMap tmap{};
  if (int rc = itg::dw::x_tensor_map(a, kTH + 2, K::Cp, &tmap)) return rc;
  const auto kernel = upconv_dw_tc_kernel<MT, NO>;
  constexpr size_t smem = K::smem;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                    smem)) {
    return static_cast<int>(e);
  }
  const int gy = 2 / K::PH;
  const long tiles = static_cast<long>(a.N) * ((a.H + kTH - 1) / kTH) * ((a.W + kTW - 1) / kTW);
  long blocks = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count() / gy;
  blocks = blocks > 1 ? blocks : 1;
  blocks = blocks < tiles ? blocks : tiles;
  blocks = blocks < cap ? blocks : cap;
  kernel<<<dim3(static_cast<unsigned>(blocks), gy), kThreads, smem, st>>>(a, tmap);
  if (int rc = itg::last_error()) return rc;
  const int entries = gy * (part_entries(MT, NO) - 8 * NO) + 8 * NO;
  upconv_dw_tc_reduce_kernel<<<(entries + kRedEntries - 1) / kRedEntries, kRedEntries * kRedSegs,
                               0, st>>>(a.part, dwc, db, static_cast<int>(blocks), gy, MT, NO, a.C,
                                        a.Co);
  return itg::last_error();
}

template <int MT>
int dispatch_no(int no, const DwArgs& a, float* dwc, float* db, int cap, cudaStream_t st) {
  switch (no) {
    case 1: return launch<MT, 1>(a, dwc, db, cap, st);
    case 2: return launch<MT, 2>(a, dwc, db, cap, st);
    case 4: return launch<MT, 4>(a, dwc, db, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K9 dW on the tensor cores. x (n, c, h, w) half resolution and g (n, co, 2h,
// 2w) bfloat16; scale, shift (c) float32; part (2 / ph x cap, part_entries)
// float32 scratch, ph = 2 where mt no <= 8, else 1; dwc (co, c, 16) per phase
// tap and db (co) float32, written (not accumulated). mt in {1, 2, 4} m16
// tiles of input channels (c <= 16 mt), no in {1, 2, 4} n8 tiles of output
// channels (co <= 8 no). Two launches; returns the first CUDA error
// (cudaErrorInvalidValue for an mt or no the kernels do not take).
extern "C" int itg_upconv3x3_chw_dw_tc(const void* x, const void* g, const void* scale,
                                       const void* shift, void* part, void* dwc, void* db, int n,
                                       int c, int h, int width, int co, int relu, int zeros,
                                       int mt, int no, int cap, void* stream) {
  if (c > 16 * mt || co > 8 * no || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DwArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                 static_cast<const float*>(scale), static_cast<const float*>(shift),
                 static_cast<float*>(part), n, c, h, width, co, relu, zeros, 0};
  auto* w = static_cast<float*>(dwc);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return dispatch_no<1>(no, a, w, b, cap, st);
    case 2: return dispatch_no<2>(no, a, w, b, cap, st);
    case 4: return dispatch_no<4>(no, a, w, b, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
