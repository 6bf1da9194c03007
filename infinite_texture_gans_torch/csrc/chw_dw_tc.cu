// The weight-side gradient of the generator tail's 3x3 convolution on the
// tensor cores, for bfloat16 activations:
//   K7 _conv3x3_chw_dw (infinite_texture_gans_tpu/ops/pallas_conv.py:888,
//      kernel _dw_kernel :807), the dW and db of conv3x3(pad1(act(scale * x
//      + shift))):
//   dW[o, c, ky, kx] = sum_{n, h, w} g[n, o, h, w] * A[n, c, h + ky, w + kx],
//   db[o] = sum_{n, h, w} g[n, o, h, w],
// where A is the padded post-norm input the forward read: act(scale * x +
// shift) computed with no FMA contraction (__fmul_rn, __fadd_rn, ReLU) and
// rounded to bf16, as common.cuh: prenorm computes it, with a replicate ring
// (the edge copied) or a zero ring. Both operands are bf16 values, so every
// product is exact in float32 and the kernel computes the plain version's
// function (ops/kernels.py: conv3x3_chw_dw_plain); only the order of the
// float32 sums differs. Float32 activations keep the CUDA-core kernel of
// conv3x3_chw_bwd.cu.
//
// What bounds it on the H100: 2 * 9 * C * Co FLOPs per pixel against 2 (C +
// Co) bytes of x and g; at the training shapes (C, Co <= 52) under 300 FLOPs
// per byte, so bytes bound it (3.35 TB/s; the products at 989 bf16 TFLOP/s
// take a fifth of that time or less). The output is tiny (9 C Co floats) and
// the reduction huge (K = N H W pixels, up to 8 x 384^2). The design:
// - Implicit GEMM on warp-level mma.sync m16n8k16 (bf16 operands, float32
//   sums), one GEMM per tap: M = the input channels c (padded to MT x 16:
//   13 -> 16, 26 -> 32, 52 -> 64), N = the output channels o (padded to NO x
//   8: 3 -> 8, 13 -> 16, 26 -> 32), K = the pixels of a tile. c is M because
//   C >= Co at every tail shape: Co = 3 (the final conv) wastes 5 of 8
//   columns, where o as M would waste 13 of 16 rows.
// - A tile of TH x TW output pixels of one image. Its post-norm input, the
//   (TH + 2) x (TW + 2) padded pixels it reads, is staged in shared memory
//   pixel-major: one row of channels per pixel, an odd number of 16-byte
//   units per row and an odd number of pixel slots per tile row, so that
//   ldmatrix's eight row addresses and the staging's 16-byte stores hit
//   distinct banks. A tap's shift (ky, kx) is then a row-address offset, and
//   ldmatrix.trans turns the pixel-major rows into the A fragment (K along
//   pixels). x lands raw (channels-major, columns w0 - 8 .. w0 + 39 of the
//   tile's rows and halo rows) as one TMA box, whose out-of-range elements
//   (the image's border, channels past C) arrive as zeros; a thread then takes
//   eight channels of 8 columns (or of one halo column), applies the BN fold,
//   the ReLU and the bf16 rounding in registers and transposes the values to
//   pixels by packing, one pixel's channels a store. Where a
//   tile holds a replicate ring, the ring's pixel rows are copied from the
//   edge's after staging (the columns first, then the rows, so a corner gets
//   the corner value).
// - g needs no shift: staged channels-major as it lies in device memory
//   (16-byte cp.async, a row of the tile's pixels per output channel, an odd
//   number of 16-byte units per row), its rows are the B fragment as
//   ldmatrix reads them without transposing.
// - The accumulators: 9 MT NO m16n8 tiles (up to 144 at C = 52, Co = 26).
//   The 8 warps of a block split the (tap, m16 tile) pairs into PG groups
//   and the tile's k16 steps into KS = 8 / PG slices; PG is the fewest that
//   keeps a warp at 16 or fewer m16n8 tiles (64 float registers; 20 at C =
//   52, Co = 26, where PG = 8 is the most). A warp
//   loads its B fragments once per k16 step and reuses them for every pair.
// - Persistent blocks (as many as the SMs hold, at most one per tile) walk
//   the tiles blockIdx.x, + gridDim.x, ...; each accumulates its tiles in
//   registers. A ring of stages (raw x and g of one tile each) keeps the
//   copies of the next tiles in flight while a tile is staged and
//   multiplied. Two blocks an SM where the shared memory holds them (a
//   second block's products overlap one block's staging), then as many
//   stages as fit; at C <= 32, Co > 16 A takes its tile's raw buffer so that
//   the second block fits. At the end the k-slices of a block are added in a fixed order
//   through shared memory, and the block writes its float32 partial dW and
//   db; a last launch sums the partials over the blocks in one fixed order.
//   No atomics: two calls give the same bits.
// - db is summed from the staged g tile by 8 threads per output channel, in
//   a fixed order, and rides along in the partials.
// The stride-2 weight gradient of the up-conv (K9 dW) takes this design at
// half resolution, with four B operands: upconv_dw_tc.cu.
#include "chw_dw_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::ldmatrix_x2;
using itg::ldmatrix_x4;
using itg::ldmatrix_x4_trans;
using itg::mma_bf16;
using itg::smem_addr;
using itg::dw::aligned16;
using itg::dw::bf16_hi;
using itg::dw::bf16_lo;
using itg::dw::blocks_for;
using itg::dw::DwArgs;
using itg::dw::kAP;
using itg::dw::kThreads;
using itg::dw::kTW;
using itg::dw::kWarps;
using itg::dw::load_cols;
using itg::dw::pick_stages;
using itg::dw::smem_for;
using itg::dw::Tile;
using itg::dw::word;

constexpr int kTH = 8;             // output rows per tile
constexpr int kSteps = kTH * kTW / 16;
constexpr int kGS = kTH * kTW + 8;  // bf16 per staged g row (an odd number of 16-byte units)
// floats of a block's partial: the C fragments of every (tap, m16 tile) pair
// and n8 tile in fragment order, then db (8 NO)
__host__ __device__ constexpr int part_entries(int mt, int no) {
  return 9 * mt * no * 128 + 8 * no;
}

// The configuration of MT m16 tiles of input channels and NO n8 tiles of
// output channels.
template <int MT, int NO>
struct Cfg {
  static constexpr int Cp = 16 * MT;
  static constexpr int AS = Cp + 8;  // bf16 per staged pixel: Cp / 8 + 1 units, odd
  using A = itg::dw::Slab<kTH, Cp, AS>;
  static constexpr int P = 9 * MT;   // (tap, m16 tile) pairs
  static constexpr int PG = P * NO <= 16 ? 1
                            : (P + 1) / 2 * NO <= 16 ? 2
                            : (P + 3) / 4 * NO <= 16 ? 4
                                                     : 8;
  static constexpr int PP = (P + PG - 1) / PG;  // pairs per warp (the last may be short)
  static constexpr int KS = kWarps / PG;        // k-slices
  static constexpr int Cop = 8 * NO;
  static constexpr size_t a_bytes = A::a_bytes;
  static constexpr size_t box_bytes = A::box_bytes;  // a tile's raw x
  static constexpr size_t g_bytes = sizeof(bf16) * Cop * kGS;
  static constexpr size_t red_bytes = sizeof(float) * PG * PP * NO * 4 * 32;
  // scale | shift, then an mbarrier per stage
  static constexpr size_t fixed_bytes =
      sizeof(float) * 2 * Cp + sizeof(uint64_t) * itg::dw::kMaxStages;
  // A in a buffer of its own, or in place of its tile's raw x (a second
  // barrier a tile: every raw value is read before A is written), which
  // only pays where it fits a second block an SM (C <= 32, Co > 16)
  static constexpr size_t in_place_raw =
      ((box_bytes > a_bytes ? box_bytes : a_bytes) + 127) / 128 * 128;
  static constexpr int kStagesApart =
      pick_stages(box_bytes + g_bytes, a_bytes, red_bytes, fixed_bytes);
  static constexpr int kStagesInPlace =
      pick_stages(in_place_raw + g_bytes, 0, red_bytes, fixed_bytes);
  static constexpr bool kInPlace =
      blocks_for(kStagesInPlace, in_place_raw + g_bytes, 0, red_bytes, fixed_bytes) >= 2 &&
      blocks_for(kStagesApart, box_bytes + g_bytes, a_bytes, red_bytes, fixed_bytes) < 2;
  static constexpr size_t raw_bytes = kInPlace ? in_place_raw : box_bytes;  // 128-byte multiples
  static constexpr size_t stage_bytes = raw_bytes + g_bytes;                  // one tile in flight
  static constexpr size_t a_apart = kInPlace ? 0 : a_bytes;
  static constexpr int kStages = kInPlace ? kStagesInPlace : kStagesApart;
  static constexpr size_t smem = smem_for(kStages, stage_bytes, a_apart, red_bytes, fixed_bytes);
  static constexpr int kMinBlocks =
      blocks_for(kStages, stage_bytes, a_apart, red_bytes, fixed_bytes) >= 2 ? 2 : 1;
};

// Starts the copies of tile t into one stage of shared memory: its raw x
// (Slab::start_copy) and its g (Cop rows of the kTH x kTW pixels, row-major;
// zeros outside the image and past Co) by 16-byte cp.async (element loads
// where unaligned), as one cp.async group. Consecutive threads take
// consecutive pieces of a row.
template <int MT, int NO>
__device__ __forceinline__ void start_copies(const DwArgs& a, const void* tmap, const Tile& t,
                                             bf16* s_raw, bf16* s_g, uint64_t* bar, bool gvec) {
  constexpr int Cop = Cfg<MT, NO>::Cop;
  const int H = a.H, W = a.W, Co = a.Co;
  const size_t plane = static_cast<size_t>(H) * W;
  Cfg<MT, NO>::A::start_copy(a, tmap, t, s_raw, bar);
  const bf16* gn = a.g + static_cast<size_t>(t.n) * Co * plane;
  for (int u = threadIdx.x; u < Cop * kTH * (kTW / 8); u += kThreads) {
    const int k8 = u % (kTW / 8), r = (u / (kTW / 8)) % kTH, o = u / (kTH * kTW / 8);
    const int gh = t.h0 + r, gw = t.w0 + 8 * k8;
    bf16* dst = s_g + o * kGS + r * kTW + 8 * k8;
    const bool ok = o < Co && gh < H;
    const bf16* row = gn + o * plane + static_cast<size_t>(ok ? gh : 0) * W;
    if (gvec && ok && gw < W) {
      itg::cp_async16(dst, row + gw);
    } else if (gvec) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      load_cols(dst, row, gw, 8, W, ok);
    }
  }
  itg::cp_async_commit();
}

// Grid (blocks), kThreads threads, dynamic shared memory Cfg::smem:
// [kStages x (raw x: Cp x (kTH + 2) x kRW bf16, g: Cop rows of kGS bf16)][A:
// kTH + 2 rows of kAP pixels of AS bf16, unless kInPlace puts each tile's A
// over its raw x] (the k-slices' sums reuse the space at the end)[scale |
// shift: 2 Cp floats][an mbarrier per stage]. A ring of
// kStages stages keeps kStages - 1 tiles' copies in flight: per tile, the
// raw x that landed is turned into A (BN fold, ReLU, bf16, pixel-major),
// the stage then takes a later tile's copies, and the ring, db and the
// products of this tile run while they fly. tmap: x (N, C, H, W) as a 4-D
// tensor map with box (kRW, kTH + 2, Cp, 1), where a.tma.
template <int MT, int NO>
__global__ void __launch_bounds__(kThreads, (Cfg<MT, NO>::kMinBlocks))
chw_dw_tc_kernel(const DwArgs a, const __grid_constant__ CUtensorMap tmap) {
  using K = Cfg<MT, NO>;
  using A = typename K::A;
  constexpr int AS = K::AS, Cp = K::Cp, Cop = K::Cop, PP = K::PP, PG = K::PG, KS = K::KS;
  constexpr int S = K::kStages;
  static_assert(K::raw_bytes % 128 == 0 && K::stage_bytes % 128 == 0,
                "TMA boxes need 128-byte alignment");
  extern __shared__ __align__(128) unsigned char smem[];
  auto raw_of = [&](int i) { return reinterpret_cast<bf16*>(smem + (i % S) * K::stage_bytes); };
  auto g_of = [&](int i) {
    return reinterpret_cast<bf16*>(smem + (i % S) * K::stage_bytes + K::raw_bytes);
  };
  bf16* s_a_apart = reinterpret_cast<bf16*>(smem + S * K::stage_bytes);  // unless kInPlace
  float* s_red = reinterpret_cast<float*>(smem);  // after the last tile
  float* s_sc = reinterpret_cast<float*>(smem + K::smem - K::fixed_bytes);
  float* s_sh = s_sc + Cp;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_sh + Cp);
  const void* tmap_p = &tmap;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, H = a.H, W = a.W, Co = a.Co;
  const bool gvec = W % 8 == 0 && aligned16(a.g);
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
      start_copies<MT, NO>(a, tmap_p, tile_of(i), raw_of(i), g_of(i), s_bar + i % S, gvec);
    } else {
      itg::cp_async_commit();  // an empty group keeps the count
    }
  }

  // this warp's pairs p = pg + PG i: tap p / MT, m16 tile p % MT; the byte
  // offset of the pair's A rows from the k16 step's base
  const int pg = warp % PG, ks = warp / PG;
  uint32_t aoff[PP];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    const int p = pg + PG * i;
    const int tap = p / MT, mt = p % MT;
    aoff[i] = 2 * (((tap / 3) * kAP + tap % 3) * AS + 16 * mt);
  }
  const bool last_ok = pg + PG * (PP - 1) < K::P;  // the warp's last pair exists
  // ldmatrix lanes: A (transposed) rows are pixels k = (lane & 7) + 8 (lane >>
  // 4) at channel offset 8 ((lane >> 3) & 1); B rows are output channels
  const int a_pix = (lane & 7) + 8 * (lane >> 4), a_ch = 8 * ((lane >> 3) & 1);
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t a_lane = 2 * (a_pix * AS + a_ch);

  float acc[PP][NO][4];
#pragma unroll
  for (int i = 0; i < PP; ++i) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  // db: 8 threads per output channel, each an eighth of the tile's pixels
  const int db_o = tid >> 3, db_seg = tid & 7;
  float db_acc = 0.f;

  for (int it = 0; it < mine; ++it) {
    const Tile t = tile_of(it);
    const int h0 = t.h0, w0 = t.w0;
    const bf16* s_raw = raw_of(it);
    bf16* s_a = K::kInPlace ? raw_of(it) : s_a_apart;
    const bf16* s_g = g_of(it);
    if (a.tma) itg::mbar_wait(s_bar + it % S, (it / S) & 1);
    itg::cp_async_wait_group<S - 2>();
    __syncthreads();  // this tile's copies landed; the last tile's products are done

    // -- A (Slab::load and store): one unit, 8 channels of a staged row, at a
    // time. With A in place of the raw tile every unit of the thread is read
    // before a barrier and stored after it.
    constexpr int kPerThread = (A::kUnits + kThreads - 1) / kThreads;
    if constexpr (K::kInPlace) {
      uint4 px[kPerThread][8];
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int u = tid + q * kThreads;
        if (u < A::kUnits) {
          A::load(u, s_raw, s_sc, s_sh, h0, w0, H, W, a.relu,
                  [&](int i, const uint4& v) { px[q][i] = v; });
        }
      }
      __syncthreads();  // the raw tile is read: A takes its place
#pragma unroll
      for (int q = 0; q < kPerThread; ++q) {
        const int u = tid + q * kThreads;
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // a halo unit has pixel 0 only
          if (u < A::kUnits && (i == 0 || u < A::kInner)) A::store(u, i, px[q][i], s_a);
        }
      }
    } else {
      for (int u = tid; u < A::kUnits; u += kThreads) {
        A::load(u, s_raw, s_sc, s_sh, h0, w0, H, W, a.relu,
                [&](int i, const uint4& v) { A::store(u, i, v, s_a); });
      }
    }
    __syncthreads();  // A is staged

    // -- a later tile's copies (into the stage of the tile before this one,
    // whose products are done), in flight during this tile's products
    if (it + S - 1 < mine) {
      start_copies<MT, NO>(a, tmap_p, tile_of(it + S - 1), raw_of(it + S - 1),
                           g_of(it + S - 1), s_bar + (it + S - 1) % S, gvec);
    } else {
      itg::cp_async_commit();
    }

    // -- the replicate ring inside this tile
    if (!a.zeros) A::ring(s_a, h0, w0, H, W);

    // this thread's writes of A come before a later TMA copy into its buffer
    itg::fence_proxy_async();

    // -- db from the staged g (zero outside the image and past Co)
    if (db_o < Cop) {
      constexpr int kSeg = kTH * kTW / 8;  // pixels per thread
      const uint4* src = reinterpret_cast<const uint4*>(s_g + db_o * kGS + kSeg * db_seg);
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

    // -- the products: k16 step st (tile row st / (kTW / 16), columns 16 (st %
    // (kTW / 16)) ..)
    const uint32_t a_base = smem_addr(s_a) + a_lane;
    const uint32_t g_base = smem_addr(s_g);
#pragma unroll 2
    for (int st = ks; st < kSteps; st += KS) {
      const int row = st / (kTW / 16), col = 16 * (st % (kTW / 16));
      uint32_t b[NO][2];
#pragma unroll
      for (int j = 0; j + 1 < NO; j += 2) {
        uint32_t f[4];
        ldmatrix_x4(f, g_base + 2 * ((8 * j + rr + 8 * (mi >> 1)) * kGS + 16 * st + 8 * (mi & 1)));
        b[j][0] = f[0], b[j][1] = f[1], b[j + 1][0] = f[2], b[j + 1][1] = f[3];
      }
      if constexpr (NO % 2 == 1) {
        uint32_t f[2];
        ldmatrix_x2(f, g_base + 2 * ((8 * (NO - 1) + rr) * kGS + 16 * st + 8 * (mi & 1)));
        b[NO - 1][0] = f[0], b[NO - 1][1] = f[1];
      }
      const uint32_t a_step = a_base + 2 * ((row * kAP + col) * AS);
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        if (i == PP - 1 && !last_ok) break;  // warp-uniform
        uint32_t af[4];
        ldmatrix_x4_trans(af, a_step + aoff[i]);
#pragma unroll
        for (int j = 0; j < NO; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
  }

  // -- the block's sums: k-slices KS - 1, ..., 1 added onto slice 0 in turn
  // through shared memory, then slice 0 writes the partial in fragment order
  // (part_entries: coalesced stores; the last launch maps it to dW)
  float* out = a.part + static_cast<size_t>(blockIdx.x) * part_entries(MT, NO);
  __syncthreads();
  float* red = s_red + static_cast<size_t>(pg) * PP * NO * 4 * 32;
#pragma unroll 1
  for (int k = KS - 1; k > 0; --k) {
    if (ks == k) {
#pragma unroll
      for (int i = 0; i < PP; ++i) {
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((i * NO + j) * 4 + e) * 32 + lane] = acc[i][j][e];
        }
      }
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < PP; ++i) {
#pragma unroll
        for (int j = 0; j < NO; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] = __fadd_rn(acc[i][j][e], red[((i * NO + j) * 4 + e) * 32 + lane]);
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
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[((p * NO + j) * 4 + e) * 32 + lane] = acc[i][j][e];
      }
    }
  }
  // db: the 8 threads of a channel in a fixed tree
#pragma unroll
  for (int m = 4; m > 0; m >>= 1) {
    db_acc = __fadd_rn(db_acc, __shfl_xor_sync(0xffffffffu, db_acc, m));
  }
  if (db_seg == 0 && db_o < Cop) out[K::P * NO * 128 + db_o] = db_acc;
}

// dW and db: entry e of a partial, the blocks' partials summed in one fixed
// order, then mapped from fragment order to dW (co, c, 3, 3) and db. A block
// takes 32 entries (a warp's coalesced columns) x 32 segments: segment s adds
// the rows s, s + 32, ..., then the segments are added in order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
chw_dw_tc_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                        float* __restrict__ db, int blocks, int mt_tiles, int no, int C, int Co) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int E = part_entries(mt_tiles, no), Efrag = 9 * mt_tiles * no * 128;
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
    if (e >= Efrag) {
      if (e - Efrag < Co) db[e - Efrag] = v;
      return;
    }
    // entry ((p no + j) 4 + q) 32 + lane: pair p (tap p / mt, m16 tile p %
    // mt), n8 tile j, accumulator q of the lane's C fragment
    const int lane = e % 32, q = (e / 32) % 4, j = (e / 128) % no, p = e / (128 * no);
    const int tap = p / mt_tiles, c = 16 * (p % mt_tiles) + lane / 4 + 8 * (q >> 1);
    const int o = 8 * j + 2 * (lane % 4) + (q & 1);
    if (c < C && o < Co) dw[(static_cast<size_t>(o) * C + c) * 9 + tap] = v;
  }
}

// One call: x's tensor map (where its rows are 16-byte aligned), the
// persistent grid (as many blocks as the SMs hold, at most one per tile and
// at most `cap`, the partials' rows), then the sums.
template <int MT, int NO>
int launch(DwArgs a, float* dw, float* db, int cap, cudaStream_t st) {
  CUtensorMap tmap{};
  if (int rc = itg::dw::x_tensor_map(a, kTH + 2, Cfg<MT, NO>::Cp, &tmap)) return rc;
  const auto kernel = chw_dw_tc_kernel<MT, NO>;
  constexpr size_t smem = Cfg<MT, NO>::smem;
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                    smem)) {
    return static_cast<int>(e);
  }
  const long tiles = static_cast<long>(a.N) * ((a.H + kTH - 1) / kTH) * ((a.W + kTW - 1) / kTW);
  long blocks = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count();
  blocks = blocks < tiles ? blocks : tiles;
  blocks = blocks < cap ? blocks : cap;
  kernel<<<static_cast<int>(blocks), kThreads, smem, st>>>(a, tmap);
  if (int rc = itg::last_error()) return rc;
  const int e = part_entries(MT, NO);
  chw_dw_tc_reduce_kernel<<<(e + kRedEntries - 1) / kRedEntries, kRedEntries * kRedSegs, 0, st>>>(
      a.part, dw, db, static_cast<int>(blocks), MT, NO, a.C, a.Co);
  return itg::last_error();
}

template <int MT>
int dispatch_no(int no, const DwArgs& a, float* dw, float* db, int cap, cudaStream_t st) {
  switch (no) {
    case 1: return launch<MT, 1>(a, dw, db, cap, st);
    case 2: return launch<MT, 2>(a, dw, db, cap, st);
    case 4: return launch<MT, 4>(a, dw, db, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K7 on the tensor cores. x (n, c, h, w), g (n, co, h, w) bfloat16; scale,
// shift (c) float32; part (cap, 9 mt no 128 + 8 no) float32 scratch; dw (co, c, 3,
// 3) and db (co) float32, written (not accumulated). mt in {1, 2, 4} m16
// tiles of input channels (c <= 16 mt), no in {1, 2, 4} n8 tiles of output
// channels (co <= 8 no). Two launches; returns the first CUDA error
// (cudaErrorInvalidValue for an mt or no the kernels do not take).
extern "C" int itg_conv3x3_chw_dw_tc(const void* x, const void* g, const void* scale,
                                     const void* shift, void* part, void* dw, void* db, int n,
                                     int c, int h, int width, int co, int relu, int zeros, int mt,
                                     int no, int cap, void* stream) {
  if (c > 16 * mt || co > 8 * no || cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DwArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                 static_cast<const float*>(scale), static_cast<const float*>(shift),
                 static_cast<float*>(part), n, c, h, width, co, relu, zeros, 0};
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return dispatch_no<1>(no, a, w, b, cap, st);
    case 2: return dispatch_no<2>(no, a, w, b, cap, st);
    case 4: return dispatch_no<4>(no, a, w, b, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
