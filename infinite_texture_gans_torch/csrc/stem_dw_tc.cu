// The discriminator stem's weight gradient on the tensor cores, for
// bfloat16: for the 4x4 / stride-2 / zero-pad-1 convolution of the
// channels-major fake image x (N, C, H, W), C <= 4 (3 on the path), with the
// NHWC cotangent g (N, H/2, W/2, Co),
//   dW[o, c, ky, kx] = sum_{n, i, j} g[n, i, j, o] * x[n, c, 2i + ky - 1, 2j + kx - 1]
//                      (zero outside x),
//   db[o] = sum_{n, i, j} g[n, i, j, o].
// Both operands are bf16 values, so every product is exact in float32 and
// the kernel computes the plain version's function (ops/kernels.py:
// stem_dw_plain); only the order of the float32 sums differs.
//
// Replaces K13 dW infinite_texture_gans_tpu/ops/pallas_conv.py:
// _stem_dw_call (:2840, kernel _stem_dw_kernel :2788), reached through
// conv4x4s2_stem_chw (:3086). Float32 takes the CUDA-core kernel of
// stem_dw_f32.cu.
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per output pixel against
// 2 Co bytes of g and 8 C bytes of x (C = 3, Co = 64: 6,144 FLOPs for 152
// bytes), so bytes, and g is 84% of them. The design:
// - One GEMM, as the reference computes it (pallas_conv.py:2809-2813): M = the
//   16 C taps, m = 16 c + 4 ky + kx (one m16 tile per input channel: three at
//   C = 3), N = the output channels (n8 groups), K = the output pixels of a
//   tile (4 rows x 32), on warp-level mma.sync m16n8k16 (bf16 operands,
//   float32 sums).
// - B straight from g: a tile's NHWC rows are pixel-major rows of Co
//   channels, copied by 16-byte cp.async (a ring of stages, so the next tiles'
//   copies fly while a tile is multiplied) into rows of an odd number of
//   16-byte units; ldmatrix.trans turns them into the B fragment. Where Co is
//   no multiple of 8 (a pixel's channels are then not 16-byte units) or g is
//   not 16-byte aligned, the same rows are staged element by element; channels
//   past Co are zero.
// - A from shifted copies of x: the stride-2 taps kx = 0 and 2 read the odd
//   columns one element apart (as do kx = 1 and 3 the even ones), which no
//   16-byte row address can start at. So each staged input row is kept as
//   four arrays S_kx[j] = x[2 (j0 + j) + kx - 1], j < 32 (zero outside the
//   image), of an odd number of 16-byte units each: the A fragment of tap row
//   m = 4 ky + kx and 8 consecutive pixels is then one 16-byte row at
//   S_kx of staged row 2 tr + ky, and ldmatrix reads the m16 tile of a channel
//   (ky 0..3, kx 0..3) without a transpose; its 8 row addresses fall in
//   distinct banks. A thread loads 16-byte units of 8 input columns (into
//   registers, one tile ahead) and splits them by parity into the four
//   arrays (x is 16% of the bytes); element by element where W is no
//   multiple of 8 or x is not 16-byte aligned.
// - Warps: the n8 groups of the block's (up to) 64 output channels in pairs
//   (NG <= 4 groups of 16) x 8 / NG k-slices of the tile's 8 k16 steps; a
//   warp keeps C x 2 m16n8 tiles (at most 32 float registers). Co above 64
//   is split across blockIdx.y (--D_ch up to kMaxCo); a Co that is no
//   multiple of 8 zero-pads its last n8 group.
// - db rides on the B fragments: each lane adds the g values it holds, in a
//   fixed order.
// - Persistent blocks walk the tiles blockIdx.x, + gridDim.x, ...; at the end
//   each adds its k-slices in a fixed order through shared memory and writes
//   its float32 partial dW and db (in dW's own layout); a last launch sums the
//   partials over the blocks in one fixed order. No atomics: two calls give
//   the same bits.
#include "common.cuh"
#include "mma.cuh"
#include "stem_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::ldmatrix_x4;
using itg::ldmatrix_x4_trans;
using itg::mma_bf16;
using itg::smem_addr;

using itg::stem::kChunks;  // 16-byte units per input row
using itg::stem::kRows;    // staged input rows per channel
using itg::stem::kTJ;      // output pixels per tile row: two k16 steps
using itg::stem::kTR;      // output rows per tile
using itg::stem::Tile;
using itg::stem::tile_at;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTP = kTR * kTJ;             // pixels per tile
constexpr int kSteps = kTP / 16;
constexpr int kSL = 56;    // bf16 per S_kx array (7 16-byte units, odd); entry j at slot j + kSOff
constexpr int kSOff = 8;
constexpr int kCoBlock = 64;               // output channels per block (blockIdx.y splits more)
constexpr int kGS = kCoBlock + 8;          // bf16 per staged g pixel at most (odd 16-byte units)
constexpr int kStages = 3;
constexpr int kMaxCo = 512;  // --D_ch's limit, as the forward's (stem_fwd_tc.cu: kMaxCo)

constexpr size_t kGStage = sizeof(bf16) * kTP * kGS;

template <int C>
__host__ __device__ constexpr size_t x_bytes() {
  return sizeof(bf16) * C * kRows * 4 * kSL;
}

template <int C>
__host__ __device__ constexpr size_t smem_bytes() {
  return kStages * kGStage + x_bytes<C>() + sizeof(float) * kWarps * 16;
}

// floats of a block's partial: dW (Co, C, 4, 4) then db (Co), in place
__host__ __device__ constexpr int part_entries(int c, int co) { return co * (16 * c + 1); }

// Chunks of 16 bytes a thread loads per tile.
template <int C>
__host__ __device__ constexpr int chunks_per_thread() {
  return (C * kRows * kChunks + kThreads - 1) / kThreads;
}

struct StemDwArgs {
  const uint16_t* x;  // (N, C, H, W)
  const uint16_t* g;  // (N, H/2, W/2, Co)
  float* part;        // (gridDim.x, part_entries)
  int N, H, W, Co;
  int xvec;  // x by 16-byte units: W % 8 == 0 and x 16-byte aligned
  int gvec;  // g by 16-byte units: Co % 8 == 0 and g 16-byte aligned
};

// Unit q's values e0..e7 (input columns 2 j0 - 8 + 8k + e) into the four
// shifted arrays of their staged row: S1[4k - 4 ..] = e0 e2 e4 e6 and
// S2[4k - 4 ..] = e1 e3 e5 e7 (8-byte stores), S0[4k - 3 ..] = e1 e3 e5 e7
// and S3[4k - 5 ..] = e0 e2 e4 e6 (a half, a word, a half). Every slot has
// one writer; entries outside 0 .. kTJ - 1 land in the arrays' slack.
__device__ __forceinline__ void store_chunk(uint16_t* s_x, int q, const uint4& v) {
  const int row = q / kChunks;  // c * kRows + rr
  const int k = q % kChunks;
  uint16_t* s0 = s_x + row * 4 * kSL + kSOff;
  uint16_t* s1 = s0 + kSL;
  uint16_t* s2 = s1 + kSL;
  uint16_t* s3 = s2 + kSL;
  *reinterpret_cast<uint2*>(s1 + 4 * k - 4) =
      make_uint2(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.z, v.w, 0x5410));
  *reinterpret_cast<uint2*>(s2 + 4 * k - 4) =
      make_uint2(__byte_perm(v.x, v.y, 0x7632), __byte_perm(v.z, v.w, 0x7632));
  s0[4 * k - 3] = static_cast<uint16_t>(v.x >> 16);
  *reinterpret_cast<uint32_t*>(s0 + 4 * k - 2) = __byte_perm(v.y, v.z, 0x7632);
  s0[4 * k] = static_cast<uint16_t>(v.w >> 16);
  s3[4 * k - 5] = static_cast<uint16_t>(v.x & 0xffffu);
  *reinterpret_cast<uint32_t*>(s3 + 4 * k - 4) = __byte_perm(v.y, v.z, 0x5410);
  s3[4 * k - 2] = static_cast<uint16_t>(v.w & 0xffffu);
}

// The element-wise staging of a tile's x (W % 8 != 0 or x unaligned).
template <int C>
__device__ __forceinline__ void stage_x_scalar(const StemDwArgs& a, const Tile& tl,
                                               uint16_t* s_x) {
  for (int idx = threadIdx.x; idx < C * kRows * 4 * kTJ; idx += kThreads) {
    const int j = idx % kTJ;
    const int kx = (idx / kTJ) % 4;
    const int row = idx / (4 * kTJ);  // c * kRows + rr
    const int c = row / kRows;
    const int gr = 2 * tl.i0 - 1 + row % kRows;
    const int gc = 2 * (tl.j0 + j) + kx - 1;
    uint16_t v = 0;
    if (gr >= 0 && gr < a.H && gc >= 0 && gc < a.W) {
      v = a.x[((static_cast<size_t>(tl.n) * C + c) * a.H + gr) * a.W + gc];
    }
    s_x[(row * 4 + kx) * kSL + kSOff + j] = v;
  }
}

// Starts the copies of tile tl's g into a stage: pixel p (row p / kTJ, column
// p % kTJ of the tile) at p * gs, the block's output channels o0 .. o0 + 16
// ng - 1 (zero past Co and outside the image); one cp.async group.
__device__ __forceinline__ void copy_g(const StemDwArgs& a, const Tile& tl, uint16_t* s_g, int o0,
                                       int ng, int gs) {
  const int H2 = a.H / 2, W2 = a.W / 2, Co = a.Co;
  const int units = 2 * ng;  // 8-channel units per pixel
  for (int u = threadIdx.x; u < kTP * units; u += kThreads) {
    const int p = u / units, q = u % units;
    const int i = tl.i0 + p / kTJ, j = tl.j0 + p % kTJ, oc = o0 + 8 * q;
    uint16_t* dst = s_g + p * gs + 8 * q;
    const bool in = i < H2 && j < W2;
    const uint16_t* src = a.g + ((static_cast<size_t>(tl.n) * H2 + (in ? i : 0)) * W2 +
                                 (in ? j : 0)) * Co;
    if (a.gvec) {
      if (in && oc < Co) {
        itg::cp_async16(dst, src + oc);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = in && oc + e < Co ? src[oc + e] : uint16_t{0};
    }
  }
  itg::cp_async_commit();
}

// Grid (blocks, ceil(Co / 64)), kThreads threads, dynamic shared memory
// smem_bytes<C>: [kStages g stages of kTP x kGS bf16][x: C x kRows rows x 4
// arrays of kSL bf16][db sums: kWarps x 16 floats] (the k-slices' sums reuse
// the g stages at the end).
template <int C>
__global__ void __launch_bounds__(kThreads, 2) stem_dw_tc_kernel(StemDwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = chunks_per_thread<C>();
  constexpr int kQ = C * kRows * kChunks;
  uint16_t* s_g = reinterpret_cast<uint16_t*>(smem);
  uint16_t* s_x = reinterpret_cast<uint16_t*>(smem + kStages * kGStage);
  float* s_red = reinterpret_cast<float*>(smem);  // after the last tile
  float* s_db = reinterpret_cast<float*>(smem + kStages * kGStage + x_bytes<C>());
  auto g_of = [&](int i) { return s_g + (i % kStages) * (kGStage / sizeof(bf16)); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Co = a.Co;
  const int o0 = blockIdx.y * kCoBlock;
  const int noc = (min(kCoBlock, Co - o0) + 7) / 8;  // the block's n8 groups with channels
  const int ng = noc <= 2 ? 1 : noc <= 4 ? 2 : 4;  // groups of two n8 tiles (a warp's)
  const int gs = 16 * ng + 8;                      // bf16 per staged pixel: 2 ng + 1 units
  const int ksn = kWarps / ng;                     // k-slices
  const int wg = warp % ng, wk = warp / ng;
  const int it_n = (a.H / 2 + kTR - 1) / kTR, jt_n = (a.W / 2 + kTJ - 1) / kTJ;
  const long tiles = static_cast<long>(a.N) * it_n * jt_n;
  // this block's tiles blockIdx.x + gridDim.x i, i < mine
  const int mine = static_cast<int>((tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto tile_of = [&](int i) {
    return tile_at(blockIdx.x + static_cast<long>(gridDim.x) * i, it_n, jt_n);
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) {
      copy_g(a, tile_of(i), g_of(i), o0, ng, gs);
    } else {
      itg::cp_async_commit();  // an empty group keeps the count
    }
  }
  uint4 pre[kPer];
  if (a.xvec) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = tid + u * kThreads;
      if (q < kQ) store_chunk(s_x, q, itg::stem::load_chunk<C>(a.x, a.H, a.W, tile_of(0), q));
    }
    if (1 < mine) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int q = tid + u * kThreads;
        if (q < kQ) pre[u] = itg::stem::load_chunk<C>(a.x, a.H, a.W, tile_of(1), q);
      }
    }
  } else {
    stage_x_scalar<C>(a, tile_of(0), s_x);
  }

  // ldmatrix lanes: matrix mi = lane >> 3, row rr = lane & 7. A (channel c's
  // m16 tile): tap row m = 8 (mi & 1) + rr, pixels 8 (mi >> 1) ..; staged row
  // 2 tr + ky, array kx = m at row (8 tr + m) of the channel's 4 kRows arrays.
  // B (n8 tiles 2 wg, 2 wg + 1): pixel 8 (mi & 1) + rr of the step, channels
  // 8 (2 wg + (mi >> 1)) ..
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t a_lane = 2 * ((8 * (mi & 1) + rr) * kSL + kSOff + 8 * (mi >> 1));
  const uint32_t b_lane = 2 * ((8 * (mi & 1) + rr) * gs + 8 * (2 * wg + (mi >> 1)));
  float acc[C][2][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    }
  }
  float db_acc[2] = {0.f, 0.f};  // output channel 8 (2 wg + j) + lane / 4, this lane's pixels

  for (int it = 0; it < mine; ++it) {
    itg::cp_async_wait_group<kStages - 2>();
    __syncthreads();  // this tile's g and x are staged; the last tile's products are done
    if (it + kStages - 1 < mine) {
      copy_g(a, tile_of(it + kStages - 1), g_of(it + kStages - 1), o0, ng, gs);
    } else {
      itg::cp_async_commit();
    }

    const uint32_t a_base = smem_addr(s_x) + a_lane;
    const uint32_t b_base = smem_addr(g_of(it)) + b_lane;
#pragma unroll 2
    for (int st = wk; st < kSteps; st += ksn) {
      const int tr = st / (kTJ / 16), j0 = 16 * (st % (kTJ / 16));
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_base + 2 * (16 * st * gs));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t w = b[2 * j + h];
          db_acc[j] = __fadd_rn(db_acc[j], __uint_as_float(w << 16));
          db_acc[j] = __fadd_rn(db_acc[j], __uint_as_float(w & 0xffff0000u));
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        uint32_t af[4];
        ldmatrix_x4(af, a_base + 2 * ((c * kRows * 4 + 8 * tr) * kSL + j0));
        mma_bf16(acc[c][0], af, b[0], b[1]);
        mma_bf16(acc[c][1], af, b[2], b[3]);
      }
    }
    __syncthreads();  // x's arrays are read
    if (it + 1 < mine) {
      if (a.xvec) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int q = tid + u * kThreads;
          if (q < kQ) store_chunk(s_x, q, pre[u]);
        }
        if (it + 2 < mine) {
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int q = tid + u * kThreads;
            if (q < kQ) pre[u] = itg::stem::load_chunk<C>(a.x, a.H, a.W, tile_of(it + 2), q);
          }
        }
      } else {
        stage_x_scalar<C>(a, tile_of(it + 1), s_x);
      }
    }
  }

  // -- the block's sums. db: the lane's pixels, then the 4 lanes of a channel
  // in a fixed tree. The k-slices in a fixed order through shared memory: every
  // warp stores its fragments, then each entry of the block's chunk adds the
  // slices 0, 1, ... in turn and is written in dW's layout.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    db_acc[j] = __fadd_rn(db_acc[j], __shfl_xor_sync(0xffffffffu, db_acc[j], 1));
    db_acc[j] = __fadd_rn(db_acc[j], __shfl_xor_sync(0xffffffffu, db_acc[j], 2));
  }
  itg::cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_red[((warp * C + c) * 2 + j) * 128 + e * 32 + lane] = acc[c][j][e];
      }
    }
  }
  if ((lane & 3) == 0) {
    s_db[warp * 16 + lane / 4] = db_acc[0];
    s_db[warp * 16 + 8 + lane / 4] = db_acc[1];
  }
  __syncthreads();
  const int cvalid = min(kCoBlock, Co - o0);
  float* out = a.part + static_cast<size_t>(blockIdx.x) * part_entries(C, Co);
  for (int idx = tid; idx < cvalid * 16 * C; idx += kThreads) {
    const int ol = idx / (16 * C), m = idx % (16 * C);
    // output channel ol: warp group ol / 16, n8 tile j, column 2 t + (e & 1);
    // tap row m: m16 tile c, row gq + 8 (e >> 1)
    const int grp = ol / 16, j = (ol / 8) % 2, col = ol % 8;
    const int c = m / 16, r16 = m % 16;
    const int ln = (r16 & 7) * 4 + col / 2, e = (r16 >> 3) * 2 + (col & 1);
    float v = 0.f;
    for (int k = 0; k < ksn; ++k) {
      v = __fadd_rn(v, s_red[(((k * ng + grp) * C + c) * 2 + j) * 128 + e * 32 + ln]);
    }
    out[static_cast<size_t>(o0 + ol) * 16 * C + m] = v;
  }
  for (int ol = tid; ol < cvalid; ol += kThreads) {
    const int grp = ol / 16, j = (ol / 8) % 2;
    float v = 0.f;
    for (int k = 0; k < ksn; ++k) v = __fadd_rn(v, s_db[(k * ng + grp) * 16 + j * 8 + ol % 8]);
    out[static_cast<size_t>(Co) * 16 * C + o0 + ol] = v;
  }
}

// dW and db: entry e of the partials summed over the blocks in one fixed
// order (dW's layout, then db). A block takes 32 entries x 32 segments:
// segment s adds the rows s, s + 32, ..., then the segments are added in
// order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
stem_dw_tc_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                         float* __restrict__ db, int blocks, int C, int Co) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int E = part_entries(C, Co);
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
    if (e < Co * 16 * C) {
      dw[e] = v;
    } else {
      db[e - Co * 16 * C] = v;
    }
  }
}

// One call: the persistent grid (as many blocks as the SMs hold, split over
// the output-channel chunks, at most one per tile and at most `cap`), then
// the sums.
template <int C>
int launch(const StemDwArgs& a, float* dw, float* db, int cap, cudaStream_t st) {
  const auto kernel = stem_dw_tc_kernel<C>;
  constexpr size_t smem = smem_bytes<C>();
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                                    smem)) {
    return static_cast<int>(e);
  }
  const int gy = (a.Co + kCoBlock - 1) / kCoBlock;
  const long tiles = static_cast<long>(a.N) * ((a.H / 2 + kTR - 1) / kTR) *
                     ((a.W / 2 + kTJ - 1) / kTJ);
  if (tiles == 0) return static_cast<int>(cudaErrorInvalidValue);
  long blocks = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count() / gy;
  blocks = blocks > 1 ? blocks : 1;
  blocks = blocks < tiles ? blocks : tiles;
  blocks = blocks < cap ? blocks : cap;
  kernel<<<dim3(static_cast<unsigned>(blocks), gy), kThreads, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  const int e = part_entries(C, a.Co);
  stem_dw_tc_reduce_kernel<<<(e + kRedEntries - 1) / kRedEntries, kRedEntries * kRedSegs, 0,
                             st>>>(a.part, dw, db, static_cast<int>(blocks), C, a.Co);
  return itg::last_error();
}

}  // namespace

// K13 dW on the tensor cores. x (n, c, h, w) and g (n, h/2, w/2, co)
// bfloat16, 1 <= c <= 4, h and w even, 1 <= co <= kMaxCo; part (cap, co (16
// c + 1)) float32 scratch; dw (co, c, 4, 4) and db (co) float32, written (not
// accumulated). Two launches; returns the first CUDA error
// (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int itg_stem_dw_tc(const void* x, const void* g, void* part, void* dw, void* db, int n,
                              int c, int h, int width, int co, int cap, void* stream) {
  if (h % 2 || width % 2 || co < 1 || co > kMaxCo || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int xvec = width % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int gvec = co % 8 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const StemDwArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(g),
                     static_cast<float*>(part), n, h, width, co, xvec, gvec};
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(a, w, b, cap, st);
    case 2: return launch<2>(a, w, b, cap, st);
    case 3: return launch<3>(a, w, b, cap, st);
    case 4: return launch<4>(a, w, b, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
