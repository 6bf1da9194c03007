// The generator ResBlock's 1x1 shortcut and its weight gradient on the
// tensor cores, for bfloat16 activations:
//   K3 _conv1x1_chw_fwd (infinite_texture_gans_tpu/ops/pallas_conv.py:2276,
//      pallas_call :2311, kernel _conv1x1_kernel :2243), called through
//      conv1x1_chw (:2381), conv1x1_chw_add (:2412) and, with the per-channel
//      sums of the stored output, conv1x1_chw_add_stats (:2435): y = W x + b
//      (+ res) per pixel. Its dx is the same entry point with the transposed
//      weights and a zero bias, as the reference's _conv1x1_bwd_rule (:2397).
//      W and b are rounded to bf16 as the reference rounds them (:2389-2390,
//      :2418-2419, :2442-2444; Wᵀ through _conv1x1_impl, :2401-2402); the sum,
//      the bias and the residual are added in float32 and y is rounded once.
//   K3-dW _conv1x1_chw_dw (:2353, pallas_call :2361, kernel _dw1x1_kernel
//      :2326): dW[o, c] = sum g[o] x[c] and db[o] = sum g[o] over (N, H, W),
//      float32 sums. Both operands are bf16 values, so every product is exact
//      in float32 and the kernel computes the plain version's function
//      (ops/kernels.py: conv1x1_chw_dw_plain); only the order of the sums
//      differs.
// Float32 activations take the CUDA-core kernels of conv1x1_chw.cu (K3) and
// conv1x1_dw_f32.cu (K3-dW).
//
// What bounds them on the H100: the forward does 2 C Co operations per pixel
// against 2 (C + 2 Co) bytes (x, res, y): at most 35 per byte on the main
// path (104 -> 52), far under the 295 of the bf16 ridge, so the bound is
// bytes (3.35 TB/s). At N = 1 (the raster's sub-images) a call moves well
// under a megabyte, and a call's fixed cost and the card's fill weigh more
// than the bytes. The dW reads x and g once (2 (C + Co) bytes per pixel) for
// 2 C Co operations: bytes again.
// What the design does about it:
// - Forward: an implicit GEMM on warp-level mma.sync m16n8k16 (bf16 operands,
//   float32 sums). M = a tile of TP pixels of one image (16, 32 or 64: the
//   largest that still gives every SM two blocks, 16 at the least, so that
//   104 -> 52 at 48^2, 2304 pixels, is 144 blocks), N = every output channel
//   (up to 64 a block, a grid axis past that; Co padded to 8 with zero
//   weights), K = the input channels padded to 16. A tile's whole C x TP slab lands in shared
//   memory as it lies in device memory, channels-major, by 16-byte cp.async
//   copies all in flight at once (one load latency, not C of them), with the
//   residual's tile beside it, in one of two buffers: the next tile's copies
//   fly while this one's epilogue runs (one buffer where two do not fit a
//   block's shared memory, at C = 768); ldmatrix.trans turns the slab's rows
//   (pixels contiguous) into mma's A fragment. Rows hold an odd number of
//   16-byte units, so ldmatrix's eight row addresses hit distinct banks. The
//   weights (float32) are loaded 64 a thread in flight, rounded to bf16 in
//   registers and kept in shared memory, K contiguous, as the B operand for
//   the block's life (ops/kernels.py: pack_conv1x1_weights is its plain
//   version; a call that passes wp gets it written out). The four warps split
//   a tile into m16 tiles and, below 64 pixels, the n8 tiles among them. The
//   sums go to a y tile in shared memory as float32 with the bias; each
//   thread then takes 8 pixels of one channel, adds the residual, rounds once
//   and stores 16 bytes. Each y sums its k16 steps in one order whatever the
//   tile's size or place, so the raster's sub-images give the one pass's
//   bits. Blocks are persistent (as many as the SMs hold, at most one per
//   tile): with stats, each keeps its sums of the stored y per channel in a
//   fixed order and writes them as float32 partials; a last launch
//   (chw_fwd_tc.cuh: sum_partials) adds the partials in one fixed order.
// - dW: mma.sync with M = the input channels c (padded to 16 MT), N = the
//   output channels o (padded to 8 NO), K = the pixels. x (N, C, HW) and g
//   (N, Co, HW) are channels-major, so a tile of 256 pixels of each lands in
//   shared memory as it lies in device memory (16-byte cp.async, rows of an
//   odd number of 16-byte units) and its rows are the A and B fragments as
//   ldmatrix reads them, with no transpose and no thread touching the data.
//   Persistent blocks walk the (image, pixel tile) pairs in a fixed order
//   with a ring of two stages (the next tile's copies fly while this one is
//   multiplied), the ragged last tile of each image zero-filled; the 8 warps
//   split the k16 steps of a tile (and, where a warp would hold more than 16
//   m16n8 accumulators, the m16 tiles), keep their accumulators in
//   registers, and add their k-slices in a fixed order at the end. db is
//   summed from the staged g tile by 8 threads a channel in a fixed order.
//   Each block writes its float32 partial dW and db; a last launch adds the
//   partials over the blocks in one fixed order.
// No atomics anywhere: two calls give the same bits.
#include "chw_fwd_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::aligned16;
using itg::bf16_bits_to_f32;
using itg::ldmatrix_x2;
using itg::ldmatrix_x4;
using itg::ldmatrix_x4_trans;
using itg::mma_bf16;
using itg::smem_addr;
using itg::word;

constexpr size_t kSmemPerBlock = 232448;  // the shared memory a block may take on an H100

// The blocks of `kernel` with `threads` threads and `smem` bytes of dynamic
// shared memory that the card holds at once.
template <typename Kernel>
int resident(Kernel kernel, int threads, size_t smem, long* held) {
  if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem))) {
    return static_cast<int>(e);
  }
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) {
    return static_cast<int>(e);
  }
  *held = static_cast<long>(per_sm > 0 ? per_sm : 1) * itg::sm_count();
  return 0;
}

// 8 bf16 of a row, element by element (zero at or past `valid`).
__device__ __forceinline__ uint4 load8(const bf16* src, int valid) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < valid ? __bfloat16_as_ushort(src[2 * i]) : 0u;
    const uint32_t hi = 2 * i + 1 < valid ? __bfloat16_as_ushort(src[2 * i + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copies 8 bf16 of a row at pixel p (of `hw`) into shared memory: one 16-byte
// cp.async where `vec` (rows 16-byte aligned, hw % 8 == 0), else element
// loads; zeros past the row's end.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* row, int p, int hw, bool vec) {
  if (vec && p < hw) {
    itg::cp_async16(dst, row + p);
  } else {
    *reinterpret_cast<uint4*>(dst) = p < hw ? load8(row + p, hw - p) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// K3 forward

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kCoBlock = 64;       // output channels a block at most (8 n8 tiles)
constexpr int kMaxC = 768;         // input channels at most (ops/kernels.py: CONV1X1_TC_MAX_C)
constexpr int kMaxBlocks = 1024;   // the most blocks a launch takes along x: the rows of the
                                   // partials (ops/kernels.py: CONV1X1_TC_MAX_BLOCKS)

struct FwdArgs {
  const bf16* x;     // (N, C, HW)
  const float* w;    // (Co, C)
  const float* b;    // (Co)
  const bf16* res;   // (N, Co, HW) or null
  bf16* y;           // (N, Co, HW)
  bf16* wp;          // (8 NO, 16 KS): the B operand as staged, written where not null
  float* part;       // (gridDim.x, 2, Co): per-block sums of y | y^2, or null
  int N, C, HW, Co;
  int tp;            // pixels a tile: 16, 32 or 64 (16 per m16 tile of a warp)
  int wn;            // warps sharing an m16 tile, each taking every wn-th n8 tile: 4 / (tp / 16)
  int nbuf;          // buffers of the slab and the residual's tile: 2 (the next tile's
                     // copies fly during this one's epilogue) where they fit, else 1
};

// The shared memory of a block with `cobp` output channels (a multiple of 8),
// C input channels, TP-pixel tiles and `nbuf` buffers: [B: cobp rows of ws
// bf16][the y tile: cobp rows of ys floats][nbuf x the x slab: 16 ks rows of
// xs bf16][nbuf x the residual's tile: cobp rows of xs bf16][bias: cobp]
// [sums: 2 cobp].
struct Geo {
  int ks;  // k16 steps: C padded to 16 ks
  int ws;  // bf16 per B row: 16 ks + 8, an odd number of 16-byte units
  int xs;  // bf16 per staged row of pixels: TP + 8, an odd number of 16-byte units
  int ys;  // floats per y row: TP + 4 (the fragments' stores of four channel pairs
           // hit distinct banks; 16-byte aligned rows)
  size_t w_bytes, y_bytes, x_bytes, r_bytes, smem;  // x_bytes, r_bytes: one buffer
};

__host__ __device__ inline Geo geo(int c, int cobp, int tp, int nbuf) {
  Geo g;
  g.ks = (c + 15) / 16;
  g.ws = 16 * g.ks + 8;
  g.xs = tp + 8;
  g.ys = tp + 4;
  g.w_bytes = sizeof(bf16) * cobp * g.ws;
  g.y_bytes = sizeof(float) * cobp * g.ys;
  g.x_bytes = sizeof(bf16) * 16 * g.ks * g.xs;
  g.r_bytes = sizeof(bf16) * cobp * g.xs;
  g.smem = g.w_bytes + g.y_bytes + nbuf * (g.x_bytes + g.r_bytes) + sizeof(float) * 3 * cobp;
  return g;
}

// Grid (blocks along the tiles, ceil(Co / 64) along the output channels),
// kThreads threads, dynamic shared memory geo(C, cobp, TP, nbuf).smem. Warp w
// takes m16 tile w / wn of a tile and its n8 tiles w % wn + wn q, q < NJ.
template <int NJ>
__global__ void __launch_bounds__(kThreads) conv1x1_tc_kernel(const FwdArgs a) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, HW = a.HW, Co = a.Co, TP = a.tp, WN = a.wn, NB = a.nbuf;
  const int co0 = blockIdx.y * kCoBlock;
  const int cob = min(kCoBlock, Co - co0);
  const int nob = (cob + 7) / 8, cobp = 8 * nob;
  const Geo g = geo(C, cobp, TP, NB);
  const int KS = g.ks, WS = g.ws, XS = g.xs, YS = g.ys;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_w = reinterpret_cast<bf16*>(smem);
  float* s_y = reinterpret_cast<float*>(smem + g.w_bytes);
  unsigned char* s_bufs = smem + g.w_bytes + g.y_bytes;
  // buffer i % NB of the slab and of the residual's tile
  auto x_buf = [&](int i) { return reinterpret_cast<bf16*>(s_bufs + (i % NB) * g.x_bytes); };
  auto r_buf = [&](int i) {
    return reinterpret_cast<bf16*>(s_bufs + NB * g.x_bytes + (i % NB) * g.r_bytes);
  };
  float* s_b = reinterpret_cast<float*>(s_bufs + NB * (g.x_bytes + g.r_bytes));
  float* s_acc = s_b + cobp;

  const int tpi = (HW + TP - 1) / TP;  // tiles an image
  const int n_tiles = a.N * tpi;
  const bool xvec = HW % 8 == 0 && aligned16(a.x);
  const bool rvec = HW % 8 == 0 && aligned16(a.res);
  const bool yvec = HW % 8 == 0 && aligned16(a.y);
  const int chunks = TP / 8;  // 16-byte chunks of a staged row

  // the slab of x (rows past C zero) and the residual's tile of `tile`, into
  // buffer i
  auto stage = [&](int tile, int i) {
    const int n = tile / tpi, p0 = (tile % tpi) * TP;
    const bf16* xn = a.x + static_cast<size_t>(n) * C * HW;
    bf16* s_x = x_buf(i);
    bf16* s_r = r_buf(i);
    for (int u = tid; u < 16 * KS * chunks; u += kThreads) {
      const int row = u / chunks, p = p0 + 8 * (u % chunks);
      bf16* dst = s_x + row * XS + 8 * (u % chunks);
      if (row < C) {
        copy8(dst, xn + static_cast<size_t>(row) * HW, p, HW, xvec);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (a.res) {
      const bf16* rn = a.res + (static_cast<size_t>(n) * Co + co0) * HW;
      for (int u = tid; u < cob * chunks; u += kThreads) {
        const int row = u / chunks, p = p0 + 8 * (u % chunks);
        copy8(s_r + row * XS + 8 * (u % chunks), rn + static_cast<size_t>(row) * HW, p, HW, rvec);
      }
    }
    itg::cp_async_commit();
  };

  int tile = blockIdx.x;
  stage(tile, 0);  // in flight while the weights are staged

  // -- B: W rounded to bf16, zero past C and past Co: a thread takes input
  // channel k of every output channel of the block, kCoBlock loads in flight;
  // the bias rounded to bf16 as well
  for (int k = tid; k < 16 * KS; k += kThreads) {
    float v[kCoBlock];
#pragma unroll
    for (int o = 0; o < kCoBlock; ++o) {
      v[o] = o < cob && k < C ? __ldg(a.w + static_cast<size_t>(co0 + o) * C + k) : 0.f;
    }
#pragma unroll
    for (int o = 0; o < kCoBlock; ++o) {
      if (o < cobp) s_w[o * WS + k] = __float2bfloat16_rn(v[o]);
    }
  }
  for (int o = tid; o < cobp; o += kThreads) {
    s_b[o] = o < cob ? __bfloat162float(__float2bfloat16_rn(a.b[co0 + o])) : 0.f;
    s_acc[o] = 0.f;
    s_acc[cobp + o] = 0.f;
  }
  __syncthreads();
  if (a.wp && blockIdx.x == 0) {  // the B operand as the products read it
    for (int i = tid; i < cobp * 2 * KS; i += kThreads) {
      const int o = i / (2 * KS), k8 = i % (2 * KS);
      *reinterpret_cast<uint4*>(a.wp + static_cast<size_t>(co0 + o) * 16 * KS + 8 * k8) =
          *reinterpret_cast<const uint4*>(s_w + o * WS + 8 * k8);
    }
  }

  // this warp's m16 tile and n8 tiles; ldmatrix lanes: matrix mi, row rr
  const int wm = warp / WN, wn = warp % WN;
  const int mi = lane >> 3, rr = lane & 7;
  // A (transposed): rows are channels k0 + rr + 8 (mi >> 1), 8 pixels from
  // 16 wm + 8 (mi & 1)
  const uint32_t a_lane = 2 * ((rr + 8 * (mi >> 1)) * XS + 16 * wm + 8 * (mi & 1));
  // B: rows are output channels 8 j + rr of n8 tile j = wn + WN (q + (mi >> 1)),
  // columns k0 + 8 (mi & 1); a tile past nob reads row 0 (ignored)
  uint32_t b_base[(NJ + 1) / 2];
#pragma unroll
  for (int q = 0; q < NJ; q += 2) {
    const int j = wn + WN * (q + (NJ > 1 ? (mi >> 1) : 0));
    b_base[q / 2] = smem_addr(s_w + (j < nob ? 8 * j + rr : 0) * WS + 8 * (mi & 1));
  }
  const int grp = lane >> 2, tq = lane & 3;
  // the epilogue: unit u = o * chunks + k takes pixels 8 k .. 8 k + 7 of
  // channel o; the chunks of a channel are consecutive lanes
  const int units = cobp * chunks;
  const int rounds = (units + kThreads - 1) / kThreads;

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int n = tile / tpi, p0 = (tile % tpi) * TP;
    const int next = tile + static_cast<int>(gridDim.x);
    itg::cp_async_wait_all();
    __syncthreads();  // this tile's slab and residual landed; the last epilogue is done
    const uint32_t a_base = smem_addr(x_buf(it)) + a_lane;
    const bf16* s_r = r_buf(it);

    float acc[NJ][4];
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    }
    for (int s = 0; s < KS; ++s) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, a_base + 2 * (16 * s * XS));
#pragma unroll
      for (int q = 0; q < NJ; q += 2) {
        if (wn + WN * q >= nob) break;  // warp-uniform
        if constexpr (NJ == 1) {
          uint32_t bf[2];
          ldmatrix_x2(bf, b_base[0] + 2 * 16 * s);
          mma_bf16(acc[0], af, bf[0], bf[1]);
        } else {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_base[q / 2] + 2 * 16 * s);
          mma_bf16(acc[q], af, bf[0], bf[1]);
          if (wn + WN * (q + 1) < nob) mma_bf16(acc[q + 1], af, bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = wn + WN * q;
      if (j >= nob) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * j + 2 * tq + (e & 1);
        s_y[o * YS + 16 * wm + grp + 8 * (e >> 1)] = acc[q][e] + s_b[o];
      }
    }
    // with two buffers the next tile's copies fly during this epilogue (the
    // other buffer's last reader was the tile before, done at the barrier
    // above)
    if (NB == 2 && next < n_tiles) stage(next, it + 1);
    __syncthreads();

    // -- epilogue: + residual, one rounding, 16-byte stores; the sums of the
    // stored values per channel in a fixed order
    for (int r = 0; r < rounds; ++r) {
      const int u = tid + r * kThreads;
      const int o = u / chunks, k = u % chunks;
      const int p = p0 + 8 * k;
      float s1 = 0.f, s2 = 0.f;
      if (u < units && o < cob && p < HW) {
        const float4 lo = *reinterpret_cast<const float4*>(s_y + o * YS + 8 * k);
        const float4 hi = *reinterpret_cast<const float4*>(s_y + o * YS + 8 * k + 4);
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (a.res) {
          const uint4 rv = *reinterpret_cast<const uint4*>(s_r + o * XS + 8 * k);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t w = word(rv, e / 2);
            v[e] += bf16_bits_to_f32((e & 1) ? w >> 16 : w & 0xffffu);
          }
        }
        uint32_t out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = itg::pack_bf16x2(v[2 * e], v[2 * e + 1]);
        const uint4 ov = make_uint4(out[0], out[1], out[2], out[3]);
        bf16* dst = a.y + (static_cast<size_t>(n) * Co + co0 + o) * HW + p;
        const int valid = min(8, HW - p);
        if (yvec && valid == 8) {
          *reinterpret_cast<uint4*>(dst) = ov;
        } else {
          for (int e = 0; e < valid; ++e) {
            dst[e] = __ushort_as_bfloat16(static_cast<uint16_t>(word(ov, e / 2) >> (16 * (e & 1))));
          }
        }
        if (a.part) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t w = word(ov, e / 2);
            const float f = e < valid ? bf16_bits_to_f32((e & 1) ? w >> 16 : w & 0xffffu) : 0.f;
            s1 = __fadd_rn(s1, f);
            s2 = fmaf(f, f, s2);
          }
        }
      }
      if (a.part) {  // the same for every thread of the launch
        for (int d = chunks / 2; d > 0; d >>= 1) {
          s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, d));
          s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, d));
        }
        if (k == 0 && u < units && o < cob) {
          s_acc[o] = __fadd_rn(s_acc[o], s1);
          s_acc[cobp + o] = __fadd_rn(s_acc[cobp + o], s2);
        }
      }
    }
    if (NB == 1) {
      __syncthreads();  // the slab and the residual are read: the next tile's copies may land
      if (next < n_tiles) stage(next, 0);
    }
  }
  if (a.part) {
    __syncthreads();  // every channel's owner has added the last tile's sums
    float* out = a.part + static_cast<size_t>(blockIdx.x) * 2 * Co + co0;
    for (int o = tid; o < cob; o += kThreads) {
      out[o] = s_acc[o];
      out[Co + o] = s_acc[cobp + o];
    }
  }
}

// Pixels a tile: the largest of 64, 32, 16 that still gives every SM two
// blocks, else 16 (on an H100, 104 -> 52 at 96^2 for one image ran 15%
// faster in 32-pixel tiles than in 64-pixel ones, which give an SM one).
int pick_tp(int n, int hw, int co_blocks) {
  const long want = 2L * itg::sm_count();
  for (int tp = 64; tp > 16; tp /= 2) {
    if (static_cast<long>(n) * ((hw + tp - 1) / tp) * co_blocks >= want) return tp;
  }
  return 16;
}

template <int NJ>
int launch_fwd(const FwdArgs& a, int co_blocks, float* s1, float* s2, cudaStream_t st) {
  const auto kernel = conv1x1_tc_kernel<NJ>;
  const int cobp = 8 * (((a.Co < kCoBlock ? a.Co : kCoBlock) + 7) / 8);  // the widest block's
  const size_t smem = geo(a.C, cobp, a.tp, a.nbuf).smem;
  if (smem > kSmemPerBlock) return static_cast<int>(cudaErrorInvalidValue);
  long held = 0;
  if (int rc = resident(kernel, kThreads, smem, &held)) return rc;
  const long tiles = static_cast<long>(a.N) * ((a.HW + a.tp - 1) / a.tp);
  long blocks = (held + co_blocks - 1) / co_blocks;
  blocks = blocks < tiles ? blocks : tiles;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  kernel<<<dim3(static_cast<unsigned>(blocks), co_blocks), kThreads, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  if (!a.part) return 0;
  itg::sum_partials<<<2 * a.Co, itg::kReduceThreads, 0, st>>>(a.part, s1, s2,
                                                              static_cast<int>(blocks), a.Co);
  return itg::last_error();
}

// ---------------------------------------------------------------------------
// K3-dW

constexpr int kDwWarps = 8;
constexpr int kDwThreads = 32 * kDwWarps;
constexpr int kDwTP = 256;             // pixels a tile
constexpr int kDwRow = kDwTP + 8;      // bf16 per staged row: 33 16-byte units (odd)
constexpr int kDwSteps = kDwTP / 16;   // k16 steps a tile
constexpr int kDwStages = 2;

// MT m16 tiles of input channels, NO n8 tiles of output channels. The warps
// split the m16 tiles into PG groups (the fewest that keep a warp at 16 or
// fewer m16n8 accumulators) and the k16 steps of a tile into KS = 8 / PG
// slices.
template <int MT, int NO>
struct DwCfg {
  static constexpr int Cp = 16 * MT, Cop = 8 * NO;
  static constexpr int PG = MT * NO <= 16 ? 1 : 2;
  static constexpr int MW = MT / PG;  // m16 tiles a warp
  static constexpr int KS = kDwWarps / PG;
  static constexpr size_t stage_bytes = sizeof(bf16) * (Cp + Cop) * kDwRow;
  static constexpr size_t smem = kDwStages * stage_bytes;
  static constexpr int frag_entries = MT * NO * 128;
  static constexpr int entries = frag_entries + Cop;  // a block's partial: dW fragments | db
  static_assert(MT % PG == 0 && MW * NO <= 16, "a warp holds at most 16 m16n8 accumulators");
  static_assert(sizeof(float) * PG * MW * NO * 128 <= smem, "the k-slices' sums fit the stages");
};

struct DwArgs {
  const bf16* x;  // (N, C, HW)
  const bf16* g;  // (N, Co, HW)
  float* part;    // (gridDim.x, entries): per-block dW fragments | db
  int N, C, HW, Co;
};

// Grid (blocks), kDwThreads threads, dynamic shared memory DwCfg::smem:
// kDwStages stages of [x: Cp rows | g: Cop rows] of kDwRow bf16 (the
// k-slices' sums reuse the space at the end).
template <int MT, int NO>
__global__ void __launch_bounds__(kDwThreads) conv1x1_dw_tc_kernel(const DwArgs a) {
  using K = DwCfg<MT, NO>;
  constexpr int Cp = K::Cp, Cop = K::Cop, PG = K::PG, MW = K::MW, KS = K::KS;
  extern __shared__ __align__(16) unsigned char smem[];
  auto x_of = [&](int i) { return reinterpret_cast<bf16*>(smem + (i % kDwStages) * K::stage_bytes); };
  auto g_of = [&](int i) { return x_of(i) + Cp * kDwRow; };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, HW = a.HW, Co = a.Co;
  const bool xvec = HW % 8 == 0 && aligned16(a.x);
  const bool gvec = HW % 8 == 0 && aligned16(a.g);
  const int tpi = (HW + kDwTP - 1) / kDwTP;
  const int n_tiles = a.N * tpi;
  // this block's tiles blockIdx.x + gridDim.x i, i < mine
  const int mine = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  // rows past C and past Co stay zero in every stage
  for (int s = 0; s < kDwStages; ++s) {
    for (int u = tid; u < (Cp - C) * (kDwRow / 8); u += kDwThreads) {
      *reinterpret_cast<uint4*>(x_of(s) + (C + u / (kDwRow / 8)) * kDwRow + 8 * (u % (kDwRow / 8))) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    for (int u = tid; u < (Cop - Co) * (kDwRow / 8); u += kDwThreads) {
      *reinterpret_cast<uint4*>(g_of(s) + (Co + u / (kDwRow / 8)) * kDwRow + 8 * (u % (kDwRow / 8))) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the copies of this block's i-th tile into its stage, as one cp.async group
  auto start = [&](int i) {
    if (i < mine) {
      const int tile = blockIdx.x + static_cast<int>(gridDim.x) * i;
      const int n = tile / tpi, p0 = (tile % tpi) * kDwTP;
      const bf16* xn = a.x + static_cast<size_t>(n) * C * HW;
      const bf16* gn = a.g + static_cast<size_t>(n) * Co * HW;
      bf16* sx = x_of(i);
      bf16* sg = g_of(i);
      constexpr int chunks = kDwTP / 8;
      for (int u = tid; u < (C + Co) * chunks; u += kDwThreads) {
        const int row = u / chunks, k = u % chunks;
        if (row < C) {
          copy8(sx + row * kDwRow + 8 * k, xn + static_cast<size_t>(row) * HW, p0 + 8 * k, HW, xvec);
        } else {
          const int o = row - C;
          copy8(sg + o * kDwRow + 8 * k, gn + static_cast<size_t>(o) * HW, p0 + 8 * k, HW, gvec);
        }
      }
    }
    itg::cp_async_commit();  // an empty group past the block's tiles keeps the count
  };
#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) start(i);

  const int pg = warp % PG, ks = warp / PG;
  const int mi = lane >> 3, rr = lane & 7;
  float acc[MW][NO][4];
#pragma unroll
  for (int i = 0; i < MW; ++i) {
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  // db: 8 threads a channel (channels tid / 8 + 32 r), each an eighth of a
  // tile's pixels
  constexpr int kDbRounds = (Cop + kDwThreads / 8 - 1) / (kDwThreads / 8);
  const int db_seg = tid & 7;
  float db_acc[kDbRounds];
#pragma unroll
  for (int r = 0; r < kDbRounds; ++r) db_acc[r] = 0.f;

  for (int it = 0; it < mine; ++it) {
    itg::cp_async_wait_group<kDwStages - 2>();
    __syncthreads();  // this tile's copies landed; the last tile's products are done
    start(it + kDwStages - 1);
    const bf16* sx = x_of(it);
    const bf16* sg = g_of(it);

#pragma unroll
    for (int r = 0; r < kDbRounds; ++r) {
      const int o = (tid >> 3) + r * (kDwThreads / 8);
      if (o < Cop) {
        const uint4* src = reinterpret_cast<const uint4*>(sg + o * kDwRow + db_seg * (kDwTP / 8));
#pragma unroll
        for (int q = 0; q < kDwTP / 64; ++q) {
          const uint4 v = src[q];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t w = word(v, e);
            db_acc[r] = __fadd_rn(db_acc[r], bf16_bits_to_f32(w & 0xffffu));
            db_acc[r] = __fadd_rn(db_acc[r], bf16_bits_to_f32(w >> 16));
          }
        }
      }
    }

    // A: rows c = 16 mt + rr + 8 (mi & 1), pixels 16 st + 8 (mi >> 1); B:
    // rows o = 8 j + rr (+ 8 for matrices 2, 3), pixels 16 st + 8 (mi & 1)
    const uint32_t a_lane = smem_addr(sx + (rr + 8 * (mi & 1)) * kDwRow + 8 * (mi >> 1));
    const uint32_t b_lane = smem_addr(sg + (rr + 8 * (mi >> 1)) * kDwRow + 8 * (mi & 1));
#pragma unroll 2
    for (int st = ks; st < kDwSteps; st += KS) {
      uint32_t b[NO][2];
#pragma unroll
      for (int j = 0; j + 1 < NO; j += 2) {
        uint32_t f[4];
        ldmatrix_x4(f, b_lane + 2 * (8 * j * kDwRow + 16 * st));
        b[j][0] = f[0], b[j][1] = f[1], b[j + 1][0] = f[2], b[j + 1][1] = f[3];
      }
      if constexpr (NO % 2 == 1) {
        uint32_t f[2];
        ldmatrix_x2(f, b_lane + 2 * (8 * (NO - 1) * kDwRow + 16 * st));
        b[NO - 1][0] = f[0], b[NO - 1][1] = f[1];
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, a_lane + 2 * (16 * (pg + PG * i) * kDwRow + 16 * st));
#pragma unroll
        for (int j = 0; j < NO; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
  }
  itg::cp_async_wait_all();

  // -- the block's sums: k-slices KS - 1, ..., 1 added onto slice 0 in turn
  // through shared memory, then slice 0 writes the partial in fragment order
  float* out = a.part + static_cast<size_t>(blockIdx.x) * K::entries;
  float* red = reinterpret_cast<float*>(smem) + static_cast<size_t>(pg) * MW * NO * 128;
  __syncthreads();
#pragma unroll 1
  for (int k = KS - 1; k > 0; --k) {
    if (ks == k) {
#pragma unroll
      for (int i = 0; i < MW; ++i) {
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
      for (int i = 0; i < MW; ++i) {
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
    for (int i = 0; i < MW; ++i) {
      const int mt = pg + PG * i;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[((mt * NO + j) * 4 + e) * 32 + lane] = acc[i][j][e];
      }
    }
  }
  // db: the 8 threads of a channel in a fixed tree
#pragma unroll
  for (int r = 0; r < kDbRounds; ++r) {
#pragma unroll
    for (int m = 4; m > 0; m >>= 1) {
      db_acc[r] = __fadd_rn(db_acc[r], __shfl_xor_sync(0xffffffffu, db_acc[r], m));
    }
    const int o = (tid >> 3) + r * (kDwThreads / 8);
    if (db_seg == 0 && o < Cop) out[K::frag_entries + o] = db_acc[r];
  }
}

// dW and db: entry e of a partial, the blocks' partials summed in one fixed
// order, then mapped from fragment order to dW (co, c) and db. A block takes
// 32 entries (a warp's coalesced columns) x 32 segments: segment s adds the
// rows s, s + 32, ..., then the segments are added in order.
constexpr int kRedEntries = 32;
constexpr int kRedSegs = 32;

__global__ void __launch_bounds__(kRedEntries * kRedSegs)
conv1x1_dw_tc_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                            float* __restrict__ db, int blocks, int mt_tiles, int no, int C,
                            int Co) {
  __shared__ float s_sum[kRedSegs][kRedEntries];
  const int Efrag = mt_tiles * no * 128, E = Efrag + 8 * no;
  const int le = threadIdx.x % kRedEntries, seg = threadIdx.x / kRedEntries;
  const int e = blockIdx.x * kRedEntries + le;
  float v = 0.f;
  if (e < E) {
    for (int b = seg; b < blocks; b += kRedSegs) v = __fadd_rn(v, part[static_cast<size_t>(b) * E + e]);
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
    // entry ((mt no + j) 4 + q) 32 + lane: m16 tile mt, n8 tile j,
    // accumulator q of the lane's C fragment
    const int lane = e % 32, q = (e / 32) % 4, j = (e / 128) % no, mt = e / (128 * no);
    const int c = 16 * mt + lane / 4 + 8 * (q >> 1);
    const int o = 8 * j + 2 * (lane % 4) + (q & 1);
    if (c < C && o < Co) dw[static_cast<size_t>(o) * C + c] = v;
  }
}

// One call: the persistent grid (as many blocks as the SMs hold, at most one
// per tile and at most `cap`, the partials' rows), then the sums.
template <int MT, int NO>
int launch_dw(const DwArgs& a, float* dw, float* db, int cap, cudaStream_t st) {
  using K = DwCfg<MT, NO>;
  const auto kernel = conv1x1_dw_tc_kernel<MT, NO>;
  long held = 0;
  if (int rc = resident(kernel, kDwThreads, K::smem, &held)) return rc;
  const long tiles = static_cast<long>(a.N) * ((a.HW + kDwTP - 1) / kDwTP);
  long blocks = held < tiles ? held : tiles;
  blocks = blocks < cap ? blocks : cap;
  kernel<<<static_cast<int>(blocks), kDwThreads, K::smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  conv1x1_dw_tc_reduce_kernel<<<(K::entries + kRedEntries - 1) / kRedEntries,
                                kRedEntries * kRedSegs, 0, st>>>(
      a.part, dw, db, static_cast<int>(blocks), MT, NO, a.C, a.Co);
  return itg::last_error();
}

// The (MT, NO) pairs that C + Co <= 96 allows (ops/kernels.py: conv1x1_dw_tc_plan).
template <int MT>
int dispatch_dw(int no, const DwArgs& a, float* dw, float* db, int cap, cudaStream_t st) {
  switch (no) {
    case 1: return launch_dw<MT, 1>(a, dw, db, cap, st);
    case 2: return launch_dw<MT, 2>(a, dw, db, cap, st);
    case 4: return launch_dw<MT, 4>(a, dw, db, cap, st);
    case 8: if constexpr (MT <= 4) return launch_dw<MT, 8>(a, dw, db, cap, st);
            break;
    case 12: if constexpr (MT <= 2) return launch_dw<MT, 12>(a, dw, db, cap, st);
             break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K3 on the tensor cores. x (n, c, hw) and res, y (n, co, hw) bfloat16 (res
// may be null); w (co, c) and b (co) float32, rounded to bf16 in the kernel;
// wp (8 ceil(co / 8), 16 ceil(c / 16)) bfloat16, written with the B operand
// as staged, or null; part (1024, 2, co) float32 scratch and s1, s2 (co)
// float32, written with Σy and Σy² of the stored y, or all three null for no
// stats. c <= 768, any co. One launch, two with stats; returns the first CUDA
// error (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int itg_conv1x1_chw_tc(const void* x, const void* w, const void* b, const void* res,
                                  void* wp, void* y, void* part, void* s1, void* s2, int n, int c,
                                  int hw, int co, void* stream) {
  if (c < 1 || c > kMaxC || co < 1 || n < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int co_blocks = (co + kCoBlock - 1) / kCoBlock;
  const int nob = ((co < kCoBlock ? co : kCoBlock) + 7) / 8;
  // two buffers where they fit a block's shared memory, else one, else
  // smaller tiles (C = 768 with 64 output channels: 32 pixels, one buffer)
  int tp = pick_tp(n, hw, co_blocks), nbuf = 2;
  while (geo(c, 8 * nob, tp, nbuf).smem > kSmemPerBlock && (nbuf == 2 || tp > 16)) {
    if (nbuf == 2) {
      nbuf = 1;
    } else {
      tp /= 2;
    }
  }
  const int wn = kWarps / (tp / 16);
  FwdArgs a{static_cast<const bf16*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
            static_cast<const bf16*>(res), static_cast<bf16*>(y), static_cast<bf16*>(wp),
            static_cast<float*>(part), n, c, hw, co, tp, wn, nbuf};
  const int nj = (nob + wn - 1) / wn;
  auto* a1 = static_cast<float*>(s1);
  auto* a2 = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (nj <= 1) return launch_fwd<1>(a, co_blocks, a1, a2, st);
  if (nj <= 2) return launch_fwd<2>(a, co_blocks, a1, a2, st);
  if (nj <= 4) return launch_fwd<4>(a, co_blocks, a1, a2, st);
  return launch_fwd<8>(a, co_blocks, a1, a2, st);
}

// K3-dW on the tensor cores. x (n, c, hw), g (n, co, hw) bfloat16; part (cap,
// 128 mt no + 8 no) float32 scratch; dw (co, c) and db (co) float32, written
// (not accumulated). mt in {1, 2, 4, 6} m16 tiles of input channels (c <= 16
// mt), no in {1, 2, 4, 8, 12} n8 tiles of output channels (co <= 8 no), no <=
// 8 for mt = 4 and no <= 4 for mt = 6. Two launches; returns the first CUDA
// error (cudaErrorInvalidValue for a plan the kernels do not take).
extern "C" int itg_conv1x1_chw_dw_tc(const void* x, const void* g, void* part, void* dw, void* db,
                                     int n, int c, int hw, int co, int mt, int no, int cap,
                                     void* stream) {
  if (c < 1 || co < 1 || c > 16 * mt || co > 8 * no || cap < 1 || n < 1 || hw < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DwArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<float*>(part),
                 n, c, hw, co};
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return dispatch_dw<1>(no, a, w, b, cap, st);
    case 2: return dispatch_dw<2>(no, a, w, b, cap, st);
    case 4: return dispatch_dw<4>(no, a, w, b, cap, st);
    case 6: return dispatch_dw<6>(no, a, w, b, cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
