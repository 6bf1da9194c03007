// The input-side gradient of the subpixel-fused up-conv (K9 dx) on the CUDA
// cores: the float32 route (bf16 runs on the tensor cores in chw_dx_tc.cu;
// this entry point takes bf16 too).
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:1642 _upconv3x3_dx
// (kernel _updx_kernel :1491): for x (N, C, H, W) at half resolution and
// g (N, Co, 2H, 2W), the cotangent of the forward's y,
//   dA[c, p, q] = sum_o sum_{u, v < 4} wt[o, c, u, v] g[o, 2p - 1 + u, 2q - 1 + v]
// (zero outside g), wt the 4 x 4 stride-2 transposed form of the 3 x 3
// kernel (taps K2, K1 + K2, K0 + K1, K0 per axis: ops/kernels.py
// _upconv_dx_weights, built here by a pack launch in the same float32
// order); with replicate padding every padded half-res cell of the border
// also adds its dA onto the edge cell it copies (corners twice: the padded
// row -1 takes g row 0 through u = 3 only, row H row 2H - 1 through u = 0,
// the same on columns); then dA is masked by the ReLU of scale * x + shift
// (recomputed with the forward's rounding), dx = dA * scale, d(scale) =
// sum dA * x, d(shift) = sum dA over (N, H, W).
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per half-res pixel
// against 4 (2 C + 4 Co) bytes in float32. At the Experiment-1 shapes (52
// -> 26 at a 96^2 half resolution, 26 -> 13 at 192^2, N = 8) that is 6.4
// GFLOP a step against 0.18 GB, so FFMA issue bounds it (67 TFLOP/s: 0.048
// ms a call), not the bytes (0.027 ms). Its operands come from shared
// memory, whose load pipe delivers 128 bytes a cycle to a warp: a 16-byte
// load takes four cycles even where every lane reads the same address (a
// weight broadcast), so the design counts load cycles per FMA. What it does:
// - Register outer products. A thread owns 2 x 2 half-res pixels x CC input
//   channels (CC 8 or 13: 13 divides the flagship's 26). Per
//   output channel and row tap u it loads the two g rows its pixel rows
//   read (six columns each: a 4-, a 16- and a 4-byte load; its four column
//   taps overlap) and, per column tap v, exactly the CC weights wt[o, c, u,
//   v], each used for 4 FMAs. (Four pixel rows a thread halve the weight
//   loads, but at N = 8 leave too few warps an SM to hide the loads.)
// - A block (two warps side by side) takes an 8 x 32 half-res tile of one
//   image and one group of CC input channels (zero weights past C). The g
//   tile of one output channel, 18 x 66 full-res cells with its one-cell
//   ring (zeros outside g), lands as one TMA box (which starts on a 16-byte
//   boundary, 3 columns left of the ring); that channel's packed weights
//   ((16 taps, CC) floats) as one bulk copy on the same mbarrier. A ring of
//   kStages such stages keeps the next output channels' copies in flight
//   while this one's FMAs run.
// - A planner in ops/kernels.py (upconv_dx_f32_plan) picks CC and so the
//   input-channel split from C, and counts the tiles; the entry point
//   launches that grid. The channel groups of a tile are neighbours in the
//   grid, so g comes from device memory about once and from L2 once per
//   group.
// - The border folds cost no FMA: a padded row's dA reaches the edge pixel
//   row through the same weights (row tap 3 at the top, 0 at the bottom) as
//   the g row two rows in, so an edge thread adds that g row to the one it
//   loaded; a padded column's the same on the column taps, with the value
//   of the column two in; the corners follow from both.
// - The epilogue loads x for kEpi channels at once, so their loads
//   overlap.
// - d(scale), d(shift): per-block partials (a fixed tree over the block's
//   pixels) summed by a last launch in one fixed order (chw_fwd_tc.cuh:
//   sum_partials). No atomics: two calls give the same bits.
// Where TMA cannot read g (W odd, an unaligned pointer, bf16), the block
// stages each output channel with element loads instead.
#include "chw_dw_tc.cuh"   // encode_tiled
#include "chw_fwd_tc.cuh"  // sum_partials

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 64;   // two warps of 4 x 8 threads, 2 x 2 pixels each
constexpr int kMinBlocks = 6;  // blocks an SM holds: at most 170 registers a thread
constexpr int kStages = 3;
constexpr int kRows = 2;       // pixel rows of a thread
constexpr int kTH = 4 * kRows;  // a block's half-res tile: kTH x kTW, a warp's kTH x 16
constexpr int kTW = 32;
constexpr int kEpi = 4;        // input channels whose x the epilogue loads at once
// box column of full-res column 2 qt - 1 + s is s + kCol: the box starts at
// 2 qt - 4, a 16-byte boundary
constexpr int kCol = 3;
constexpr int kAuxThreads = 256;

__host__ __device__ constexpr int ccp_of(int cc) { return (cc + 3) / 4 * 4; }

// A stage: the g box (kBR rows of kBC floats, 128-byte aligned), then the
// weights (16 taps x CCP floats).
constexpr int kBR = 2 * kTH + 2;
constexpr int kBC = 2 * kTW + 8;  // columns 2 qt - 4 .. 2 qt + 2 kTW + 3: a multiple of 16 bytes
constexpr int kBoxBytes = (kBR * kBC * 4 + 127) / 128 * 128;

__host__ __device__ constexpr int stage_bytes_of(int ccp) {
  return (kBoxBytes + 16 * ccp * 4 + 127) / 128 * 128;
}

struct DxArgs {
  const void* x;       // (N, C, H, W)
  const void* g;       // (N, Co, 2H, 2W)
  const float* wq;     // (Co, groups, 16, CCP) packed weights
  const float* scale;  // (C)
  const float* shift;
  void* dx;            // (N, C, H, W)
  float* part;         // (N x tiles, 2C)
  int N, C, H, W, Co, relu, zeros, groups, tiles_w, tiles_img, tma;
};

// wq[o, grp, u * 4 + v, k] = wt[o, grp * CC + k, u, v] (zero past C and CC)
// from w (Co, C, 3, 3): rows first (taps K2, K1 + K2, K0 + K1, K0), then
// columns, each a float32 add as _upconv_dx_weights takes them.
__global__ void __launch_bounds__(kAuxThreads)
pack_weights(const float* __restrict__ w, float* __restrict__ wq, int C, int Co, int groups,
             int cc, int ccp) {
  const long long total = static_cast<long long>(Co) * groups * 16 * ccp;
  for (long long i = blockIdx.x * static_cast<long long>(kAuxThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kAuxThreads) {
    const int k = static_cast<int>(i % ccp);
    const int tap = static_cast<int>((i / ccp) % 16);
    const int grp = static_cast<int>((i / (16 * ccp)) % groups);
    const int o = static_cast<int>(i / (16LL * ccp * groups));
    const int c = grp * cc + k;
    float v = 0.f;
    if (k < cc && c < C) {
      const float* k3 = w + (static_cast<size_t>(o) * C + c) * 9;
      const int u = tap / 4, t = tap % 4;
      float r[3];  // the row tap u of each column kx
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float k0 = k3[kx], k1 = k3[3 + kx], k2 = k3[6 + kx];
        r[kx] = u == 0 ? k2 : u == 1 ? k1 + k2 : u == 2 ? k0 + k1 : k0;
      }
      v = t == 0 ? r[2] : t == 1 ? r[1] + r[2] : t == 2 ? r[0] + r[1] : r[0];
    }
    wq[i] = v;
  }
}

// One TMA bulk copy of `bytes` (a multiple of 16) to shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(itg::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(itg::smem_addr(bar))
      : "memory");
}

// Two consecutive values of a row (8-byte aligned where vec), as float32.
template <typename T>
__device__ __forceinline__ float2 load2(const T* p, bool vec, bool second) {
  if constexpr (sizeof(T) == 4) {
    if (vec) return *reinterpret_cast<const float2*>(p);
  } else {
    if (vec) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
      return __bfloat1622float2(v);
    }
  }
  return make_float2(to_f32<T>(p[0]), second ? to_f32<T>(p[1]) : 0.f);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, bool vec, bool second) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
      return;
    }
  } else {
    if (vec) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
      return;
    }
  }
  p[0] = from_f32<T>(a);
  if (second) p[1] = from_f32<T>(b);
}

// Grid (groups x tiles, N): block (grp, tile) of image n. Dynamic shared
// memory: kStages stages, an mbarrier per stage, the warps' sums. tmap: g
// as a 4-D tensor map (2W, 2H, Co, N) with box (kBC, kBR, 1, 1), where
// a.tma.
template <typename T, int CC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
upconv_dx_f32_kernel(const DxArgs a, const __grid_constant__ CUtensorMap tmap) {
  constexpr int CCP = ccp_of(CC);
  constexpr int kStageBytes = stage_bytes_of(CCP);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  float* s_red = reinterpret_cast<float*>(s_bar + kStages);  // (2 warps, 2 CC)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, H = a.H, W = a.W, Co = a.Co;
  const int grp = blockIdx.x % a.groups;
  const int tile = blockIdx.x / a.groups;
  const int n = blockIdx.y;
  const int pt = (tile / a.tiles_w) * kTH;  // the tile's first half-res row, column
  const int qt = (tile % a.tiles_w) * kTW;
  const int c0 = grp * CC;
  const int pl = kRows * (lane >> 3);  // this thread's first pixel row, column in the tile
  const int ql = 16 * warp + 2 * (lane & 7);
  const int p0 = pt + pl, q0 = qt + ql;

  auto stage = [&](int o) { return smem + (o % kStages) * kStageBytes; };
  const T* gn = static_cast<const T*>(a.g) + static_cast<size_t>(n) * Co * 4 * H * W;
  const float* wq_grp = a.wq + static_cast<size_t>(grp) * 16 * CCP;
  const uint32_t w_bytes = 16 * CCP * 4;

  auto issue = [&](int o) {  // one thread: the TMA box of g and the weights of channel o
    unsigned char* st = stage(o);
    uint64_t* bar = s_bar + o % kStages;
    itg::mbar_expect_tx(bar, kBR * kBC * 4 + w_bytes);
    itg::tma_load_4d(st, &tmap, bar, 2 * qt - 1 - kCol, 2 * pt - 1, o, n);
    bulk_load(st + kBoxBytes, wq_grp + static_cast<size_t>(o) * a.groups * 16 * CCP, w_bytes,
              bar);
  };
  auto load_plain = [&](int o) {  // every thread: element loads, zeros outside g
    float* sg = reinterpret_cast<float*>(stage(o));
    float* sw = reinterpret_cast<float*>(stage(o) + kBoxBytes);
    const T* go = gn + static_cast<size_t>(o) * 4 * H * W;
    for (int i = tid; i < kBR * kBC; i += kThreads) {
      const int r = 2 * pt - 1 + i / kBC, s = 2 * qt - 1 - kCol + i % kBC;
      const bool ok = r >= 0 && r < 2 * H && s >= 0 && s < 2 * W;
      sg[i] = ok ? to_f32<T>(go[static_cast<size_t>(r) * 2 * W + s]) : 0.f;
    }
    const float* src = wq_grp + static_cast<size_t>(o) * a.groups * 16 * CCP;
    for (int i = tid; i < 16 * CCP; i += kThreads) sw[i] = src[i];
  };

  if (a.tma) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) itg::mbar_init(s_bar + i, 1);
      itg::mbar_init_fence();
      for (int o = 0; o < kStages - 1 && o < Co; ++o) issue(o);
    }
    __syncthreads();
  }

  // the border folds of replicate padding, on the g values in registers: a
  // pixel row on the top (bottom) edge adds g row 0 (2H - 1), box row r_top
  // (r_bot), to its row at row tap 3 (0); a pixel column on the left (right)
  // edge adds g column 0 (2W - 1) to the value it reads at column tap 3 (0).
  // The corners follow from both.
  const bool fold = !a.zeros;
  const bool redge = fold && (p0 == 0 || (H - 1 - p0 >= 0 && H - 1 - p0 < kRows));
  const bool left = fold && q0 == 0;
  const bool right0 = fold && q0 == W - 1, right1 = fold && q0 + 1 == W - 1;
  const bool cedge = left || right0 || right1;
  const int r_top = 1, r_bot = 2 * (H - pt);

  float acc[kRows][2][CC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int k = 0; k < CC; ++k) acc[i][j][k] = 0.f;
    }
  }

  for (int o = 0; o < Co; ++o) {
    if (a.tma) {
      __syncthreads();  // every thread is done with stage o - 1, which now takes o + kStages - 1
      if (tid == 0 && o + kStages - 1 < Co) {
        itg::fence_proxy_async();  // the stage's earlier reads come before the copy's writes
        issue(o + kStages - 1);
      }
      itg::mbar_wait(s_bar + o % kStages, (o / kStages) & 1);
    } else {
      __syncthreads();
      load_plain(o);
      __syncthreads();
    }
    const float* sg = reinterpret_cast<const float*>(stage(o));
    const float* sw = reinterpret_cast<const float*>(stage(o) + kBoxBytes);
    constexpr int bc = kBC;
    // one row tap an iteration: its loads stay next to its FMAs
#pragma unroll 1
    for (int u = 0; u < 4; ++u) {
      // the g rows of pixel rows pl + i at row tap u: box rows 2 (pl + i) +
      // u, columns 2 ql + kCol .. 2 ql + kCol + 5
      float r[kRows][6];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float* row = sg + (2 * (pl + i) + u) * bc + 2 * ql + kCol;
        const float4 v4 = *reinterpret_cast<const float4*>(row + 1);
        r[i][0] = row[0]; r[i][1] = v4.x; r[i][2] = v4.y; r[i][3] = v4.z; r[i][4] = v4.w;
        r[i][5] = row[5];
      }
      if (redge) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int p = p0 + i;
          if ((u == 3 && p == 0) || (u == 0 && p == H - 1)) {
            const float* fr = sg + (u == 3 ? r_top : r_bot) * bc + 2 * ql + kCol;
#pragma unroll
            for (int e = 0; e < 6; ++e) r[i][e] += fr[e];
          }
        }
      }
      // the values pixel column 0 reads at column tap 3 and column 1 at tap
      // 0, with their folds (column 0's tap 0 value is its own)
      float m3[kRows], m2[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        m3[i] = r[i][3];
        m2[i] = r[i][2];
      }
      if (cedge) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (left) m3[i] += r[i][1];
          if (right1) m2[i] += r[i][4];
          if (right0) r[i][0] += r[i][2];
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        // the CC weights of tap (u, v): 16-byte loads, then single ones
        const float* wp = sw + (4 * u + v) * CCP;
        float wv[CC];
#pragma unroll
        for (int k = 0; k + 4 <= CC; k += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wp + k);
          wv[k] = w4.x; wv[k + 1] = w4.y; wv[k + 2] = w4.z; wv[k + 3] = w4.w;
        }
#pragma unroll
        for (int k = CC / 4 * 4; k < CC; ++k) wv[k] = wp[k];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float gv = j == 0 && v == 3 ? m3[i] : j == 1 && v == 0 ? m2[i] : r[i][2 * j + v];
#pragma unroll
            for (int k = 0; k < CC; ++k) acc[i][j][k] = fmaf(gv, wv[k], acc[i][j][k]);
          }
        }
      }
    }
  }

  // -- the ReLU mask, dx = dA * scale, and this thread's sums over its
  // pixels; x's values of kEpi channels are loaded together
  const T* __restrict__ xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * C * H * W;
  T* __restrict__ dxn = static_cast<T*>(a.dx) + static_cast<size_t>(n) * C * H * W;
  const bool vec = W % 2 == 0;
  const bool second = q0 + 1 < W;
  float sums[2 * CC];
#pragma unroll
  for (int k0 = 0; k0 < CC; k0 += kEpi) {
    float2 xv[kEpi][kRows];
#pragma unroll
    for (int e = 0; e < kEpi; ++e) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int c = c0 + k0 + e, p = p0 + i;
        xv[e][i] = k0 + e < CC && c < C && p < H && q0 < W
                       ? load2(xn + (static_cast<size_t>(c) * H + p) * W + q0, vec && second,
                               second)
                       : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int e = 0; e < kEpi; ++e) {
      const int k = k0 + e, c = c0 + k;
      if (k >= CC) break;
      float s_dsc = 0.f, s_dsh = 0.f;
      if (c < C && q0 < W) {
        const float sc = a.scale[c], sh = a.shift[c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int p = p0 + i;
          if (p >= H) break;
          float da[2] = {acc[i][0][k], second ? acc[i][1][k] : 0.f};
          const float xs[2] = {xv[e][i].x, xv[e][i].y};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (a.relu && !(__fadd_rn(__fmul_rn(xs[j], sc), sh) > 0.f)) da[j] = 0.f;
            s_dsc += da[j] * xs[j];
            s_dsh += da[j];
          }
          store2(dxn + (static_cast<size_t>(c) * H + p) * W + q0, da[0] * sc, da[1] * sc,
                 vec && second, second);
        }
      }
      sums[k] = s_dsc;
      sums[CC + k] = s_dsh;
    }
  }
  // -- the block's partials: a fixed tree over each warp, then warp 0 + warp 1
#pragma unroll
  for (int k = 0; k < 2 * CC; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sums[k] = __fadd_rn(sums[k], __shfl_xor_sync(0xffffffffu, sums[k], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 2 * CC; ++k) s_red[warp * 2 * CC + k] = sums[k];
  }
  __syncthreads();
  if (tid < 2 * CC) {
    const int k = tid % CC, c = c0 + k;
    if (c < C) {
      float* row = a.part + (static_cast<size_t>(n) * a.tiles_img + tile) * 2 * C;
      row[(tid < CC ? 0 : C) + c] = __fadd_rn(s_red[tid], s_red[2 * CC + tid]);
    }
  }
}

// Sets `tma` where TMA reads g: float32, W even (16-byte row strides) and g
// 16-byte aligned; then encodes g as a 4-D tensor map with the stage's box.
int g_tensor_map(const void* g, int bf16, int n, int h, int width, int co, int* tma,
                 CUtensorMap* tmap) {
  *tma = !bf16 && width % 2 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (!*tma) return 0;
  const itg::dw::EncodeTiled encode = itg::dw::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(2 * width), static_cast<cuuint64_t>(2 * h),
                              static_cast<cuuint64_t>(co), static_cast<cuuint64_t>(n)};
  const cuuint64_t row = 4ull * 2 * width;
  const cuuint64_t strides[3] = {row, row * 2 * h, row * 2 * h * co};  // bytes, dims 1..3
  const cuuint32_t box[4] = {kBC, kBR, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(g), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int aux_blocks(long long total) {
  const long long b = (total + kAuxThreads - 1) / kAuxThreads;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

template <typename T, int CC>
int launch(DxArgs a, const float* w, float* wq, float* dsc, float* dsh, cudaStream_t stream) {
  constexpr int CCP = ccp_of(CC);
  pack_weights<<<aux_blocks(static_cast<long long>(a.Co) * a.groups * 16 * CCP), kAuxThreads, 0,
                 stream>>>(w, wq, a.C, a.Co, a.groups, CC, CCP);
  CUtensorMap tmap{};
  int rc = g_tensor_map(a.g, sizeof(T) == 2, a.N, a.H, a.W, a.Co, &a.tma, &tmap);
  if (rc) return rc;
  const size_t smem = static_cast<size_t>(kStages) * stage_bytes_of(CCP) +
                      kStages * sizeof(uint64_t) + 4 * CC * sizeof(float);
  auto kernel = upconv_dx_f32_kernel<T, CC>;
  if (smem > 48 * 1024) {
    rc = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)));
    if (rc) return rc;
  }
  const dim3 grid(a.groups * a.tiles_img, a.N);
  kernel<<<grid, kThreads, smem, stream>>>(a, tmap);
  itg::sum_partials<<<2 * a.C, itg::kReduceThreads, 0, stream>>>(a.part, dsc, dsh,
                                                                a.N * a.tiles_img, a.C);
  return itg::last_error();
}

template <typename T>
int dispatch(int cc, DxArgs a, const float* w, float* wq, float* dsc, float* dsh,
             cudaStream_t stream) {
  switch (cc) {
    case 8: return launch<T, 8>(a, w, wq, dsc, dsh, stream);
    case 13: return launch<T, 13>(a, w, wq, dsc, dsh, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (N, C, H, W), g (N, Co, 2H, 2W), dx (N, C, H, W): activation type
// (float32, or bfloat16 when bf16 != 0). w (Co, C, 3, 3), scale/shift (C):
// float32. wq: (Co, groups, 16, ccp) float32 scratch for the packed weights
// (ccp = cc rounded up to a multiple of 4); part: (N x tiles_h x tiles_w,
// 2C) float32 scratch; dsc/dsh (C) float32, written. The plan comes from
// ops/kernels.py: upconv_dx_f32_plan (cc 8 or 13, groups = ceil(C / cc),
// tiles_h x tiles_w the 8 x 32 tiles that cover H x W); a plan that does
// not cover the shape exactly so is refused. Three launches (pack, dx, the
// sums); returns cudaGetLastError() after them.
extern "C" int itg_upconv3x3_chw_dx(const void* x, const void* g, const void* w,
                                    const void* scale, const void* shift, void* wq, void* dx,
                                    void* part, void* dsc, void* dsh, int n, int c, int h,
                                    int width, int co, int relu, int zeros, int bf16, int cc,
                                    int groups, int tiles_h, int tiles_w, void* stream) {
  const auto covers = [](int count, int step, int extent) {
    return count >= 1 && (count - 1) * step < extent && count * step >= extent;
  };
  if (n < 1 || c < 1 || h < 1 || width < 1 || co < 1 || cc < 1 || !covers(groups, cc, c) ||
      !covers(tiles_h, kTH, h) || !covers(tiles_w, kTW, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DxArgs a{x, g, static_cast<float*>(wq), static_cast<const float*>(scale),
           static_cast<const float*>(shift), dx, static_cast<float*>(part), n, c, h, width, co,
           relu, zeros, groups, tiles_w, tiles_h * tiles_w, 0};
  const auto* wf = static_cast<const float*>(w);
  auto* wqf = static_cast<float*>(wq);
  auto* a1 = static_cast<float*>(dsc);
  auto* a2 = static_cast<float*>(dsh);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(cc, a, wf, wqf, a1, a2, st);
  return dispatch<float>(cc, a, wf, wqf, a1, a2, st);
}
