// The discriminator stem's input gradient on the tensor cores, for
// bfloat16: for the 4x4 / stride-2 / zero-pad-1 convolution of the
// channels-major fake image (N, C, H, W), C <= 4 (3 on the path), with the
// NHWC cotangent g (N, H/2, W/2, Co),
//   dx[n, c, r, s] = sum_{o, ky, kx} g[n, i, j, o] * w[o, c, ky, kx]
//                    over r = 2i + ky - 1, s = 2j + kx - 1 (g zero outside).
// w is rounded to bf16 first, as the reference rounds it
// (pallas_conv.py:3071, wt = _stem_pack_w(w).T.astype(gc.dtype)); every
// product of two bf16 values is exact in float32, the sums are float32 and
// dx is rounded once to bf16. Its plain version is ops/kernels.py:
// stem_dx_tc_plain (stem_dx_plain with w rounded to bf16); only the order of
// the float32 sums differs.
//
// Replaces K13 dx infinite_texture_gans_tpu/ops/pallas_conv.py:
// _stem_dx_call (:2972, pallas_call :2977, kernel _stem_dx_kernel :2877),
// reached through conv4x4s2_stem_chw (:3086). Float32 takes the CUDA-core
// kernel of stem_dx_f32.cu.
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per g pixel against 2 Co
// bytes of g read and 8 C bytes of dx written (C = 3, Co = 64: 6,144 FLOPs
// for 152 bytes), so bytes, and g is 84% of them. The design:
// - Sub-pixel phases, shifts as addresses. Write dx row r = 2p + py and
//   column s = 2q + px. Phase pixel (p, q) reads g at (p + di, q + dj),
//   di, dj in {-1, 0, +1}, with the tap ky = py + 1 - 2 di (kept where it is
//   0..3: py = 0 takes di = -1 and 0, py = 1 takes di = 0 and +1), and
//   kx = px + 1 - 2 dj the same way along the columns.
// - One accumulator for all phases, on warp-level mma.sync m16n8k16 (bf16
//   operands, float32 sums): M = 16 consecutive phase columns q of one phase
//   row p, N = (py, px, c) with c padded to 4 as two n8 tiles (one per py),
//   K = the output channels of g. For each of the 9 shifts, A is the staged
//   g tile read by ldmatrix at a shifted row address, and B the shift's
//   packed bf16 weights for each n8 tile whose py it feeds: 12 B operands
//   (py, a, dj) with di = py - 1 + a, zero columns where dj feeds no px. So
//   a tile's k16 step is 9 ldmatrix.x4 and 12 mma per m16 tile.
// - Staging. A block takes kTR x kTJ phase pixels of one image (2 kTR x 2 kTJ
//   dx pixels per channel) and stages g rows i0 - 1 .. i0 + kTR and columns
//   j0 - 1 .. j0 + kTJ, pixel-major, kKC channels at a time, by 16-byte
//   cp.async into a ring of two stages (the next chunk's copies fly while one
//   is multiplied). A staged pixel is 5 16-byte units (odd), so the 8 row
//   addresses of an ldmatrix fall in distinct banks at every shift. Where Co
//   is no multiple of 8 or g is not 16-byte aligned, g is staged element by
//   element; channels past Co are zero (and so are their weights).
// - Weights. The entry point's first launch packs w into the 12 B operands
//   (ops/kernels.py: pack_stem_dx_weights, bit for bit): wp[u][n][o], u = 6 py
//   + 3 a + dj + 1, n = 4 px + c, Co padded to kKC; each stage also takes the
//   chunk's 12 x 8 rows of wp, whose ldmatrix gives the B fragments.
// - Epilogue. The fragments go, rounded to bf16, into a shared (C, 2 kTR,
//   2 kTJ) tile, whose dx rows are stored channels-major 16 bytes a lane
//   (element by element where W is no multiple of 8 or dx is not aligned).
// - No atomics: every dx element is summed by one lane in one fixed order
//   (Co chunks, k16 steps, shifts), so two calls give the same bits.
// The TPU kernel's tap-gradient matrix, 0/1 column-scatter matmuls and
// spill rows folded back by XLA have no counterpart.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using itg::ldmatrix_x4;
using itg::mma_bf16;
using itg::smem_addr;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTR = kWarps;        // phase rows per tile: one a warp
constexpr int kTJ = 32;            // phase columns per tile: two m16 tiles
constexpr int kSR = kTR + 2;       // staged g rows
constexpr int kSC = kTJ + 2;       // staged g columns
constexpr int kKC = 32;            // output channels of g per chunk: two k16 steps
constexpr int kPS = kKC + 8;       // bf16 per staged pixel or weight row (5 16-byte units)
constexpr int kFrags = 12;         // B operands (py, a, dj)
constexpr int kStages = 2;
constexpr int kOutS = 2 * kTJ + 8; // bf16 per dx row of the epilogue tile (9 units)
constexpr int kMaxCo = 512;        // --D_ch's limit, as the forward's (stem_fwd_tc.cu: kMaxCo)

constexpr size_t kGBytes = sizeof(bf16) * kSR * kSC * kPS;
constexpr size_t kWBytes = sizeof(bf16) * kFrags * 8 * kPS;
constexpr size_t kStageBytes = kGBytes + kWBytes;
constexpr size_t kSmem = kStages * kStageBytes;
static_assert(sizeof(bf16) * 4 * 2 * kTR * kOutS <= kSmem, "the epilogue tile fits the stages");

struct StemDxArgs {
  const uint16_t* g;   // (N, H/2, W/2, Co)
  const uint16_t* wp;  // (kFrags, 8, CoP) packed B operands
  uint16_t* dx;        // (N, C, H, W)
  int C, H, W, Co, CoP;
  int gvec;  // g by 16-byte units: Co % 8 == 0 and g 16-byte aligned
  int dvec;  // dx by 16-byte units: W % 8 == 0 and dx 16-byte aligned
};

// wp[u][n][o] = bf16(w[o, c, ky, kx]) for u = 6 py + 3 a + dj + 1, n = 4 px +
// c, ky = 3 - py - 2 a, kx = px + 1 - 2 dj; zero where kx is outside 0..3, c
// >= C or o >= Co.
__global__ void stem_dx_tc_pack_kernel(const float* __restrict__ w, bf16* __restrict__ wp, int C,
                                       int Co, int CoP) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kFrags * 8 * CoP) return;
  const int o = idx % CoP, n = (idx / CoP) % 8, u = idx / (8 * CoP);
  const int py = u / 6, a = (u / 3) % 2, dj = u % 3 - 1;
  const int px = n / 4, c = n % 4;
  const int ky = 3 - py - 2 * a, kx = px + 1 - 2 * dj;
  float v = 0.f;
  if (o < Co && c < C && kx >= 0 && kx < 4) {
    v = w[((static_cast<size_t>(o) * C + c) * 4 + ky) * 4 + kx];
  }
  wp[idx] = __float2bfloat16_rn(v);
}

// Starts the copies of chunk ck (channels kKC ck ..) of the tile's g and of
// the packed weights into a stage: one cp.async group.
__device__ __forceinline__ void stage_chunk(const StemDxArgs& a, int n, int i0, int j0, int ck,
                                            uint16_t* s_g, uint16_t* s_w) {
  const int H2 = a.H / 2, W2 = a.W / 2, Co = a.Co;
  for (int u = threadIdx.x; u < kSR * kSC * (kKC / 8); u += kThreads) {
    const int pix = u / (kKC / 8), q = u % (kKC / 8);
    const int i = i0 - 1 + pix / kSC, j = j0 - 1 + pix % kSC, oc = kKC * ck + 8 * q;
    uint16_t* dst = s_g + pix * kPS + 8 * q;
    const bool in = i >= 0 && i < H2 && j >= 0 && j < W2;
    const uint16_t* src = a.g + ((static_cast<size_t>(n) * H2 + (in ? i : 0)) * W2 +
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
  for (int u = threadIdx.x; u < kFrags * 8 * (kKC / 8); u += kThreads) {
    const int row = u / (kKC / 8), q = u % (kKC / 8);
    itg::cp_async16(s_w + row * kPS + 8 * q,
                    a.wp + static_cast<size_t>(row) * a.CoP + kKC * ck + 8 * q);
  }
  itg::cp_async_commit();
}

// Grid (ceil(W2 / kTJ), ceil(H2 / kTR), N), kThreads threads, dynamic shared
// memory kSmem: kStages x [g: kSR x kSC pixels x kPS bf16][w: kFrags x 8 rows
// x kPS bf16]; the epilogue's (C, 2 kTR, kOutS) dx tile reuses them. Warp w
// takes phase row i0 + w and both its m16 tiles (columns j0 .., j0 + 16 ..).
__global__ void __launch_bounds__(kThreads, 3) stem_dx_tc_kernel(StemDxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto s_g = [&](int s) { return reinterpret_cast<uint16_t*>(smem + s * kStageBytes); };
  auto s_w = [&](int s) {
    return reinterpret_cast<uint16_t*>(smem + s * kStageBytes + kGBytes);
  };
  uint16_t* s_out = reinterpret_cast<uint16_t*>(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z, i0 = blockIdx.y * kTR, j0 = blockIdx.x * kTJ;
  const int nck = a.CoP / kKC;

  stage_chunk(a, n, i0, j0, 0, s_g(0), s_w(0));
  if (1 < nck) {
    stage_chunk(a, n, i0, j0, 1, s_g(1), s_w(1));
  } else {
    itg::cp_async_commit();  // an empty group keeps the count
  }

  // ldmatrix lanes: matrix mi = lane >> 3, row rr = lane & 7. A (an m16 tile):
  // pixel rr + 8 (mi & 1), channels 8 (mi >> 1) ..; B (operands 2v, 2v + 1):
  // operand 2v + (mi >> 1), row rr, channels 8 (mi & 1) ..
  const int mi = lane >> 3, rr = lane & 7;
  const uint32_t a_lane = 2 * (((warp + 1) * kSC + 1 + rr + 8 * (mi & 1)) * kPS + 8 * (mi >> 1));
  const uint32_t b_lane = 2 * (((mi >> 1) * 8 + rr) * kPS + 8 * (mi & 1));
  float acc[2][2][4];  // [m16 tile][py][fragment]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][t][e] = 0.f;
    }
  }

  for (int ck = 0; ck < nck; ++ck) {
    itg::cp_async_wait_group<kStages - 1>();
    __syncthreads();  // chunk ck is staged
    const uint32_t a_base = smem_addr(s_g(ck % kStages)) + a_lane;
    const uint32_t b_base = smem_addr(s_w(ck % kStages)) + b_lane;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t b[kFrags][2];
#pragma unroll
      for (int v = 0; v < kFrags / 2; ++v) {
        uint32_t r[4];
        ldmatrix_x4(r, b_base + 2 * (2 * v * 8 * kPS + 16 * ks));
        b[2 * v][0] = r[0];
        b[2 * v][1] = r[1];
        b[2 * v + 1][0] = r[2];
        b[2 * v + 1][1] = r[3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int di = -1; di <= 1; ++di) {
#pragma unroll
          for (int dj = -1; dj <= 1; ++dj) {
            uint32_t af[4];
            ldmatrix_x4(af, a_base + 2 * ((di * kSC + dj + 16 * h) * kPS + 16 * ks));
            if (di <= 0) {  // py = 0, a = di + 1
              const int u = 3 * (di + 1) + dj + 1;
              mma_bf16(acc[h][0], af, b[u][0], b[u][1]);
            }
            if (di >= 0) {  // py = 1, a = di
              const int u = 6 + 3 * di + dj + 1;
              mma_bf16(acc[h][1], af, b[u][0], b[u][1]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read
    if (ck + kStages < nck) {
      stage_chunk(a, n, i0, j0, ck + kStages, s_g(ck % kStages), s_w(ck % kStages));
    } else {
      itg::cp_async_commit();
    }
  }
  itg::cp_async_wait_all();

  // -- epilogue: fragment e of n8 tile py holds phase column jb + gq (+ 8 for
  // e >= 2), px = t >> 1, channel 2 (t & 1) + (e & 1): dx row 2 (warp) + py,
  // column 2 (jb + gq) + px of the tile.
  const int gq = lane >> 2, t4 = lane & 3;
  const int px = t4 >> 1, c0 = 2 * (t4 & 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int py = 0; py < 2; ++py) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + (e & 1);
        if (c < a.C) {
          const int row = 2 * warp + py, col = 2 * (16 * h + gq + 8 * (e >> 1)) + px;
          s_out[(c * 2 * kTR + row) * kOutS + col] =
              __bfloat16_as_ushort(__float2bfloat16_rn(acc[h][py][e]));
        }
      }
    }
  }
  __syncthreads();
  const int r0 = 2 * i0, s0 = 2 * j0;
  constexpr int kUnits = 2 * kTJ / 8;  // 16-byte units per dx row of the tile
  if (a.dvec) {
    for (int u = tid; u < a.C * 2 * kTR * kUnits; u += kThreads) {
      const int row = u / kUnits, k = u % kUnits;  // row = c * 2 kTR + rr
      const int c = row / (2 * kTR), r = r0 + row % (2 * kTR), s = s0 + 8 * k;
      if (r < a.H && s < a.W) {
        uint16_t* dst = a.dx + ((static_cast<size_t>(n) * a.C + c) * a.H + r) * a.W + s;
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(s_out + row * kOutS + 8 * k);
      }
    }
  } else {
    for (int u = tid; u < a.C * 2 * kTR * 2 * kTJ; u += kThreads) {
      const int row = u / (2 * kTJ), k = u % (2 * kTJ);
      const int c = row / (2 * kTR), r = r0 + row % (2 * kTR), s = s0 + k;
      if (r < a.H && s < a.W) {
        a.dx[((static_cast<size_t>(n) * a.C + c) * a.H + r) * a.W + s] = s_out[row * kOutS + k];
      }
    }
  }
}

}  // namespace

// K13 dx on the tensor cores. g (n, h/2, w/2, co) bfloat16, w (co, c, 4, 4)
// float32, 1 <= c <= 4, h and w even, 1 <= co <= kMaxCo; wp (12, 8, co
// padded to a multiple of 32) bfloat16 scratch, written with the packed
// weights; dx (n, c, h, w) bfloat16, written. Two launches (the pack, then
// the kernel); returns the first CUDA error (cudaErrorInvalidValue for a
// shape the kernels do not take).
extern "C" int itg_stem_dx_tc(const void* g, const void* w, void* wp, void* dx, int n, int c,
                              int h, int width, int co, void* stream) {
  if (n < 1 || h < 2 || width < 2 || h % 2 || width % 2 || c < 1 || c > 4 || co < 1 ||
      co > kMaxCo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int cop = (co + kKC - 1) / kKC * kKC;
  const int packed = kFrags * 8 * cop;
  stem_dx_tc_pack_kernel<<<(packed + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<bf16*>(wp), c, co, cop);
  if (int rc = itg::last_error()) return rc;
  if (cudaError_t e = cudaFuncSetAttribute(stem_dx_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kSmem))) {
    return static_cast<int>(e);
  }
  const int gvec = co % 8 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int dvec = width % 8 == 0 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  const StemDxArgs a{static_cast<const uint16_t*>(g), static_cast<const uint16_t*>(wp),
                     static_cast<uint16_t*>(dx), c, h, width, co, cop, gvec, dvec};
  const dim3 grid((width / 2 + kTJ - 1) / kTJ, (h / 2 + kTR - 1) / kTR, n);
  stem_dx_tc_kernel<<<grid, kThreads, kSmem, st>>>(a);
  return itg::last_error();
}
