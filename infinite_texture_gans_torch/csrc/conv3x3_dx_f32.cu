// The input-side gradient of the generator tail's fused BN-fold -> ReLU ->
// border -> 3x3 convolution (K6) on the CUDA cores: the float32 route
// (bf16 runs on the tensor cores in chw_dx_tc.cu; this entry point takes
// bf16 too).
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:775 _conv3x3_chw_dx
// (kernel _dx_kernel :644): for x (N, C, H, W) and g (N, Co, H, W), the
// cotangent of the forward's y,
//   dP = conv3x3^T(g) on the padded (H + 2) x (W + 2) grid,
//   da = dP on the H x W interior with the replicate border folded back
//        onto the edge (the columns first, then the rows, as ops/kernels.py:
//        _fold_border; a corner takes its ring cells through both), or with
//        the border dropped (zeros padding);
//   da = 0 where the forward's ReLU was off (scale * x + shift <= 0,
//        recomputed with the forward's rounding: __fmul_rn, __fadd_rn);
//   dx = da * scale, d(scale) = sum da * x, d(shift) = sum da over (N, H, W).
//
// What bounds it on the H100: 2 * 9 * C * Co FLOPs per pixel against 4 (2 C
// + Co) bytes in float32. At the Experiment-1 shapes (26 -> 26 at 192^2,
// 13 -> 13 at 384^2, N = 8) FFMA issue bounds it (67 TFLOP/s outside the
// tensor cores: 0.054 ms a call); at Co = 3 (13 -> 3 at 384^2) the bytes
// do (0.041 ms). The operands come from shared memory, whose load pipe
// serves one 4-byte word a lane a cycle (a 16-byte load takes four cycles
// even as a broadcast), so the design counts loaded words per FMA. It is
// K1's forward (conv3x3_fwd_f32.cu) with the roles of C and Co swapped,
// g read through the flipped taps:
// - Register outer products. A thread owns 16 consecutive pixels of a row x
//   CC input channels (CC 7, or 3 where C <= 3 or where 7 would leave too
//   few warps). Per output channel and row tap it loads its 18 g values
//   once (a ring cell, four 16-byte loads, a ring cell) and keeps them
//   across the three column taps; per tap it loads its CC weights (a
//   broadcast: the warp shares them) and does 16 CC FMAs. At CC = 7 that is
//   336 FMAs for 39 loaded words. (13 channels a thread would divide the
//   flagship's 26 and 52, but 16 pixels x 13 channels are 208 accumulators:
//   more than a thread holds; 7 wastes one channel of 14.)
// - A warp (a group) owns a 16 x 32 tile of da and CC input channels; a
//   block holds G groups (up to 4) over the same tile, so at C = 26 and 13
//   every input channel is in one block and g is staged once. The planner
//   in ops/kernels.py (conv3x3_dx_f32_plan) picks CC and G from (N, C, Co,
//   H, W) and the card's SM count; the entry point launches its grid. The
//   loop over output channels runs exactly Co times: Co = 3 costs 3.
// - Overlapped staging. Output channels come in chunks of kOC: the next
//   chunk's g tile (18 rows of 32 columns and the ring cells, zeros outside
//   the image) and its flipped weights land by cp.async in the other half of
//   a double buffer while this chunk's FMAs run. A staged row is 36 floats:
//   its 32 interior columns arrive as eight 16-byte copies wherever the tile
//   lies inside an aligned image, and the 16 row lanes of a warp read their
//   windows as 16-byte loads from distinct banks.
// - The folds on the g values in registers. A padded ring cell's dP reaches
//   the edge pixel through the same weights as the g row (column) one step
//   in: a pixel on the top edge adds g row 0 to the row it reads at row tap
//   0 (the weights' ky = 0), one on the bottom edge g row H - 1 at ky = 2;
//   the left edge pixel adds g column 0 at kx = 0; the right edge pixel's
//   column fold (g column W - 1 at kx = 2, read from the staged rows) goes to
//   CC sums of its own in shared memory (registers would spill), added in
//   the epilogue. The corners follow from both. Only the warps that hold an
//   edge pixel take these branches.
// - Each output sums (o, ky, kx) in one fixed order, and its folds in one
//   order, wherever its tile lies. d(scale), d(shift): each group adds its
//   pixels in a fixed order (a thread's run, then a shuffle tree over the
//   warp) and writes the tile's partial; a last launch adds the partials in
//   one fixed order (chw_fwd_tc.cuh: sum_partials). No atomics: two calls
//   give the same bits.
// Where g cannot be copied 16 bytes at a time (W not a multiple of 4, an
// unaligned pointer, a tile past the right edge, bf16), the copies are cell
// by cell.
#include "chw_fwd_tc.cuh"  // sum_partials; common.cuh, cp.async groups

namespace {

using itg::cp_async16z;
using itg::cp_async4;
using itg::load_run;
using itg::store_run;
using itg::to_f32;

constexpr int kR = 16;              // pixels of a thread, along a row
constexpr int kTH = 16;             // rows of a tile: the 16 row lanes of a warp
constexpr int kTW = 32;             // columns of a tile: 2 runs of kR
constexpr int kGR = kTH + 2;        // staged g rows
constexpr int kGS = 36;             // floats a staged row: 16-byte aligned, 9 units apart
constexpr int kGC = 4 + kGR * kGS;  // floats a staged channel
constexpr int kUnits = 10;          // copy units a staged row: 8 interior vectors, 2 ring cells
constexpr int kOC = 4;              // output channels a chunk

struct DxArgs {
  const void* x;       // (N, C, H, W)
  const void* g;       // (N, Co, H, W)
  const float* w;      // (Co, C, 3, 3)
  const float* scale;  // (C)
  const float* shift;
  void* dx;            // (N, C, H, W)
  float* part;         // (N tiles, 2C)
  int N, C, H, W, Co, relu, zeros, tiles_w, gvec, xvec;
};

// The window of a staged row from `row` (image column j0 there): columns
// j0 - 1 .. j0 + kR, as a ring cell, four 16-byte loads and a ring cell.
__device__ __forceinline__ void load_window(const float* row, float (&v)[kR + 2]) {
  v[0] = row[-1];
#pragma unroll
  for (int e = 0; e < kR; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(row + e);
    v[e + 1] = f.x, v[e + 2] = f.y, v[e + 3] = f.z, v[e + 4] = f.w;
  }
  v[kR + 1] = row[kR];
}

// Grid (tiles of an image, channel chunks, N), 32 G threads: group grp (warp
// grp) computes input channels cb0 + CC grp .. of the 16 x 32 tile; lane
// (tr, q) the 16 pixels 16 q .. of row tr. Dynamic shared memory: two
// stages of [g: kOC channels of kGC][w: kOC x 9 taps x G CC channels]
// floats, then the right edge's fold sums (32 G threads x CC floats); staged row r of a channel holds image row ty0 - 1 + r, columns
// tx0 .. tx0 + 31 at 4 + kGS r .., its ring cells at 3 + kGS r (column tx0 -
// 1) and 36 + kGS r (tx0 + 32); the weights of tap t = 3 ty + tx of output
// channel oc at (9 oc + t) G CC, flipped: w[o, c, 2 - ty, 2 - tx].
template <typename T, int CC, int G>
__global__ void __launch_bounds__(32 * G, 12 / G) conv3x3_dx_f32_kernel(const DxArgs a) {
  constexpr int kThreads = 32 * G, CB = G * CC;
  constexpr int kStage = kOC * kGC + kOC * 9 * CB;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ty0 = (blockIdx.x / a.tiles_w) * kTH, tx0 = (blockIdx.x % a.tiles_w) * kTW;
  const int cb0 = blockIdx.y * CB;
  const int C = a.C, H = a.H, W = a.W, Co = a.Co;
  const size_t plane = static_cast<size_t>(H) * W;
  const T* gn = static_cast<const T*>(a.g) + static_cast<size_t>(n) * Co * plane;
  // interior units copy 16 bytes where the tile's 32 columns lie in the image
  const bool vec_tile = a.gvec && tx0 + kTW <= W;

  // output channels o0 .. o0 + kOC - 1 of g (zeros past Co and outside the
  // image) and their flipped weights into stage s
  auto stage = [&](int o0, float* s) {
    for (int t = tid; t < kGR * kUnits; t += kThreads) {
      const int r = t / kUnits, u = t % kUnits;
      const int gi = ty0 - 1 + r;
      const bool row_ok = gi >= 0 && gi < H;
      const int j0 = u < 8 ? tx0 + 4 * u : u == 8 ? tx0 - 1 : tx0 + kTW;
      const int cells = u < 8 ? 4 : 1;
      // 16 bytes: four cells inside an aligned row, or a row of zeros
      const bool vec = u < 8 && (vec_tile || !row_ok);
      const size_t roff = row_ok ? static_cast<size_t>(gi) * W : 0;
      const int d = 4 + r * kGS + (u < 8 ? 4 * u : u == 8 ? -1 : kTW);
#pragma unroll
      for (int oc = 0; oc < kOC; ++oc) {
        const int o = o0 + oc;
        const bool live = row_ok && o < Co;
        const T* base = gn + (live ? o * plane + roff : 0);
        float* dst = s + oc * kGC + d;
        if constexpr (sizeof(T) == 4) {
          if (vec) {
            cp_async16z(dst, base + (live ? j0 : 0), live);
            continue;
          }
        }
        for (int e = 0; e < cells; ++e) {
          const int j = j0 + e;
          const bool ok = live && j >= 0 && j < W;
          if constexpr (sizeof(T) == 4) {
            cp_async4(dst + e, base + (ok ? j : 0), ok);
          } else {
            dst[e] = ok ? to_f32<T>(base[j]) : 0.f;
          }
        }
      }
    }
    float* s_w = s + kOC * kGC;
    for (int i = tid; i < kOC * 9 * CB; i += kThreads) {
      const int cb = i % CB, k = i / CB;  // k = 9 oc + tap
      const int o = o0 + k / 9, c = cb0 + cb;
      const bool ok = o < Co && c < C;
      const float* src = ok ? a.w + (static_cast<size_t>(o) * C + c) * 9 + (8 - k % 9) : a.w;
      cp_async4(s_w + i, src, ok);
    }
  };

  const int grp = tid / 32, lane = tid % 32;
  const int tr = lane / 2, q = lane % 2;
  const int i = ty0 + tr, j0 = tx0 + kR * q;  // this thread's row and first column
  const bool fold = !a.zeros && i < H;
  const bool top = fold && i == 0, bot = fold && i == H - 1;
  const bool left = fold && j0 == 0;
  const int pr = W - 1 - j0;  // this thread's pixel on the right edge where 0 <= pr < kR
  const bool right = fold && pr >= 0 && pr < kR;
  float* racc = smem + 2 * kStage + tid * CC;  // this thread's right-edge fold sums
  if (right) {
#pragma unroll
    for (int c = 0; c < CC; ++c) racc[c] = 0.f;
  }

  float acc[kR][CC];
#pragma unroll
  for (int c = 0; c < CC; ++c) {
#pragma unroll
    for (int p = 0; p < kR; ++p) acc[p][c] = 0.f;
  }

  stage(0, smem);
  itg::cp_async_commit();
  const int chunks = (Co + kOC - 1) / kOC;
  for (int k = 0; k < chunks; ++k) {
    const float* cur = smem + (k & 1) * kStage;
    itg::cp_async_wait_all();
    __syncthreads();  // chunk k is in; every thread is done with the other stage
    if (k + 1 < chunks) stage((k + 1) * kOC, smem + ((k + 1) & 1) * kStage);
    itg::cp_async_commit();
    const int noc = min(kOC, Co - k * kOC);
    const float* gs = cur + 4 + tr * kGS + kR * q;
    const float* ws = cur + kOC * kGC + CC * grp;
#pragma unroll 1
    for (int oc = 0; oc < noc; ++oc) {
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        // g row i - 1 + ty, read through the weights' ky = 2 - ty
        float v[kR + 2];
        load_window(gs + oc * kGC + ty * kGS, v);
        if ((ty == 2 && top) || (ty == 0 && bot)) {  // the row fold: g row i
          const float* f = gs + oc * kGC + kGS;
          v[0] += f[-1];
#pragma unroll
          for (int e = 0; e < kR; e += 4) {
            const float4 f4 = *reinterpret_cast<const float4*>(f + e);
            v[e + 1] += f4.x, v[e + 2] += f4.y, v[e + 3] += f4.z, v[e + 4] += f4.w;
          }
          v[kR + 1] += f[kR];
        }
        // pixel 0 at tx = 2 (kx = 0) reads column j0 + 1; on the left edge
        // column 0 folds onto it
        const float vl = left ? v[2] + v[1] : v[2];
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const float* wp = ws + (oc * 9 + ty * 3 + tx) * CB;
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            const float wv = wp[c];
#pragma unroll
            for (int p = 0; p < kR; ++p) {
              acc[p][c] = fmaf(p == 0 && tx == 2 ? vl : v[p + tx], wv, acc[p][c]);
            }
          }
        }
        if (right) {  // pixel pr at tx = 0 (kx = 2) also takes column W - 1
          float vr = gs[oc * kGC + ty * kGS + pr];
          if ((ty == 2 && top) || (ty == 0 && bot)) vr += gs[oc * kGC + kGS + pr];
          const float* wp = ws + (oc * 9 + ty * 3) * CB;
#pragma unroll
          for (int c = 0; c < CC; ++c) racc[c] = fmaf(vr, wp[c], racc[c]);
        }
      }
    }
  }

  // -- the ReLU mask, dx = da * scale, and the tile's partial sums
  const int valid = i < H ? min(kR, W - j0) : 0;
  const T* xn = static_cast<const T*>(a.x) + static_cast<size_t>(n) * C * plane;
  T* dxn = static_cast<T*>(a.dx) + static_cast<size_t>(n) * C * plane;
  float* pr_row = a.part + (static_cast<size_t>(n) * gridDim.x + blockIdx.x) * 2 * C;
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    const int ch = cb0 + CC * grp + c;
    float s1 = 0.f, s2 = 0.f;
    if (ch < C && valid > 0) {
      const size_t off = ch * plane + static_cast<size_t>(i) * W + j0;
      float xv[kR], out[kR];
      load_run<T>(xn + off, xv, valid, a.xvec);
      const float sc = __ldg(a.scale + ch), sh = __ldg(a.shift + ch);
#pragma unroll
      for (int p = 0; p < kR; ++p) {
        float da = acc[p][c];
        if (right && p == pr) da = __fadd_rn(da, racc[c]);
        if (a.relu && !(__fadd_rn(__fmul_rn(xv[p], sc), sh) > 0.f)) da = 0.f;
        out[p] = __fmul_rn(da, sc);
        if (p < valid) {
          s1 = __fadd_rn(s1, __fmul_rn(da, xv[p]));
          s2 = __fadd_rn(s2, da);
        }
      }
      store_run<T>(dxn + off, out, valid, a.xvec);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      s1 = __fadd_rn(s1, __shfl_down_sync(0xffffffffu, s1, d));
      s2 = __fadd_rn(s2, __shfl_down_sync(0xffffffffu, s2, d));
    }
    if (lane == 0 && ch < C) {
      pr_row[ch] = s1;
      pr_row[C + ch] = s2;
    }
  }
}

template <typename T, int CC, int G>
int launch(const DxArgs& a, int tiles_h, float* dsc, float* dsh, cudaStream_t st) {
  constexpr int CB = G * CC;
  const dim3 grid(tiles_h * a.tiles_w, (a.C + CB - 1) / CB, a.N);
  const size_t smem = sizeof(float) * (2 * (kOC * kGC + kOC * 9 * CB) + 32 * G * CC);
  const auto kernel = conv3x3_dx_f32_kernel<T, CC, G>;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem))) {
      return static_cast<int>(e);
    }
  }
  kernel<<<grid, 32 * G, smem, st>>>(a);
  if (int rc = itg::last_error()) return rc;
  itg::sum_partials<<<2 * a.C, itg::kReduceThreads, 0, st>>>(a.part, dsc, dsh, a.N * grid.x,
                                                              a.C);
  return itg::last_error();
}

template <typename T, int CC>
int by_groups(int g, const DxArgs& a, int tiles_h, float* dsc, float* dsh, cudaStream_t st) {
  switch (g) {
    case 1: return launch<T, CC, 1>(a, tiles_h, dsc, dsh, st);
    case 2: return launch<T, CC, 2>(a, tiles_h, dsc, dsh, st);
    case 4: return launch<T, CC, 4>(a, tiles_h, dsc, dsh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int cc, int g, const DxArgs& a, int tiles_h, float* dsc, float* dsh,
             cudaStream_t st) {
  if (cc == 7) return by_groups<T, 7>(g, a, tiles_h, dsc, dsh, st);
  if (cc == 3) return by_groups<T, 3>(g, a, tiles_h, dsc, dsh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (N, C, H, W), g (N, Co, H, W), dx (N, C, H, W): activation type
// (float32, or bfloat16 when bf16 != 0). w (Co, C, 3, 3), scale/shift (C):
// float32. part (N ceil(H / 16) ceil(W / 32), 2C) float32 scratch; dsc/dsh
// (C) float32, written. cc (7 or 3) input channels a thread and blk_groups
// (1, 2 or 4) groups a block: ops/kernels.py conv3x3_dx_f32_plan (any pair gives the
// same bits). N <= 65535, H W < 2^31. Two launches (dx, the sums); returns
// the first CUDA error (cudaErrorInvalidValue for a shape or plan it does
// not take).
extern "C" int itg_conv3x3_chw_dx(const void* x, const void* g, const void* w, const void* scale,
                                  const void* shift, void* dx, void* part, void* dsc, void* dsh,
                                  int n, int c, int h, int width, int co, int relu, int zeros,
                                  int bf16, int cc, int blk_groups, void* stream) {
  if (n < 1 || n > 65535 || c < 1 || h < 1 || width < 1 || co < 1 ||
      static_cast<long long>(h) * width > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_px = bf16 ? 8 : 4;
  const bool aligned_g = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool aligned_x = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                         (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  const DxArgs a{x, g, static_cast<const float*>(w), static_cast<const float*>(scale),
                 static_cast<const float*>(shift), dx, static_cast<float*>(part), n, c, h, width,
                 co, relu, zeros, (width + kTW - 1) / kTW, !bf16 && aligned_g && width % 4 == 0,
                 aligned_x && width % vec_px == 0};
  const int tiles_h = (h + kTH - 1) / kTH;
  auto* a1 = static_cast<float*>(dsc);
  auto* a2 = static_cast<float*>(dsh);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(cc, blk_groups, a, tiles_h, a1, a2, st);
  return dispatch<float>(cc, blk_groups, a, tiles_h, a1, a2, st);
}
