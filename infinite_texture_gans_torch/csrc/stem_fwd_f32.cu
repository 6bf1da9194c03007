// The discriminator stem's forward (K13) on the CUDA cores: the float32
// route (bf16 runs on the tensor cores in stem_fwd_tc.cu; this entry point
// takes bf16 too). The stem's dW is stem_dw_f32.cu, its dx stem_dx_f32.cu.
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:2769 _stem_fwd_call
// (kernel _stem_kernel :2683), reached through conv4x4s2_stem_chw (:3086):
//   y[n, i, j, o] = b[o] + sum_{c, ky, kx} w[o, c, ky, kx] *
//                   x[n, c, 2i + ky - 1, 2j + kx - 1]
// (zero outside the image) from a channels-major (N, C, H, W) image, C <= 4,
// to NHWC y (N, H/2, W/2, Co).
//
// What bounds it on the H100: 2 * 16 * C * Co FLOPs per output pixel
// against 4 (4 C + Co) bytes in float32. At the Experiment-1 stem (8 x 3 x
// 384^2 -> 64 channels) a call is 1.81 GFLOP (0.027 ms of FFMA at 67
// TFLOP/s) against 90 MB, mostly the output (0.027 ms at 3.35 TB/s): both
// bounds sit together. What the design does about it:
// - A tile is 8 output rows x 32 output columns x 64 output channels of
//   one image. Its 18 input rows are staged once (zeros outside the image,
//   2 x 32 + 4 floats a row, so a row's windows read as float4). A block
//   stays on the card (three an SM; the planner in ops/kernels.py,
//   stem_f32_plan, sizes the grid) and walks tiles of one channel chunk,
//   whose weights and biases it stages once; while it computes one tile,
//   cp.async copies the next tile's rows into a second buffer, so the
//   copies' latency hides behind the FMAs.
// - Register tiles: a thread owns 4 consecutive output pixels of a row x 8
//   output channels (two quads, 4 oct and 32 + 4 oct of the block's 64). Per
//   input channel and row tap it reads its 10 input values (two 16-byte and
//   one 8-byte load, a broadcast to the 8 threads of its pixel group), and
//   per column tap two float4 weight vectors (the 8 channel octets of a
//   warp read 128 contiguous bytes), for 32 FMAs: each x value feeds 8
//   channels, each weight vector 4 pixels.
// - 256 threads: 4 row lanes x 8 pixel groups x 8 channel octets; a row lane
//   walks the block's rows 4 apart.
// - NHWC stores are 16-byte vectors along the channels (8 bytes in bf16):
//   the 8 octets of a pixel write 128 contiguous bytes.
// - Each output sums (c, ky, kx) in one fixed order from zero and adds the
//   bias last: two calls give the same bits.
#include "common.cuh"
#include "mma.cuh"  // smem_addr, cp.async groups

namespace {

using itg::cp_async4;
using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;     // blocks an SM holds: at most 85 registers a thread
constexpr int kRows = 8;          // output rows of a tile: 4 row lanes, 2 rows each
constexpr int kTJ = 32;           // output columns of a tile: 8 pixel groups of 4
constexpr int kTO = 64;           // output channels of a block
constexpr int kPX = 4;            // output pixels of a thread
constexpr int kXC = 2 * kTJ + 4;  // staged input columns 2 j0 - 1 .. 2 j0 + 66
constexpr int kXR = 2 * kRows + 2;  // staged input rows 2 i0 - 1 .. 2 i0 + 16

// Four channels of one pixel, 16 bytes (float32) or 8 (bf16) where vec and
// all four exist, else element by element.
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4], int valid, bool vec) {
  if (vec && valid >= 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(itg::pack_bf16x2(v[0], v[1]),
                                                itg::pack_bf16x2(v[2], v[3]));
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < valid) p[e] = from_f32<T>(v[e]);
  }
}

// Grid (blocks, ceil(Co / 64)): block (bx, chunk) takes the tiles bx, bx +
// gridDim.x, ... of N x row bands x column tiles. Dynamic shared memory
// (floats): weights [16 C][kTO], biases [kTO], two input buffers [C][kXR][kXC].
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stem_fwd_f32_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y, int N, int H, int W,
                    int Co) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;
  float* s_b = s_w + 16 * C * kTO;
  float* s_buf = s_b + kTO;
  const int H2 = H / 2, W2 = W / 2;
  const int jtiles = (W2 + kTJ - 1) / kTJ;
  const int per_image = ((H2 + kRows - 1) / kRows) * jtiles;
  const int tiles = N * per_image;
  const int co0 = blockIdx.y * kTO;
  const int tid = threadIdx.x;
  constexpr int xr = kXR;
  constexpr int xsize = C * kXR * kXC;

#pragma unroll 4
  for (int i = tid; i < 16 * C * kTO; i += kThreads) {
    const int oc = i % kTO, k = i / kTO;  // k = 16 c + 4 ky + kx
    s_w[i] = co0 + oc < Co ? w[static_cast<size_t>(co0 + oc) * 16 * C + k] : 0.f;
  }
  for (int i = tid; i < kTO; i += kThreads) s_b[i] = co0 + i < Co ? bias[co0 + i] : 0.f;
  __syncthreads();  // the weights and biases are in

  // tile t's input rows into s_x: cp.async copies (float32), else element
  // loads (bf16)
  auto stage = [&](int t, float* s_x) {
    const int n = t / per_image, i0 = (t % per_image) / jtiles * kRows;
    const int j0 = (t % jtiles) * kTJ;
    const T* xn = x + static_cast<size_t>(n) * C * H * W;
#pragma unroll 4
    for (int i = tid; i < xsize; i += kThreads) {
      const int s = i % kXC, r = (i / kXC) % xr, c = i / (kXC * xr);
      const int gr = 2 * i0 - 1 + r, gc = 2 * j0 - 1 + s;
      const bool ok = gr >= 0 && gr < H && gc >= 0 && gc < W;
      const T* src = xn + (static_cast<size_t>(c) * H + (ok ? gr : 0)) * W + (ok ? gc : 0);
      if constexpr (sizeof(T) == 4) {
        cp_async4(s_x + i, src, ok);
      } else {
        s_x[i] = ok ? to_f32<T>(*src) : 0.f;
      }
    }
  };

  const int oct = tid & 7, pg = (tid >> 3) & 7, rl = tid >> 6;
  const int oa = 4 * oct, ob = 32 + 4 * oct;
  const bool vec = Co % 4 == 0;
  float bq[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bq[e] = s_b[oa + e];
    bq[4 + e] = s_b[ob + e];
  }
  int t = blockIdx.x;
  if (t < tiles) stage(t, s_buf);
  itg::cp_async_commit();
  for (int k = 0; t < tiles; ++k, t += gridDim.x) {
    itg::cp_async_wait_all();
    __syncthreads();  // tile t's rows are in; every thread is done with the other buffer
    if (t + static_cast<int>(gridDim.x) < tiles) {
      stage(t + gridDim.x, s_buf + ((k + 1) & 1) * xsize);
    }
    itg::cp_async_commit();
    const float* s_x = s_buf + (k & 1) * xsize;
    const int n = t / per_image, i0 = (t % per_image) / jtiles * kRows;
    const int j0 = (t % jtiles) * kTJ;
    const int ja = j0 + kPX * pg;  // this thread's first output column
    for (int ib = rl; ib < kRows; ib += 4) {
      const int i = i0 + ib;
      if (i >= H2) break;
      float acc[kPX][8];
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;
      }
      // one (c, ky) row of taps an iteration: its loads stay next to its FMAs
#pragma unroll 1
      for (int ct = 0; ct < 4 * C; ++ct) {
        const int c = ct >> 2, ky = ct & 3;
        // output pixel j reads staged columns 2 (j - j0) + kx
        const float* xrow = s_x + (c * xr + 2 * ib + ky) * kXC + 2 * kPX * pg;
        const float4 x0 = *reinterpret_cast<const float4*>(xrow);
        const float4 x1 = *reinterpret_cast<const float4*>(xrow + 4);
        const float2 x2 = *reinterpret_cast<const float2*>(xrow + 8);
        const float xv[10] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w, x2.x, x2.y};
#pragma unroll
        for (int kx = 0; kx < 4; ++kx) {
          const float* wp = s_w + (4 * ct + kx) * kTO;
          const float4 wa = *reinterpret_cast<const float4*>(wp + oa);
          const float4 wb = *reinterpret_cast<const float4*>(wp + ob);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int p = 0; p < kPX; ++p) {
            const float v = xv[2 * p + kx];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[p][e] = fmaf(wv[e], v, acc[p][e]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kPX; ++p) {
        const int j = ja + p;
        if (j >= W2) break;
        T* yp = y + ((static_cast<size_t>(n) * H2 + i) * W2 + j) * Co + co0;
        const float va[4] = {acc[p][0] + bq[0], acc[p][1] + bq[1], acc[p][2] + bq[2],
                             acc[p][3] + bq[3]};
        const float vb[4] = {acc[p][4] + bq[4], acc[p][5] + bq[5], acc[p][6] + bq[6],
                             acc[p][7] + bq[7]};
        store4(yp + oa, va, Co - co0 - oa, vec);
        store4(yp + ob, vb, Co - co0 - ob, vec);
      }
    }
  }
}

template <typename T, int C>
int launch(const void* x, const void* w, const void* b, void* y, int n, int h, int width, int co,
           int blocks, cudaStream_t stream) {
  const dim3 grid(blocks, (co + kTO - 1) / kTO);
  const size_t smem = sizeof(float) * (16 * C * kTO + kTO + 2 * C * kXR * kXC);
  auto kernel = stem_fwd_f32_kernel<T, C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const float*>(w),
                                           static_cast<const float*>(b), static_cast<T*>(y), n,
                                           h, width, co);
  return itg::last_error();
}

template <typename T>
int dispatch(int c, const void* x, const void* w, const void* b, void* y, int n, int h,
             int width, int co, int blocks, cudaStream_t stream) {
  switch (c) {
    case 1: return launch<T, 1>(x, w, b, y, n, h, width, co, blocks, stream);
    case 2: return launch<T, 2>(x, w, b, y, n, h, width, co, blocks, stream);
    case 3: return launch<T, 3>(x, w, b, y, n, h, width, co, blocks, stream);
    case 4: return launch<T, 4>(x, w, b, y, n, h, width, co, blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (N, C, H, W) activation type (float32, or bfloat16 when bf16 != 0),
// 1 <= C <= 4, H and W even; w (Co, C, 4, 4) and b (Co) float32; y (N, H/2,
// W/2, Co) activation type. blocks: the grid's first axis, the blocks that
// walk each chunk of 64 output channels' tiles (ops/kernels.py:
// stem_f32_plan; any count from 1 gives the same bits). Returns
// cudaGetLastError() after the launch.
extern "C" int itg_stem_fwd(const void* x, const void* w, const void* b, void* y, int n, int c,
                            int h, int width, int co, int bf16, int blocks, void* stream) {
  if (h % 2 || width % 2 || n < 1 || h < 2 || width < 2 || co < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(c, x, w, b, y, n, h, width, co, blocks, st);
  return dispatch<float>(c, x, w, b, y, n, h, width, co, blocks, st);
}
