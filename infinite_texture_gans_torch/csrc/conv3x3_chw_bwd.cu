// Backward of the fused BN-fold -> ReLU -> border -> 3x3 convolution of
// conv3x3_chw.cu, on channels-major (N, C, H, W) activations.
//
// Replaces three TPU kernels of infinite_texture_gans_tpu/ops/pallas_conv.py:
//   K6 _conv3x3_chw_dx (:775, kernel _dx_kernel :644): da = conv3x3^T(g) on
//      the padded grid, with the gradient that lands on the padded border
//      folded back onto the edge rows and columns (replicate; a corner takes
//      it twice) or dropped (zeros); da is masked by the ReLU of
//      scale * x + shift (recomputed, not stored); dx = da * scale,
//      d(scale) = sum da * x and d(shift) = sum da over (N, H, W).
//   K7 _conv3x3_chw_dw (:888, kernel _dw_kernel :807): dW[o, c, ky, kx] =
//      sum g[o] * A[c] at the tap's offset, where A is the padded post-norm
//      input the forward read (recomputed from x), and db[o] = sum g[o].
//   K8 _bn_corr (:1061, kernel _bn_corr_kernel :1039): g + (alpha[c] +
//      beta2[c] * y), the cotangents of a producer's BN statistics folded
//      into the gradient of its output.
//
// What bounds them on the H100: K6 and K7 do the forward's 2 * 9 * C * Co
// FLOPs per pixel (operations on the tensor cores at the dense bound, as
// the forward); K8 reads two arrays and writes one (bytes). These first
// kernels run on the CUDA cores in float32, so K6/K7 are bound by FMA throughput
// and shared-memory traffic, far above the tensor-core bound.
// What the designs do about it:
//   K6 is the forward's scheme turned around: a block computes a 32 x 8
//      tile of da for up to 16 input channels; each chunk of 8 output
//      channels of g is staged with a one-pixel halo (zero outside the
//      image) beside its weights, every thread keeps its channels in
//      registers, and the threads on an image edge add the folded border
//      terms, whose g values lie in the same staged halo. The per-channel
//      sums are reduced in the block and added with one atomicAdd per block
//      and channel.
//   K7 gives each thread one (o, c) pair and its 9 taps in registers: a
//      block stages the post-norm input of 32 channels over an 8 x 16 tile
//      with its halo (odd plane stride: the 32 threads of a warp, one per
//      channel, hit distinct banks) and g of 8 output channels, slides a
//      3 x 3 register window along each row (3 shared loads for 9 FMAs),
//      walks many tiles, and adds its 9 sums to the zeroed dW once.
//   K8 is one thread per element on a (pixels, planes) grid, 32-bit index
//      arithmetic, the per-channel values read once per thread.
// The TPU kernels' packed partial-matmul weights, row stacks and lane
// padding (the masked pad columns) have no counterpart here.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// K6: dx, d(scale), d(shift)

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kChunk = 8;  // output channels of g staged per pass

template <typename T, int TC>
__global__ void __launch_bounds__(kThreads)
conv3x3_dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  T* __restrict__ dx, float* __restrict__ dsc, float* __restrict__ dsh, int C,
                  int H, int W, int Co, int relu, int zeros) {
  __shared__ float s_g[kChunk][kTileH + 2][kTileW + 2];
  __shared__ __align__(16) float s_w[kChunk][9][TC];
  __shared__ float s_red[kThreads / 32][2 * TC];

  const int n = blockIdx.z;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int c0 = blockIdx.y * TC;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int i = ty0 + ty;
  const int j = tx0 + tx;
  const bool inside = i < H && j < W;
  // replicate padding: the padded rows/columns this pixel feeds besides
  // its own (i + 1, j + 1); -1 for none
  const int rx = (!zeros && inside && i == 0) ? 0 : -1;
  const int ry = (!zeros && inside && i == H - 1) ? H + 1 : -1;
  const int sx = (!zeros && inside && j == 0) ? 0 : -1;
  const int sy = (!zeros && inside && j == W - 1) ? W + 1 : -1;
  const bool edge = rx >= 0 || ry >= 0 || sx >= 0 || sy >= 0;

  float acc[TC];
#pragma unroll
  for (int k = 0; k < TC; ++k) acc[k] = 0.f;

  const T* gn = g + static_cast<size_t>(n) * Co * H * W;
  constexpr int kTile = (kTileH + 2) * (kTileW + 2);
  for (int o0 = 0; o0 < Co; o0 += kChunk) {
    for (int idx = tid; idx < kChunk * kTile; idx += kThreads) {
      const int oc = idx / kTile;
      const int r = (idx % kTile) / (kTileW + 2);
      const int s = (idx % kTile) % (kTileW + 2);
      const int o = o0 + oc;
      const int gi = ty0 + r - 1;
      const int gj = tx0 + s - 1;
      const bool ok = o < Co && gi >= 0 && gi < H && gj >= 0 && gj < W;
      s_g[oc][r][s] = ok ? to_f32<T>(gn[(static_cast<size_t>(o) * H + gi) * W + gj]) : 0.f;
    }
    for (int idx = tid; idx < kChunk * 9 * TC; idx += kThreads) {
      const int oc = idx / (9 * TC);
      const int tap = (idx / TC) % 9;
      const int k = idx % TC;
      const int o = o0 + oc;
      const int c = c0 + k;
      s_w[oc][tap][k] = (o < Co && c < C) ? w[(static_cast<size_t>(o) * C + c) * 9 + tap] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int oc = 0; oc < kChunk; ++oc) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // dP[i + 1, j + 1] takes g[i + 1 - ky, j + 1 - kx] through tap (ky, kx)
        const float v = s_g[oc][ty + 2 - tap / 3][tx + 2 - tap % 3];
#pragma unroll
        for (int k = 0; k < TC; k += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(&s_w[oc][tap][k]);
          acc[k] = fmaf(v, wv.x, acc[k]);
          acc[k + 1] = fmaf(v, wv.y, acc[k + 1]);
          acc[k + 2] = fmaf(v, wv.z, acc[k + 2]);
          acc[k + 3] = fmaf(v, wv.w, acc[k + 3]);
        }
      }
    }
    if (edge) {
      // the border folds: every padded cell (r, s) that replicates (i, j),
      // other than (i + 1, j + 1), adds its dP[r, s]
      const int rows[3] = {i + 1, rx, ry};
      const int cols[3] = {j + 1, sx, sy};
      for (int a = 0; a < 3; ++a) {
        for (int b = 0; b < 3; ++b) {
          const int r = rows[a];
          const int s = cols[b];
          if (r < 0 || s < 0 || (a == 0 && b == 0)) continue;
          for (int oc = 0; oc < kChunk; ++oc) {
            for (int tap = 0; tap < 9; ++tap) {
              const int gi = r - tap / 3;
              const int gj = s - tap % 3;
              if (gi < 0 || gi >= H || gj < 0 || gj >= W) continue;
              const float v = s_g[oc][gi - ty0 + 1][gj - tx0 + 1];
#pragma unroll
              for (int k = 0; k < TC; ++k) acc[k] = fmaf(v, s_w[oc][tap][k], acc[k]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  float v[2 * TC];
#pragma unroll
  for (int k = 0; k < TC; ++k) {
    const int c = c0 + k;
    float da = 0.f;
    float xv = 0.f;
    if (inside && c < C) {
      const size_t off = ((static_cast<size_t>(n) * C + c) * H + i) * W + j;
      xv = to_f32<T>(x[off]);
      const float sc = scale[c];
      da = acc[k];
      if (relu && !(__fadd_rn(__fmul_rn(xv, sc), shift[c]) > 0.f)) da = 0.f;
      dx[off] = from_f32<T>(da * sc);
    }
    v[k] = da * xv;
    v[TC + k] = da;
  }
  itg::block_sum2_atomic<TC>(v, &s_red[0][0], dsc + c0, dsh + c0, min(TC, C - c0));
}

template <typename T, int TC>
int launch_dx(const void* x, const void* g, const float* w, const float* scale,
              const float* shift, void* dx, float* dsc, float* dsh, int n, int c, int h,
              int width, int co, int relu, int zeros, cudaStream_t stream) {
  const int tiles = ((width + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(tiles, (c + TC - 1) / TC, n);
  const dim3 block(kTileW, kTileH);
  conv3x3_dx_kernel<T, TC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w, scale, shift, static_cast<T*>(dx),
      dsc, dsh, c, h, width, co, relu, zeros);
  return itg::last_error();
}

template <typename T>
int dispatch_dx(const void* x, const void* g, const float* w, const float* scale,
                const float* shift, void* dx, float* dsc, float* dsh, int n, int c, int h,
                int width, int co, int relu, int zeros, cudaStream_t stream) {
  if (c <= 4) return launch_dx<T, 4>(x, g, w, scale, shift, dx, dsc, dsh, n, c, h, width, co, relu, zeros, stream);
  if (c <= 8) return launch_dx<T, 8>(x, g, w, scale, shift, dx, dsc, dsh, n, c, h, width, co, relu, zeros, stream);
  return launch_dx<T, 16>(x, g, w, scale, shift, dx, dsc, dsh, n, c, h, width, co, relu, zeros, stream);
}

// ---------------------------------------------------------------------------
// K7: dW, db

constexpr int kDwTH = 8;
constexpr int kDwTW = 16;
constexpr int kDwTO = 8;   // output channels per block
constexpr int kDwTC = 32;  // input channels per block (one per lane)
constexpr int kDwRow = kDwTW + 2;
constexpr int kDwPlane = (kDwTH + 2) * kDwRow + 1;  // odd: conflict-free lanes

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  float* __restrict__ dw, float* __restrict__ db, int N, int C, int H, int W,
                  int Co, int relu, int zeros) {
  __shared__ float s_a[kDwTC * kDwPlane];
  __shared__ float s_g[kDwTO][kDwTH][kDwTW];

  const int tid = threadIdx.x;
  const int oo = tid / kDwTC;
  const int cc = tid % kDwTC;
  const int c_groups = (C + kDwTC - 1) / kDwTC;
  const int o0 = (blockIdx.y / c_groups) * kDwTO;
  const int c0 = (blockIdx.y % c_groups) * kDwTC;
  const int o = o0 + oo;
  const int c = c0 + cc;
  const bool mine = o < Co && c < C;
  const bool sums_db = c0 == 0 && cc == 0 && o < Co;
  const int tiles_w = (W + kDwTW - 1) / kDwTW;
  const int tiles_img = tiles_w * ((H + kDwTH - 1) / kDwTH);

  float acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) acc[t] = 0.f;
  float dbacc = 0.f;

  for (int t = blockIdx.x; t < N * tiles_img; t += gridDim.x) {
    const int n = t / tiles_img;
    const int ty0 = ((t % tiles_img) / tiles_w) * kDwTH;
    const int tx0 = ((t % tiles_img) % tiles_w) * kDwTW;
    constexpr int kCells = (kDwTH + 2) * kDwRow;
    for (int idx = tid; idx < kDwTC * kCells; idx += kThreads) {
      const int ch = idx / kCells;
      const int r = (idx % kCells) / kDwRow;
      const int s = (idx % kCells) % kDwRow;
      const int cg = c0 + ch;
      int gi = ty0 + r - 1;
      int gj = tx0 + s - 1;
      float a = 0.f;
      if (cg < C) {
        if (zeros) {
          if (gi >= 0 && gi < H && gj >= 0 && gj < W) {
            a = itg::prenorm<T>(to_f32<T>(x[((static_cast<size_t>(n) * C + cg) * H + gi) * W + gj]),
                                scale[cg], shift[cg], relu);
          }
        } else {  // replicate; cells past the bottom/right edge feed only g = 0
          gi = min(max(gi, 0), H - 1);
          gj = min(max(gj, 0), W - 1);
          a = itg::prenorm<T>(to_f32<T>(x[((static_cast<size_t>(n) * C + cg) * H + gi) * W + gj]),
                              scale[cg], shift[cg], relu);
        }
      }
      s_a[ch * kDwPlane + r * kDwRow + s] = a;
    }
    for (int idx = tid; idx < kDwTO * kDwTH * kDwTW; idx += kThreads) {
      const int oc = idx / (kDwTH * kDwTW);
      const int r = (idx / kDwTW) % kDwTH;
      const int s = idx % kDwTW;
      const int og = o0 + oc;
      const int gi = ty0 + r;
      const int gj = tx0 + s;
      s_g[oc][r][s] = (og < Co && gi < H && gj < W)
                          ? to_f32<T>(g[((static_cast<size_t>(n) * Co + og) * H + gi) * W + gj])
                          : 0.f;
    }
    __syncthreads();
    if (mine) {
      const float* ap = s_a + cc * kDwPlane;
#pragma unroll 1
      for (int r = 0; r < kDwTH; ++r) {
        float win[3][3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) win[ky][kx] = ap[(r + ky) * kDwRow + kx];
        }
#pragma unroll
        for (int jj = 0; jj < kDwTW; ++jj) {
          const float gv = s_g[oo][r][jj];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) acc[ky * 3 + kx] = fmaf(gv, win[ky][kx], acc[ky * 3 + kx]);
          }
          if (jj + 3 < kDwRow) {
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              win[ky][0] = win[ky][1];
              win[ky][1] = win[ky][2];
              win[ky][2] = ap[(r + ky) * kDwRow + jj + 3];
            }
          }
        }
      }
    }
    if (sums_db) {
      for (int r = 0; r < kDwTH; ++r) {
        for (int jj = 0; jj < kDwTW; ++jj) dbacc += s_g[oo][r][jj];
      }
    }
    __syncthreads();
  }
  if (mine) {
#pragma unroll
    for (int t = 0; t < 9; ++t) atomicAdd(dw + (static_cast<size_t>(o) * C + c) * 9 + t, acc[t]);
  }
  if (sums_db) atomicAdd(db + o, dbacc);
}

template <typename T>
int launch_dw(const void* x, const void* g, const float* scale, const float* shift, float* dw,
              float* db, int n, int c, int h, int width, int co, int relu, int zeros,
              cudaStream_t stream) {
  const int groups = ((co + kDwTO - 1) / kDwTO) * ((c + kDwTC - 1) / kDwTC);
  const long long tiles = static_cast<long long>(n) * ((width + kDwTW - 1) / kDwTW) *
                          ((h + kDwTH - 1) / kDwTH);
  const long long want = (8LL * 132 + groups - 1) / groups;
  const dim3 grid(static_cast<unsigned>(tiles < want ? tiles : want), groups);
  conv3x3_dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), scale, shift, dw, db, n, c, h, width,
      co, relu, zeros);
  return itg::last_error();
}

// ---------------------------------------------------------------------------
// K8: g + (alpha + beta2 * y)

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_corr_kernel(const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ alpha,
               const float* __restrict__ beta2, T* __restrict__ out, int planes, int C, int HW) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int c = plane % C;
    const size_t off = static_cast<size_t>(plane) * HW + p;
    const float corr = __fadd_rn(alpha[c], __fmul_rn(beta2[c], to_f32<T>(y[off])));
    out[off] = from_f32<T>(__fadd_rn(to_f32<T>(g[off]), corr));
  }
}

template <typename T>
int launch_corr(const void* g, const void* y, const float* alpha, const float* beta2, void* out,
                int planes, int c, int hw, cudaStream_t stream) {
  const dim3 grid((hw + kThreads - 1) / kThreads, planes < 65535 ? planes : 65535);
  bn_corr_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), alpha, beta2, static_cast<T*>(out),
      planes, c, hw);
  return itg::last_error();
}

}  // namespace

// x (N, C, H, W), g (N, Co, H, W), dx (N, C, H, W): activation type
// (float32, or bfloat16 when bf16 != 0). w (Co, C, 3, 3), scale/shift (C):
// float32. dsc/dsh (C) float32, zeroed by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int itg_conv3x3_chw_dx(const void* x, const void* g, const void* w, const void* scale,
                                  const void* shift, void* dx, void* dsc, void* dsh, int n, int c,
                                  int h, int width, int co, int relu, int zeros, int bf16,
                                  void* stream) {
  const auto* wf = static_cast<const float*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* a = static_cast<float*>(dsc);
  auto* b = static_cast<float*>(dsh);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch_dx<__nv_bfloat16>(x, g, wf, sc, sh, dx, a, b, n, c, h, width, co, relu, zeros, st);
  return dispatch_dx<float>(x, g, wf, sc, sh, dx, a, b, n, c, h, width, co, relu, zeros, st);
}

// x (N, C, H, W), g (N, Co, H, W): activation type. scale/shift (C):
// float32. dw (Co, C, 3, 3) and db (Co): float32, zeroed by the caller; the
// kernel adds into them. Returns cudaGetLastError() after the launch.
extern "C" int itg_conv3x3_chw_dw(const void* x, const void* g, const void* scale,
                                  const void* shift, void* dw, void* db, int n, int c, int h,
                                  int width, int co, int relu, int zeros, int bf16, void* stream) {
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* w = static_cast<float*>(dw);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_dw<__nv_bfloat16>(x, g, sc, sh, w, b, n, c, h, width, co, relu, zeros, st);
  return launch_dw<float>(x, g, sc, sh, w, b, n, c, h, width, co, relu, zeros, st);
}

// g, y, out (planes = N * C, HW): activation type; alpha/beta2 (C) float32.
// out = g + (alpha[c] + beta2[c] * y), in float32, stored in the activation
// type. Returns cudaGetLastError() after the launch.
extern "C" int itg_bn_corr(const void* g, const void* y, const void* alpha, const void* beta2,
                           void* out, int planes, int c, int hw, int bf16, void* stream) {
  const auto* a = static_cast<const float*>(alpha);
  const auto* b = static_cast<const float*>(beta2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_corr<__nv_bfloat16>(g, y, a, b, out, planes, c, hw, st);
  return launch_corr<float>(g, y, a, b, out, planes, c, hw, st);
}
