// The subpixel-fused up-conv of the generator's tail, forward and backward,
// on channels-major activations: x (N, C, H, W) at HALF resolution, y (N, Co,
// 2H, 2W).
//
// Replaces four TPU kernels of infinite_texture_gans_tpu/ops/pallas_conv.py
// (K9, upconv3x3_chw_p :1804; K14, chw_upconv_halo_step :2032):
//   forward _upconv3x3_fwd (:1457, kernel _upconv_kernel :1366):
//      y = conv3x3(pad1(up2(act(scale * x + shift)))) + b, with the optional
//      float32 per-channel sums of the STORED y and y^2 (as K5);
//   K14 _upconv3x3_fwd_halo (:2019, kernel _upconv_halo_kernel :1879): the
//      same forward inside the raster engine (--fuse_up all at eval), whose
//      half-res top row (C, W + 2, corners included) and left column (C, H)
//      come post-norm from the halo cache. The full-res halo row of the
//      unfused site is the half-res one doubled, so the border is assembled
//      on the half-res slab exactly as K2 assembles it (conv3x3_fwd_f32.cu). One
//      kernel body serves K9 and K14: every output sums its (channel, phase
//      tap) products in one order wherever its tile lies, so the raster
//      gives the one pass's bits;
//   dW _upconv3x3_dw (:1777, kernel _updw_kernel :1673): dW and db.
// (K9 dx, _upconv3x3_dx :1642, is upconv_dx_f32.cu on the CUDA cores and
// chw_dx_tc.cu on the tensor cores.)
// Nearest-2x commutes with the per-channel affine and the ReLU, and a
// replicate (or zeros) pad of the full-resolution upsample equals a
// replicate (or zeros) pad of the half-resolution normed slab A. So each
// output phase (di, dj) of y[2i + di, 2j + dj] is a 2 x 2 convolution of A
// at rows i - 1 + di + r, columns j - 1 + dj + s (r, s in {0, 1}), whose
// combined kernels fold the 3 x 3 taps (row taps {K0 | K1 + K2} for di = 0,
// {K0 + K1 | K2} for di = 1; the same on columns). The wrapper builds them in
// float32 from w (ops/kernels.py: _upconv_phase_weights); dW is returned
// per phase tap and folded back to 3 x 3 by the wrapper
// (_upconv_unpack_dw). The phase form does 4/9 of the unfused upsample +
// conv's multiply-adds and never stores the 4x upsampled activation.
//
// What bounds them on the H100: at the Experiment-1 shapes (52 -> 26 at a
// 96^2 half resolution, 26 -> 13 at 192^2, N = 8) and the flagship's eval
// shapes (104 -> 52 at 48^2 ... 26 -> 13 at 192^2, N = 1) the work is
// 2 * 16 * C * Co FLOPs per half-res pixel against 2 * (C + 4 Co) bytes in
// bf16, so the dense bound of the bf16 routes (tensor cores) is bytes. These
// kernels are the float32 routes (and run bf16 when a caller asks): at 67
// TFLOP/s of FFMA and 4 * (C + 4 Co) bytes the bound is FMA issue (about
// 0.048 ms against the forward's 0.014 ms of bytes at the first
// Experiment-1 shape).
// What the designs do about it:
//   forward (K9 and K14): K1's scheme at half resolution. A block normalises
//      a 32 x 8 half-res tile of 8 input channels, with its one-pixel border
//      (K14: the cached cells where given), into shared memory; each thread
//      reads its 3 x 3 window once and feeds all
//      four phases of up to 16 output channels (16 * TCO FMAs per staged
//      window) from float4 weight broadcasts; it writes its 2 x 2 output
//      block and, with stats, adds the block's sums with one atomicAdd per
//      block and channel.
//   dW (the float32 route; bf16 runs on the tensor cores in
//      upconv_dw_tc.cu): K7's scheme with 16 phase taps: one thread owns
//      one (o, c) pair; a block stages the post-norm half-res slab of 32
//      channels over an 8 x 16 tile with its border and g of 8 output
//      channels over the 16 x 32 full-res tile, slides a 3 x 3 window along
//      each half-res row (3 shared loads per 16 FMAs), walks many tiles and
//      adds its sums once.
// The TPU kernels' E-matrix interleaves, row stacks and lane padding have no
// counterpart here.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;
constexpr int kTileW = 32;  // half-res tile of the forward
constexpr int kTileH = 8;

// The half-res input of one image and its border.
template <typename T>
struct Slab {
  const T* x;     // (C, H, W), raw
  const T* top;   // (C, W + 2) post-norm row -1, corners included, or nullptr
  const T* left;  // (C, H) post-norm column -1, or nullptr
  const float* scale;
  const float* shift;
  int C, H, W, relu, zeros;
};

// Post-norm value of the padded half-res slab at row r in [-1, H], column j
// in [-1, W]: K2's border (conv3x3_fwd_f32.cu). Row -1 comes from `top`
// and column -1 from `left` where given; every other border cell is the own
// edge (replicate) or zero. Rows and columns past those (ragged tiles) are
// clamped and only feed outputs that are never stored.
template <typename T>
__device__ __forceinline__ float slab(const Slab<T>& s, int c, int r, int j) {
  r = min(r, s.H);
  j = min(j, s.W);
  if (r < 0 && s.top) return to_f32<T>(s.top[static_cast<size_t>(c) * (s.W + 2) + j + 1]);
  if (s.zeros) {
    if (r < 0 || r >= s.H || j >= s.W) return 0.f;
    if (j < 0) return s.left ? to_f32<T>(s.left[static_cast<size_t>(c) * s.H + r]) : 0.f;
  } else {
    r = min(max(r, 0), s.H - 1);
    if (j < 0 && s.left) return to_f32<T>(s.left[static_cast<size_t>(c) * s.H + r]);
    j = min(max(j, 0), s.W - 1);
  }
  return itg::prenorm<T>(to_f32<T>(s.x[(static_cast<size_t>(c) * s.H + r) * s.W + j]), s.scale[c],
                         s.shift[c], s.relu);
}

// ---------------------------------------------------------------------------
// forward (+ stats)

constexpr int kChunk = 8;  // input channels staged per pass
constexpr int kTile = (kTileH + 2) * (kTileW + 2);

template <typename T, int TCO>
__global__ void __launch_bounds__(kThreads)
upconv_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wc,
                  const float* __restrict__ bias, const float* __restrict__ scale,
                  const float* __restrict__ shift, const T* __restrict__ top,
                  const T* __restrict__ left, T* __restrict__ y, float* __restrict__ s1,
                  float* __restrict__ s2, int C, int H, int W, int Co, int relu, int zeros) {
  __shared__ float s_in[kChunk][kTileH + 2][kTileW + 2];
  __shared__ __align__(16) float s_w[kChunk][16][TCO];
  __shared__ float s_red[kThreads / 32][2 * TCO];

  const int n = blockIdx.z;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * TCO;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const Slab<T> src{x + static_cast<size_t>(n) * C * H * W,
                    top ? top + static_cast<size_t>(n) * C * (W + 2) : nullptr,
                    left ? left + static_cast<size_t>(n) * C * H : nullptr,
                    scale, shift, C, H, W, relu, zeros};

  float acc[4][TCO];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int k = 0; k < TCO; ++k) acc[p][k] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    for (int i = tid; i < kChunk * kTile; i += kThreads) {
      const int cc = i / kTile;
      const int r = (i % kTile) / (kTileW + 2);
      const int j = (i % kTile) % (kTileW + 2);
      const int c = c0 + cc;
      s_in[cc][r][j] = c < C ? slab(src, c, ty0 + r - 1, tx0 + j - 1) : 0.f;
    }
    for (int i = tid; i < kChunk * 16 * TCO; i += kThreads) {
      const int cc = i / (16 * TCO);
      const int tap = (i / TCO) % 16;
      const int k = i % TCO;
      const int c = c0 + cc;
      const int co = co0 + k;
      s_w[cc][tap][k] = (c < C && co < Co) ? wc[(static_cast<size_t>(co) * C + c) * 16 + tap] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int cc = 0; cc < kChunk; ++cc) {
      float v[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) v[a][b] = s_in[cc][ty + a][tx + b];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // phase (di, dj) = (p >> 1, p & 1)
#pragma unroll
        for (int t = 0; t < 4; ++t) {  // slot (r, s) = (t >> 1, t & 1)
          const float a = v[(p >> 1) + (t >> 1)][(p & 1) + (t & 1)];
#pragma unroll
          for (int k = 0; k < TCO; k += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(&s_w[cc][p * 4 + t][k]);
            acc[p][k] = fmaf(a, wv.x, acc[p][k]);
            acc[p][k + 1] = fmaf(a, wv.y, acc[p][k + 1]);
            acc[p][k + 2] = fmaf(a, wv.z, acc[p][k + 2]);
            acc[p][k + 3] = fmaf(a, wv.w, acc[p][k + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int i = ty0 + ty;
  const int j = tx0 + tx;
  const bool inside = i < H && j < W;
  const int W2 = 2 * W;
  float v[2 * TCO];
#pragma unroll
  for (int k = 0; k < TCO; ++k) {
    const int co = co0 + k;
    float sum = 0.f;
    float sq = 0.f;
    if (inside && co < Co) {
      T* yc = y + (static_cast<size_t>(n) * Co + co) * 2 * H * W2;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const T out = from_f32<T>(acc[p][k] + bias[co]);
        yc[static_cast<size_t>(2 * i + (p >> 1)) * W2 + 2 * j + (p & 1)] = out;
        const float f = to_f32<T>(out);
        sum += f;
        sq += f * f;
      }
    }
    v[k] = sum;
    v[TCO + k] = sq;
  }
  if (s1) itg::block_sum2_atomic<TCO>(v, &s_red[0][0], s1 + co0, s2 + co0, min(TCO, Co - co0));
}

template <typename T, int TCO>
int launch_fwd(const void* x, const float* wc, const float* b, const float* scale,
               const float* shift, const void* top, const void* left, void* y, float* s1,
               float* s2, int n, int c, int h, int width, int co, int relu, int zeros,
               cudaStream_t stream) {
  const int tiles = ((width + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(tiles, (co + TCO - 1) / TCO, n);
  const dim3 block(kTileW, kTileH);
  upconv_fwd_kernel<T, TCO><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), wc, b, scale, shift, static_cast<const T*>(top),
      static_cast<const T*>(left), static_cast<T*>(y), s1, s2, c, h, width, co, relu, zeros);
  return itg::last_error();
}

template <typename T>
int dispatch_fwd(const void* x, const float* wc, const float* b, const float* scale,
                 const float* shift, const void* top, const void* left, void* y, float* s1,
                 float* s2, int n, int c, int h, int width, int co, int relu, int zeros,
                 cudaStream_t stream) {
  if (co <= 4) return launch_fwd<T, 4>(x, wc, b, scale, shift, top, left, y, s1, s2, n, c, h, width, co, relu, zeros, stream);
  if (co <= 8) return launch_fwd<T, 8>(x, wc, b, scale, shift, top, left, y, s1, s2, n, c, h, width, co, relu, zeros, stream);
  return launch_fwd<T, 16>(x, wc, b, scale, shift, top, left, y, s1, s2, n, c, h, width, co, relu, zeros, stream);
}

// ---------------------------------------------------------------------------
// dW per phase tap, db

constexpr int kDwTH = 8;   // half-res tile
constexpr int kDwTW = 16;
constexpr int kDwTO = 8;   // output channels per block
constexpr int kDwTC = 32;  // input channels per block (one per lane)
constexpr int kDwRow = kDwTW + 2;
constexpr int kDwPlane = (kDwTH + 2) * kDwRow + 1;  // odd: conflict-free lanes

template <typename T>
__global__ void __launch_bounds__(kThreads)
upconv_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ scale, const float* __restrict__ shift,
                 float* __restrict__ dwc, float* __restrict__ db, int N, int C, int H, int W,
                 int Co, int relu, int zeros) {
  __shared__ float s_a[kDwTC * kDwPlane];
  __shared__ float s_g[kDwTO][2 * kDwTH][2 * kDwTW];

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
  const int H2 = 2 * H;
  const int W2 = 2 * W;

  float acc[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) acc[t] = 0.f;
  float dbacc = 0.f;

  for (int t = blockIdx.x; t < N * tiles_img; t += gridDim.x) {
    const int n = t / tiles_img;
    const int ty0 = ((t % tiles_img) / tiles_w) * kDwTH;
    const int tx0 = ((t % tiles_img) % tiles_w) * kDwTW;
    const Slab<T> src{x + static_cast<size_t>(n) * C * H * W, nullptr, nullptr, scale, shift,
                      C, H, W, relu, zeros};
    constexpr int kCells = (kDwTH + 2) * kDwRow;
    for (int idx = tid; idx < kDwTC * kCells; idx += kThreads) {
      const int ch = idx / kCells;
      const int r = (idx % kCells) / kDwRow;
      const int s = (idx % kCells) % kDwRow;
      const int cg = c0 + ch;
      s_a[ch * kDwPlane + r * kDwRow + s] = cg < C ? slab(src, cg, ty0 + r - 1, tx0 + s - 1) : 0.f;
    }
    for (int idx = tid; idx < kDwTO * 4 * kDwTH * kDwTW; idx += kThreads) {
      const int oc = idx / (4 * kDwTH * kDwTW);
      const int r = (idx / (2 * kDwTW)) % (2 * kDwTH);
      const int s = idx % (2 * kDwTW);
      const int og = o0 + oc;
      const int gi = 2 * ty0 + r;
      const int gj = 2 * tx0 + s;
      s_g[oc][r][s] = (og < Co && gi < H2 && gj < W2)
                          ? to_f32<T>(g[((static_cast<size_t>(n) * Co + og) * H2 + gi) * W2 + gj])
                          : 0.f;
    }
    __syncthreads();
    if (mine) {
      const float* ap = s_a + cc * kDwPlane;
#pragma unroll 1
      for (int r = 0; r < kDwTH; ++r) {
        // staged slab row r + q is half-res row ty0 + r - 1 + q
        float win[3][3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int e = 0; e < 3; ++e) win[q][e] = ap[(r + q) * kDwRow + e];
        }
#pragma unroll
        for (int jj = 0; jj < kDwTW; ++jj) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {  // phase (di, dj)
            const float gv = s_g[oo][2 * r + (p >> 1)][2 * jj + (p & 1)];
#pragma unroll
            for (int tp = 0; tp < 4; ++tp) {  // slot (r, s)
              acc[p * 4 + tp] =
                  fmaf(gv, win[(p >> 1) + (tp >> 1)][(p & 1) + (tp & 1)], acc[p * 4 + tp]);
            }
          }
          if (jj + 3 < kDwRow) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              win[q][0] = win[q][1];
              win[q][1] = win[q][2];
              win[q][2] = ap[(r + q) * kDwRow + jj + 3];
            }
          }
        }
      }
    }
    if (sums_db) {
      for (int r = 0; r < 2 * kDwTH; ++r) {
        for (int s = 0; s < 2 * kDwTW; ++s) dbacc += s_g[oo][r][s];
      }
    }
    __syncthreads();
  }
  if (mine) {
#pragma unroll
    for (int t = 0; t < 16; ++t) atomicAdd(dwc + (static_cast<size_t>(o) * C + c) * 16 + t, acc[t]);
  }
  if (sums_db) atomicAdd(db + o, dbacc);
}

template <typename T>
int launch_dw(const void* x, const void* g, const float* scale, const float* shift, float* dwc,
              float* db, int n, int c, int h, int width, int co, int relu, int zeros,
              cudaStream_t stream) {
  const int groups = ((co + kDwTO - 1) / kDwTO) * ((c + kDwTC - 1) / kDwTC);
  const long long tiles = static_cast<long long>(n) * ((width + kDwTW - 1) / kDwTW) *
                          ((h + kDwTH - 1) / kDwTH);
  const long long want = (8LL * 132 + groups - 1) / groups;
  const dim3 grid(static_cast<unsigned>(tiles < want ? tiles : want), groups);
  upconv_dw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), scale, shift, dwc, db, n, c, h, width,
      co, relu, zeros);
  return itg::last_error();
}

}  // namespace

// x (N, C, H, W) half-res, y (N, Co, 2H, 2W): activation type (float32, or
// bfloat16 when bf16 != 0). wc (Co, C, 16): the combined phase kernels,
// index ((di * 2 + dj) * 2 + r) * 2 + s; b (Co), scale/shift (C): float32.
// top (N, C, W + 2) and left (N, C, H): the post-norm half-res border from
// the halo cache in the activation type (K14), or null (K9). s1/s2 (Co)
// float32, zeroed by the caller, or null for no stats. Returns
// cudaGetLastError() after the launch.
extern "C" int itg_upconv3x3_chw(const void* x, const void* wc, const void* b, const void* scale,
                                 const void* shift, const void* top, const void* left, void* y,
                                 void* s1, void* s2, int n, int c, int h, int width, int co,
                                 int relu, int zeros, int bf16, void* stream) {
  const auto* w = static_cast<const float*>(wc);
  const auto* bf = static_cast<const float*>(b);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* a = static_cast<float*>(s1);
  auto* q = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return dispatch_fwd<__nv_bfloat16>(x, w, bf, sc, sh, top, left, y, a, q, n, c, h, width, co, relu, zeros, st);
  }
  return dispatch_fwd<float>(x, w, bf, sc, sh, top, left, y, a, q, n, c, h, width, co, relu, zeros, st);
}

// x (N, C, H, W), g (N, Co, 2H, 2W): activation type. scale/shift (C):
// float32. dwc (Co, C, 16), per phase tap as the forward's wc, and db (Co):
// float32, zeroed by the caller; the kernel adds into them. Returns
// cudaGetLastError() after the launch.
extern "C" int itg_upconv3x3_chw_dw(const void* x, const void* g, const void* scale,
                                    const void* shift, void* dwc, void* db, int n, int c, int h,
                                    int width, int co, int relu, int zeros, int bf16,
                                    void* stream) {
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* w = static_cast<float*>(dwc);
  auto* b = static_cast<float*>(db);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_dw<__nv_bfloat16>(x, g, sc, sh, w, b, n, c, h, width, co, relu, zeros, st);
  return launch_dw<float>(x, g, sc, sh, w, b, n, c, h, width, co, relu, zeros, st);
}
