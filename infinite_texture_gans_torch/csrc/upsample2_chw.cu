// Nearest-neighbour 2x upsample on channels-major (N, C, H, W) activations,
// y[n, c, 2i + a, 2j + b] = x[n, c, i, j], and its adjoint.
//
// Replaces K4 infinite_texture_gans_tpu/ops/pallas_conv.py:_up2_fwd_call
// (:2540, kernel _up2_kernel :2504), called through upsample2_chw (:2576)
// and upsample2_chw_p (:1174), and its backward _up2_bwd_call (:2560, kernel
// _up2_bwd_kernel :2518): dx[i, j] = (g[2i, 2j] + g[2i, 2j+1]) +
// (g[2i+1, 2j] + g[2i+1, 2j+1]), summed in float32 in that order (the
// reference's column pair-sum, then row pair-sum), so it matches the plain
// version bit for bit.
//
// What bounds it on the H100: it does no arithmetic; it reads each input
// element once and writes it four times, so the bound is bytes.
// What the design does about it: one thread takes one 16-byte vector of an
// input row (8 bf16 or 4 float32 values), duplicates each value in
// registers (byte permutes) and stores two 16-byte vectors to output row 2i
// and the same two to row 2i + 1: one load and four stores of 16 bytes, so
// the instructions per byte are few and every access is a full 16-byte
// one. Neighbouring lanes swap their vectors first, so that each store
// instruction covers whole 32-byte sectors, not half of every other one. The grid is 2-D, rows of all planes along x and vectors of a row
// along y; a block's shape follows the row length (a row's vectors along
// threadIdx.x, as many rows as fill 256 threads along threadIdx.y), and
// at small shapes (N = 1 eval, a 48^2 input) fewer rows a block, so that
// at least kMinBlocks blocks cover the SMs. Index arithmetic is 32-bit
// within a row, with no division; a row's base is one 64-bit multiply. A
// row whose input or output rows are not 16-byte aligned (W not a multiple
// of the vector, or a view with a storage offset) and a ragged last vector
// are copied element by element by the same threads in the same launch.
// The TPU kernel needed a 0/1 interleave matmul because Mosaic has no lane
// interleave; a byte permute has no such limit here. Values are copied bit
// for bit (the kernel moves the elements' bits, never converts). The adjoint
// reads four values and writes one, bytes-bound too: one thread per output
// element, a 2-D grid (pixel blocks x planes) so that the index arithmetic
// is 32-bit with one division per thread, and each thread reads its 2x2
// block as two pairs of neighbouring elements.
//
// K10, the fused up-conv block's residual join, replaces
// upsample2_chw_add_p (pallas_conv.py:2173, pallas_call :2199, kernel
// _up2_add_kernel :2151): y = up2(x) + res in float32, stored in the
// activation type, with the optional float32 per-channel sums of the STORED
// y and y^2 (the next BatchNorm's batch moments). The port carries no lane
// padding, so the reference's pad-column fill has no counterpart. Bytes
// bound (it reads x and res once and writes y once): one thread per
// half-res pixel of one plane reads x once and its 2x2 block of res as two
// neighbouring pairs; a block's threads all lie in one plane, so with stats
// the block adds its two sums with one atomicAdd each. Its backward is K8
// (when the stats have cotangents) and K4's adjoint.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
// the fewest blocks a forward launch aims for where its rows allow: four
// per SM of an H100
constexpr int kMinBlocks = 4 * 132;

// 16 bytes of 2-byte values x0..x7 -> (x0 x0 x1 x1 x2 x2 x3 x3), (x4 x4 ..
// x7 x7); of 4-byte values x0..x3 -> (x0 x0 x1 x1), (x2 x2 x3 x3).
template <int kBytes>
__device__ __forceinline__ void duplicate(const uint4& v, uint4& lo, uint4& hi);

template <>
__device__ __forceinline__ void duplicate<2>(const uint4& v, uint4& lo, uint4& hi) {
  lo = make_uint4(__byte_perm(v.x, 0, 0x1010), __byte_perm(v.x, 0, 0x3232),
                  __byte_perm(v.y, 0, 0x1010), __byte_perm(v.y, 0, 0x3232));
  hi = make_uint4(__byte_perm(v.z, 0, 0x1010), __byte_perm(v.z, 0, 0x3232),
                  __byte_perm(v.w, 0, 0x1010), __byte_perm(v.w, 0, 0x3232));
}

template <>
__device__ __forceinline__ void duplicate<4>(const uint4& v, uint4& lo, uint4& hi) {
  lo = make_uint4(v.x, v.x, v.y, v.y);
  hi = make_uint4(v.z, v.z, v.w, v.w);
}

// B: the element's bits (uint16_t for bf16, uint32_t for float32). Thread
// (x, y) of block (bx, by) copies vector by * blockDim.x + x of rows bx *
// blockDim.y + y, + gridDim.x * blockDim.y, ... With blockDim.x even, lanes
// 2k and 2k + 1 hold neighbouring vectors of one row, whose output is four
// neighbouring 16-byte chunks per output row: the lanes swap vectors (one
// shuffle of 16 bytes) and the even lane stores chunks 0 and 2, the odd one
// 1 and 3, so that each store instruction writes whole 32-byte sectors (a
// lane's own two chunks would fill half of two sectors each).
template <typename B>
__global__ void __launch_bounds__(kThreads)
upsample2_chw_kernel(const B* __restrict__ x, B* __restrict__ y, int rows, int W) {
  constexpr int V = 16 / sizeof(B);
  const int j = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  const int n = W - j < V ? (W - j > 0 ? W - j : 0) : V;
  const int odd = threadIdx.x & 1;
  const bool paired = (blockDim.x & 1) == 0;
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  const unsigned pair = 3u << (lane & 30);
  const int step = gridDim.x * blockDim.y;
  for (int r = blockIdx.x * blockDim.y + threadIdx.y; r < rows; r += step) {
    const B* src = x + static_cast<size_t>(r) * W;
    B* top = y + static_cast<size_t>(r) * 4 * W;
    B* bot = top + 2 * W;
    const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(top) |
                           reinterpret_cast<uintptr_t>(bot)) & 15) == 0;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (aligned && n == V) v = *reinterpret_cast<const uint4*>(src + j);
    if (paired) {
      uint4 p;
      p.x = __shfl_xor_sync(pair, v.x, 1);
      p.y = __shfl_xor_sync(pair, v.y, 1);
      p.z = __shfl_xor_sync(pair, v.z, 1);
      p.w = __shfl_xor_sync(pair, v.w, 1);
      const int je = j - odd * V;  // the even lane's vector
      if (aligned && je + 2 * V <= W) {
        uint4 lo, hi, plo, phi;
        duplicate<sizeof(B)>(v, lo, hi);
        duplicate<sizeof(B)>(p, plo, phi);
        const uint4 first = odd ? phi : lo;   // chunk 1 (odd) or 0 (even)
        const uint4 second = odd ? hi : plo;  // chunk 3 (odd) or 2 (even)
        uint4* t4 = reinterpret_cast<uint4*>(top + 2 * je) + odd;
        uint4* b4 = reinterpret_cast<uint4*>(bot + 2 * je) + odd;
        t4[0] = first;
        b4[0] = first;
        t4[2] = second;
        b4[2] = second;
        continue;
      }
    }
    if (aligned && n == V) {
      uint4 lo, hi;
      duplicate<sizeof(B)>(v, lo, hi);
      reinterpret_cast<uint4*>(top + 2 * j)[0] = lo;
      reinterpret_cast<uint4*>(top + 2 * j)[1] = hi;
      reinterpret_cast<uint4*>(bot + 2 * j)[0] = lo;
      reinterpret_cast<uint4*>(bot + 2 * j)[1] = hi;
    } else {
      for (int e = 0; e < n; ++e) {
        const B val = src[j + e];
        top[2 * (j + e)] = val;
        top[2 * (j + e) + 1] = val;
        bot[2 * (j + e)] = val;
        bot[2 * (j + e) + 1] = val;
      }
    }
  }
}

template <typename B>
int launch(const void* x, void* y, long long planes, int h, int w, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(B);
  const long long rows = planes * h;
  if (rows <= 0 || w <= 0) return 0;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = (w + V - 1) / V;
  const int even = nvec + (nvec & 1);  // lanes pair up within a row
  const int bx = even < kThreads ? even : kThreads;
  const int gy = (nvec + bx - 1) / bx;
  // rows a block: as many as fill kThreads, fewer where that would leave
  // fewer than kMinBlocks blocks
  const long long xblocks = (kMinBlocks + gy - 1) / gy;
  const long long fill = (rows + xblocks - 1) / xblocks;
  const int by = static_cast<int>(fill < kThreads / bx ? fill : kThreads / bx);
  const long long gx = (rows + by - 1) / by;
  upsample2_chw_kernel<B><<<dim3(static_cast<unsigned>(gx < (1 << 20) ? gx : (1 << 20)), gy),
                            dim3(bx, by), 0, stream>>>(
      static_cast<const B*>(x), static_cast<B*>(y), static_cast<int>(rows), w);
  return itg::last_error();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_chw_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int planes, int H, int W) {
  const int hw = H * W;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= hw) return;
  const int i = idx / W;
  const int j = idx - i * W;
  const int W2 = 2 * W;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const T* g0 = g + (static_cast<size_t>(p) * 2 * H + 2 * i) * W2 + 2 * j;
    const float top = itg::to_f32<T>(g0[0]) + itg::to_f32<T>(g0[1]);
    const float bot = itg::to_f32<T>(g0[W2]) + itg::to_f32<T>(g0[W2 + 1]);
    dx[static_cast<size_t>(p) * hw + idx] = itg::from_f32<T>(top + bot);
  }
}

template <typename T>
int launch_bwd(const void* g, void* dx, int planes, int h, int w, cudaStream_t stream) {
  const dim3 grid((h * w + kThreads - 1) / kThreads, planes < 65535 ? planes : 65535);
  upsample2_chw_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), planes, h, w);
  return itg::last_error();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_add_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                     float* __restrict__ s1, float* __restrict__ s2, int planes, int C, int H,
                     int W) {
  __shared__ float s_red[kThreads / 32][2];
  const int hw = H * W;
  const int W2 = 2 * W;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    float v[2] = {0.f, 0.f};
    for (int idx = blockIdx.x * kThreads + threadIdx.x; idx < hw; idx += gridDim.x * kThreads) {
      const int i = idx / W;
      const int j = idx - i * W;
      const float xv = itg::to_f32<T>(x[static_cast<size_t>(p) * hw + idx]);
      const size_t top = (static_cast<size_t>(p) * 2 * H + 2 * i) * W2 + 2 * j;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const size_t off = top + a * W2 + b;
          const T out = itg::from_f32<T>(xv + itg::to_f32<T>(res[off]));
          y[off] = out;
          const float f = itg::to_f32<T>(out);
          v[0] += f;
          v[1] += f * f;
        }
      }
    }
    if (s1) {  // the same for every thread of the launch
      const int c = p % C;
      itg::block_sum2_atomic<1>(v, &s_red[0][0], s1 + c, s2 + c, 1);
    }
  }
}

template <typename T>
int launch_add(const void* x, const void* res, void* y, float* s1, float* s2, int planes, int c,
               int h, int w, cudaStream_t stream) {
  const int want = (h * w + kThreads - 1) / kThreads;
  const dim3 grid(want < 256 ? want : 256, planes < 65535 ? planes : 65535);
  upsample2_add_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), s1, s2, planes, c,
      h, w);
  return itg::last_error();
}

}  // namespace

// x (planes = N * C, H, W) -> y (planes, 2H, 2W), 4-byte elements (float32)
// or 2-byte elements (bfloat16, when bf16 != 0); planes * H < 2^31. Returns
// cudaGetLastError() (cudaErrorInvalidValue for more rows).
extern "C" int itg_upsample2_chw(const void* x, void* y, long long planes, int h, int w,
                                 int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<uint16_t>(x, y, planes, h, w, st);
  return launch<uint32_t>(x, y, planes, h, w, st);
}

// g (planes, 2H, 2W) -> dx (planes, H, W), float32 or bfloat16 (bf16 != 0);
// H * W < 2^31. Returns cudaGetLastError().
extern "C" int itg_upsample2_chw_bwd(const void* g, void* dx, int planes, int h, int w, int bf16,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_bwd<__nv_bfloat16>(g, dx, planes, h, w, st);
  return launch_bwd<float>(g, dx, planes, h, w, st);
}

// x (planes = N * C, H, W), res and y (planes, 2H, 2W): float32 or bfloat16
// (bf16 != 0); H * W < 2^31. s1/s2 (C) float32, zeroed by the caller, or
// null for no stats. Returns cudaGetLastError().
extern "C" int itg_upsample2_chw_add(const void* x, const void* res, void* y, void* s1, void* s2,
                                     int planes, int c, int h, int w, int bf16, void* stream) {
  auto* a = static_cast<float*>(s1);
  auto* q = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_add<__nv_bfloat16>(x, res, y, a, q, planes, c, h, w, st);
  return launch_add<float>(x, res, y, a, q, planes, c, h, w, st);
}
