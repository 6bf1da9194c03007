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
// bound: it reads x and res once and writes y once, 18 bytes per half-res
// bf16 element. What the design does about it: K4's scheme with the add.
// One thread takes one 16-byte vector of an x row (8 bf16 or 4 float32
// values), duplicates it in registers (the byte permutes above), loads the
// matching two 16-byte res chunks of output rows 2i and 2i + 1, adds in
// float32 (__fadd_rn, one rounding at the store: the plain version's bits)
// and stores four 16-byte y chunks; neighbouring lanes swap vectors, as
// K4's do, so that every load and store instruction covers whole 32-byte
// sectors. Where the shape fills the card with it, a thread takes two rows
// at once, all ten loads issued before any arithmetic. The grid is 2-D,
// chunks of a plane's rows along x and planes along y, so a block's
// channel is fixed; the plan (ops/kernels.py: upsample2_add_plan) keeps
// blocks at 64 threads or fewer and cuts the rows so that the launch has
// at least eight blocks per SM wherever the rows allow (N = 1 eval
// included: blocks of a few threads there), and the index
// arithmetic within a plane is 32-bit, with no division per element. A row
// whose x, res or y rows are not 16-byte aligned (an odd W, W no multiple
// of the vector, a view with a storage offset) and a ragged last vector go
// element by element, in the same threads and launch. With stats, each
// block sums the values it stored in one fixed order (per thread, then a
// fixed tree over the block) and writes one partial pair for its (image,
// row chunk) and channel; a last launch adds the partials in one fixed
// order. No atomics: two calls give the same bits for y and the sums. Its
// backward is K8 (when the stats have cotangents) and K4's adjoint.
#include "chw_fwd_tc.cuh"  // sum_partials
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

// ---------------------------------------------------------------------------
// K10: y = up2(x) + res, with the optional partial sums of the stored y, y^2

// What a thread does with one x vector of one row (16 bytes of x, 64 of y):
// its pair's four output chunks split between the two lanes (kPair), its
// own two chunks (kOwn: the pair's other vector is ragged), element by
// element (kScalar: a ragged vector or an unaligned row), or nothing.
enum AddMode { kNone, kScalar, kOwn, kPair };

// the most threads a K10 block has (the plan's cap: on an H100 many small
// blocks moved the bytes faster than fewer large ones, k10_plan_study.py)
constexpr int kAddThreads = 64;

// One 16-byte output chunk: the duplicated x bits d plus the res chunk r in
// float32, rounded once to T (the plain version's one add); with kStats
// the stored values are added to s and their squares to q, in order.
template <typename T, bool kStats>
__device__ __forceinline__ uint4 add_chunk(const uint4& d, const uint4& r, float& s, float& q) {
  constexpr int V = 16 / sizeof(T);
  float a[V], b[V];
  itg::unpack_vec(d, a);
  itg::unpack_vec(r, b);
#pragma unroll
  for (int e = 0; e < V; ++e) a[e] = __fadd_rn(a[e], b[e]);
  const uint4 out = itg::pack_vec(a);
  if (kStats) {
    itg::unpack_vec(out, a);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s = __fadd_rn(s, a[e]);
      q = __fmaf_rn(a[e], a[e], q);
    }
  }
  return out;
}

// Grid (chunks, planes or fewer), block (bx, by): block (cx, p) takes x rows
// cx * chunk .. (cx + 1) * chunk - 1 of planes p, p + gridDim.y, ...; thread
// (tx, ty) takes the row's vectors tx, tx + bx, ... of rows ty, ty + by, ...
// of the chunk, kRows rows at a time, all their loads issued before any
// arithmetic. With kStats each (plane, chunk) block writes its sums of the
// stored y and y^2, reduced in one fixed order, to part[(n * chunks + cx) *
// 2C + c] and part[... + C + c] (n, c: the plane's image and channel).
template <typename T, int kRows, bool kStats>
__global__ void __launch_bounds__(kAddThreads)
upsample2_add_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                     float* __restrict__ part, int planes, int C, int H, int W, int chunk) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float s_red[2][kAddThreads];
  const int tx = threadIdx.x, odd = tx & 1;
  const int tid = threadIdx.y * blockDim.x + tx;
  const int nt = blockDim.x * blockDim.y;
  const unsigned pair = 3u << (tid & 30);  // blockDim.x is even: a pair shares a row
  const int W2 = 2 * W;
  const int nvec = (W + V - 1) / V;
  const int jvs = nvec + (nvec & 1);
  const int r0 = blockIdx.x * chunk;
  const int r1 = min(r0 + chunk, H);
  const size_t hw = static_cast<size_t>(H) * W;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const T* xp = x + hw * p;
    const T* rp = res + 4 * hw * p;
    T* yp = y + 4 * hw * p;
    float s = 0.f, q = 0.f;
    for (int jv = tx; jv < jvs; jv += blockDim.x) {
      const int j = jv * V;          // this lane's first x column
      const int je = j - odd * V;    // its pair's
      const int n = W - j < V ? max(W - j, 0) : V;
      for (int i0 = r0 + threadIdx.y; i0 < r1; i0 += kRows * blockDim.y) {
        uint4 xv[kRows], rv[kRows][4];
        int mode[kRows], o1[kRows], o2[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int i = i0 + u * blockDim.y;
          mode[u] = kNone;
          if (i < r1) {
            const uintptr_t bases = reinterpret_cast<uintptr_t>(xp + i * W) |
                                    reinterpret_cast<uintptr_t>(rp + 2 * i * W2) |
                                    reinterpret_cast<uintptr_t>(rp + (2 * i + 1) * W2) |
                                    reinterpret_cast<uintptr_t>(yp + 2 * i * W2) |
                                    reinterpret_cast<uintptr_t>(yp + (2 * i + 1) * W2);
            const bool aligned = (bases & 15) == 0;
            mode[u] = aligned && je + 2 * V <= W ? kPair
                      : aligned && n == V      ? kOwn
                      : n > 0                  ? kScalar
                                               : kNone;
          }
          // kPair: the even lane takes the pair's output chunks 0 and 2, the
          // odd lane 1 and 3, so that each access instruction covers whole
          // 32-byte sectors; kOwn: the lane's own chunks
          o1[u] = mode[u] == kPair ? 2 * je + odd * V : 2 * j;
          o2[u] = o1[u] + (mode[u] == kPair ? 2 * V : V);
          xv[u] = make_uint4(0, 0, 0, 0);
          if (mode[u] >= kOwn) {
            const T* top = rp + 2 * i * W2;
            xv[u] = *reinterpret_cast<const uint4*>(xp + i * W + j);
            rv[u][0] = *reinterpret_cast<const uint4*>(top + o1[u]);
            rv[u][1] = *reinterpret_cast<const uint4*>(top + o2[u]);
            rv[u][2] = *reinterpret_cast<const uint4*>(top + W2 + o1[u]);
            rv[u][3] = *reinterpret_cast<const uint4*>(top + W2 + o2[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int i = i0 + u * blockDim.y;
          uint4 pv;  // the pair's other vector (both lanes always shuffle)
          pv.x = __shfl_xor_sync(pair, xv[u].x, 1);
          pv.y = __shfl_xor_sync(pair, xv[u].y, 1);
          pv.z = __shfl_xor_sync(pair, xv[u].z, 1);
          pv.w = __shfl_xor_sync(pair, xv[u].w, 1);
          if (mode[u] >= kOwn) {
            uint4 first, second;
            duplicate<sizeof(T)>(xv[u], first, second);
            if (mode[u] == kPair) {
              uint4 plo, phi;
              duplicate<sizeof(T)>(pv, plo, phi);
              if (odd) {
                first = phi;   // the even lane's hi: chunk 1 (its own hi is chunk 3)
              } else {
                second = plo;  // the odd lane's lo: chunk 2 (its own lo is chunk 0)
              }
            }
            T* top = yp + 2 * i * W2;
            T* bot = top + W2;
            *reinterpret_cast<uint4*>(top + o1[u]) = add_chunk<T, kStats>(first, rv[u][0], s, q);
            *reinterpret_cast<uint4*>(top + o2[u]) = add_chunk<T, kStats>(second, rv[u][1], s, q);
            *reinterpret_cast<uint4*>(bot + o1[u]) = add_chunk<T, kStats>(first, rv[u][2], s, q);
            *reinterpret_cast<uint4*>(bot + o2[u]) = add_chunk<T, kStats>(second, rv[u][3], s, q);
          } else if (mode[u] == kScalar) {
            for (int e = 0; e < n; ++e) {
              const float xf = itg::to_f32<T>(xp[i * W + j + e]);
#pragma unroll
              for (int a = 0; a < 2; ++a) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                  const int off = (2 * i + a) * W2 + 2 * (j + e) + b;
                  const T out = itg::from_f32<T>(__fadd_rn(xf, itg::to_f32<T>(rp[off])));
                  yp[off] = out;
                  if (kStats) {
                    const float f = itg::to_f32<T>(out);
                    s = __fadd_rn(s, f);
                    q = __fmaf_rn(f, f, q);
                  }
                }
              }
            }
          }
        }
      }
    }
    if (kStats) {  // a fixed tree over the block's threads, then one write
      s_red[0][tid] = s;
      s_red[1][tid] = q;
      __syncthreads();
      for (int h = nt > 1 ? 1 << (31 - __clz(nt - 1)) : 0; h > 0; h >>= 1) {
        if (tid < h && tid + h < nt) {
          s_red[0][tid] = __fadd_rn(s_red[0][tid], s_red[0][tid + h]);
          s_red[1][tid] = __fadd_rn(s_red[1][tid], s_red[1][tid + h]);
        }
        __syncthreads();
      }
      if (tid == 0) {
        const int img = p / C;
        float* dst =
            part + (static_cast<size_t>(img) * gridDim.x + blockIdx.x) * 2 * C + (p - img * C);
        dst[0] = s_red[0][0];
        dst[C] = s_red[1][0];
      }
      __syncthreads();  // s_red is read again for the next plane
    }
  }
}

template <typename T, int kRows>
void launch_add_rows(const T* x, const T* res, T* y, float* part, int planes, int c, int h, int w,
                     int chunk, dim3 grid, dim3 block, cudaStream_t stream) {
  if (part) {
    upsample2_add_kernel<T, kRows, true><<<grid, block, 0, stream>>>(x, res, y, part, planes, c,
                                                                      h, w, chunk);
  } else {
    upsample2_add_kernel<T, kRows, false><<<grid, block, 0, stream>>>(x, res, y, part, planes, c,
                                                                       h, w, chunk);
  }
}

// The plan (ops/kernels.py: upsample2_add_plan) gives the block (bx, by),
// the rows a thread takes at once and the x rows of a chunk; with stats a
// second launch adds the (N * chunks) partials of each channel in one
// fixed order (chw_fwd_tc.cuh: sum_partials).
template <typename T>
int launch_add(const void* x, const void* res, void* y, float* part, float* s1, float* s2,
               int planes, int c, int h, int w, int bx, int by, int rows, int chunk,
               cudaStream_t stream) {
  if (planes < 1 || c < 1 || planes % c || h < 1 || w < 1 || bx < 2 || (bx & 1) || by < 1 ||
      bx * by > kAddThreads || chunk < 1 || (rows != 1 && rows != 2) ||
      static_cast<long long>(h) * w >= (1LL << 29) || (s1 && !(part && s2)) ||
      (!s1 && part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (h + chunk - 1) / chunk;
  const dim3 grid(chunks, planes < 65535 ? planes : 65535), block(bx, by);
  const auto* xt = static_cast<const T*>(x);
  const auto* rt = static_cast<const T*>(res);
  auto* yt = static_cast<T*>(y);
  if (rows == 2) {
    launch_add_rows<T, 2>(xt, rt, yt, part, planes, c, h, w, chunk, grid, block, stream);
  } else {
    launch_add_rows<T, 1>(xt, rt, yt, part, planes, c, h, w, chunk, grid, block, stream);
  }
  if (int rc = itg::last_error()) return rc;
  if (!part) return 0;
  itg::sum_partials<<<2 * c, itg::kReduceThreads, 0, stream>>>(part, s1, s2, planes / c * chunks,
                                                               c);
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
// (bf16 != 0); H * W < 2^29. Block (bx, by), rows a thread takes at once
// (1 or 2) and x rows a block (chunk): the plan's. With stats, part
// (N * ceil(H / chunk), 2C) float32 scratch and s1/s2 (C) float32, written
// (not accumulated); all three null for none. Returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments outside these).
extern "C" int itg_upsample2_chw_add(const void* x, const void* res, void* y, void* part, void* s1,
                                     void* s2, int planes, int c, int h, int w, int bx, int by,
                                     int rows, int chunk, int bf16, void* stream) {
  auto* pt = static_cast<float*>(part);
  auto* a = static_cast<float*>(s1);
  auto* q = static_cast<float*>(s2);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_add<__nv_bfloat16>(x, res, y, pt, a, q, planes, c, h, w, bx, by, rows, chunk, st);
  }
  return launch_add<float>(x, res, y, pt, a, q, planes, c, h, w, bx, by, rows, chunk, st);
}
