// K8, the backward of the generator tail's BatchNorm statistics, on
// channels-major (N, C, H, W) activations: the cotangents of a producer's
// BN statistics folded into the gradient of its output.
//
// Replaces infinite_texture_gans_tpu/ops/pallas_conv.py:1061 _bn_corr
// (kernel _bn_corr_kernel :1039): out = g + (alpha[c] + beta2[c] * y).
// (K6 and K7, the 3x3 conv's dx and dW, are in conv3x3_dx_f32.cu and
// conv3x3_dw_f32.cu; in bf16 in chw_dx_tc.cu and chw_dw_tc.cu.)
//
// What bounds it on the H100: it reads two arrays and writes one, with 3
// FLOPs an element: bytes (3.35 TB/s).
// What the design does about it: it moves 16-byte vectors (8 bf16 or 4
// float32 values of each array per load and store), kCorrVecs of them in
// flight per thread (all loads issued before any arithmetic). A grid sized
// to the card walks (plane, vector): blockIdx.y strides over the planes,
// loading the plane's alpha and beta2 once, and blockIdx.x with the threads
// covers the plane's vectors. A plane whose start is not 16-byte aligned
// (HW no multiple of the vector, or a pointer with a storage offset) takes a
// scalar head up to g's first 16-byte boundary and a scalar tail, in the
// same launch; if g, y and out sit at different offsets within 16 bytes,
// each thread reads its vectors' elements one by one. The arithmetic is the
// plain version's, one rounding at the store (__fmul_rn, then __fadd_rn
// twice), so the result is bit-equal to it.
#include "common.cuh"

namespace {

using itg::from_f32;
using itg::to_f32;

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// K8: g + (alpha + beta2 * y)

constexpr int kCorrVecs = 2;  // 16-byte vectors of each array in flight per thread
constexpr int kCorrBlocksPerSm = 8;

// g + (alpha + beta2 * y), one rounding per float32 operation
__device__ __forceinline__ float corr(float g, float y, float a, float b2) {
  return __fadd_rn(g, __fadd_rn(a, __fmul_rn(b2, y)));
}

template <typename T>
__device__ __forceinline__ T corr_one(T g, T y, float a, float b2) {
  return from_f32<T>(corr(to_f32<T>(g), to_f32<T>(y), a, b2));
}

// Grid (ceil(HW / V / (kThreads kCorrVecs)), planes or fewer): block (bx,
// by) takes vectors bx kThreads kCorrVecs + u kThreads + threadIdx.x (u <
// kCorrVecs) of planes by, by + gridDim.y, ...; the blocks with bx = 0 also
// take each plane's scalar head and tail.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_corr_kernel(const T* __restrict__ g, const T* __restrict__ y, const float* __restrict__ alpha,
               const float* __restrict__ beta2, T* __restrict__ out, int planes, int C, int HW) {
  constexpr int V = 16 / sizeof(T);
  for (int plane = blockIdx.y; plane < planes; plane += gridDim.y) {
    const int c = plane % C;
    const float a = alpha[c], b2 = beta2[c];
    const size_t base = static_cast<size_t>(plane) * HW;
    const T* gp = g + base;
    const T* yp = y + base;
    T* op = out + base;
    const uintptr_t mis = reinterpret_cast<uintptr_t>(gp) & 15;
    const bool vec = (reinterpret_cast<uintptr_t>(yp) & 15) == mis &&
                     (reinterpret_cast<uintptr_t>(op) & 15) == mis;
    const int head = vec ? min(static_cast<int>(((16 - mis) & 15) / sizeof(T)), HW) : 0;
    const int nvec = (HW - head) / V;
    const int tail = head + nvec * V;
    if (blockIdx.x == 0) {
      for (int e = threadIdx.x; e < head; e += kThreads) op[e] = corr_one(gp[e], yp[e], a, b2);
      for (int e = tail + threadIdx.x; e < HW; e += kThreads) op[e] = corr_one(gp[e], yp[e], a, b2);
    }
    const int v0 = blockIdx.x * kThreads * kCorrVecs + threadIdx.x;
    if (vec) {
      const uint4* g4 = reinterpret_cast<const uint4*>(gp + head);
      const uint4* y4 = reinterpret_cast<const uint4*>(yp + head);
      uint4* o4 = reinterpret_cast<uint4*>(op + head);
      uint4 gv[kCorrVecs], yv[kCorrVecs];
#pragma unroll
      for (int u = 0; u < kCorrVecs; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nvec) {
          gv[u] = g4[v];
          yv[u] = y4[v];
        }
      }
#pragma unroll
      for (int u = 0; u < kCorrVecs; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nvec) {
          float gf[V], yf[V];
          itg::unpack_vec(gv[u], gf);
          itg::unpack_vec(yv[u], yf);
#pragma unroll
          for (int e = 0; e < V; ++e) gf[e] = corr(gf[e], yf[e], a, b2);
          o4[v] = itg::pack_vec(gf);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kCorrVecs; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nvec) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            op[v * V + e] = corr_one(gp[v * V + e], yp[v * V + e], a, b2);
          }
        }
      }
    }
  }
}

template <typename T>
int launch_corr(const void* g, const void* y, const float* alpha, const float* beta2, void* out,
                int planes, int c, int hw, cudaStream_t stream) {
  if (planes < 1 || c < 1 || hw < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const int per_block = kThreads * kCorrVecs;
  const int bx = hw / V > per_block ? (hw / V + per_block - 1) / per_block : 1;
  const int want = kCorrBlocksPerSm * itg::sm_count() / bx;
  const int gy = want < 1 ? 1 : (want < planes ? want : planes);  // want <= 8 x the SMs
  bn_corr_kernel<T><<<dim3(bx, gy), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), alpha, beta2, static_cast<T*>(out),
      planes, c, hw);
  return itg::last_error();
}

}  // namespace

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
