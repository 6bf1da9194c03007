// Nearest-neighbour 2x upsample on channels-major (N, C, H, W) activations:
// y[n, c, 2i + a, 2j + b] = x[n, c, i, j].
//
// Replaces K4 infinite_texture_gans_tpu/ops/pallas_conv.py:_up2_fwd_call
// (:2535, kernel _up2_kernel :2504), called through upsample2_chw (:2576).
//
// What bounds it on the H100: it does no arithmetic; it reads each input
// element once and writes it four times, so the bound is bytes.
// What the design does about it: one thread per output element in a
// grid-stride loop, so consecutive threads store consecutive addresses
// (coalesced writes, the larger stream) and neighbouring thread pairs read
// the same input element, which the cache serves. The TPU kernel needed a
// 0/1 interleave matmul because Mosaic has no lane interleave; a plain
// gather has no such limit here. Values are copied bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample2_chw_kernel(const T* __restrict__ x, T* __restrict__ y, long long planes, int H, int W) {
  const int W2 = 2 * W;
  const int H2 = 2 * H;
  const long long total = planes * H2 * W2;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int ox = static_cast<int>(i % W2);
    const long long t = i / W2;
    const int oy = static_cast<int>(t % H2);
    const long long p = t / H2;
    y[i] = x[(p * H + (oy >> 1)) * W + (ox >> 1)];
  }
}

template <typename T>
int launch(const void* x, void* y, long long planes, int h, int w, cudaStream_t stream) {
  const long long total = planes * 4LL * h * w;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1LL << 20) ? want : (1LL << 20));
  upsample2_chw_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, h, w);
  return itg::last_error();
}

}  // namespace

// x (planes = N * C, H, W) -> y (planes, 2H, 2W), 4-byte elements (float32)
// or 2-byte elements (bfloat16, when bf16 != 0). Returns cudaGetLastError().
extern "C" int itg_upsample2_chw(const void* x, void* y, long long planes, int h, int w,
                                 int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, y, planes, h, w, st);
  return launch<float>(x, y, planes, h, w, st);
}
