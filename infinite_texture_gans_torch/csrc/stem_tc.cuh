// What the stem's kernels on the tensor cores share (stem_fwd_tc.cu: K13's
// forward; stem_dw_tc.cu: K13 dW): the tile of kTR output rows x kTJ output
// pixels of one image, and the 16-byte units of the image rows under it.
#pragma once

#include "common.cuh"

namespace itg::stem {

constexpr int kTR = 4;                     // output rows per tile
constexpr int kTJ = 32;                    // output pixels per tile row: two k16 / m16 steps
constexpr int kRows = 2 * kTR + 2;         // input rows under a tile, per channel
constexpr int kChunks = 2 * kTJ / 8 + 2;   // 16-byte units per input row: columns 2 j0 - 8 ..

struct Tile {
  int n, i0, j0;
};

__device__ __forceinline__ Tile tile_at(long t, int it_n, int jt_n) {
  const int jt = static_cast<int>(t % jt_n);
  const long rest = t / jt_n;
  return {static_cast<int>(rest / it_n), static_cast<int>(rest % it_n) * kTR, jt * kTJ};
}

// The 16-byte unit q of tile `tl` of x (N, C, H, W): channel, input row 2 i0
// - 1 + rr, columns 2 j0 - 8 + 8k .. + 7 (a multiple of 8, so with W % 8 ==
// 0 it lies wholly inside or outside a row); zero outside the image.
template <int C>
__device__ __forceinline__ uint4 load_chunk(const uint16_t* x, int H, int W, const Tile& tl,
                                            int q) {
  const int c = q / (kRows * kChunks);
  const int rr = (q / kChunks) % kRows;
  const int k = q % kChunks;
  const int gr = 2 * tl.i0 - 1 + rr;
  const int gc = 2 * tl.j0 - 8 + 8 * k;
  if (gr < 0 || gr >= H || gc < 0 || gc >= W) return make_uint4(0, 0, 0, 0);
  return *reinterpret_cast<const uint4*>(x + ((static_cast<size_t>(tl.n) * C + c) * H + gr) * W +
                                         gc);
}

}  // namespace itg::stem
