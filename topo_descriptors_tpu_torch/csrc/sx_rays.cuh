// Per-pixel Sx arithmetic shared by the Sx kernels (sx_block.cu, sx_sweep.cu).
//
// One azimuth's rays are grouped by identical 1/distance: `offsets` holds
// (oy, ox) pairs ordered by group, group g owns pairs
// group_ptr[g] .. group_ptr[g + 1] - 1 and has reciprocal distance inv[g].
// Every kernel reads its azimuth's groups g0 .. g1 - 1 through these
// functions, so all of them run the same operations in the same order and
// their outputs agree bit for bit.
//
// Grouping is exact: rounding of (s - base) and of the product by inv >= 0
// is monotonic, and the inv = +inf distance-0 quirk gives +-inf or a
// 0 * inf NaN that fmaxf drops, exactly as the per-ray form does.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// max over groups g of (max_{k in g} dem[y + oy_k, x + ox_k] - base) * inv[g];
// reads outside the grid count as NaN, which fmaxf drops. -inf when no
// candidate is valid (no rays, or every read or ratio NaN).
static __device__ __forceinline__ float sx_max_ratio(
    const float* __restrict__ dem, const int* __restrict__ offsets,
    const int* __restrict__ group_ptr, const float* __restrict__ inv, int g0,
    int g1, int h, int w, int y, int x, float base) {
  float acc = -INFINITY;
  for (int g = g0; g < g1; ++g) {
    float best = NAN;
    for (int k = group_ptr[g]; k < group_ptr[g + 1]; ++k) {
      const int yy = y + offsets[2 * k];
      const int xx = x + offsets[2 * k + 1];
      const float v = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                          ? dem[static_cast<int64_t>(yy) * w + xx]
                          : NAN;
      best = fmaxf(best, v);
    }
    acc = fmaxf(acc, (best - base) * inv[g]);
  }
  return acc;
}

// The shared-memory variant of sx_max_ratio, for kR pixels of one thread
// at once (sx_block.cu's halo tile). `tile` holds the DEM around the block
// with NaN outside the grid, so pixel r reads tile[at[r] + soff[k]] where
// sx_max_ratio reads dem[y + oy_k, x + ox_k] (or NaN); `group_ptr` and
// `inv` are as above. Each pixel sees the same operations in the same order
// as in sx_max_ratio, so the two agree bit for bit.
template <int kR>
static __device__ __forceinline__ void sx_max_ratio_tile(
    const float* tile, const int* soff, const int* group_ptr, const float* inv,
    int n_groups, const int (&at)[kR], const float (&base)[kR],
    float (&acc)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = -INFINITY;
  for (int g = 0; g < n_groups; ++g) {
    float best[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) best[r] = NAN;
    const int k1 = group_ptr[g + 1];
    for (int k = group_ptr[g]; k < k1; ++k) {
      const int s = soff[k];
#pragma unroll
      for (int r = 0; r < kR; ++r) best[r] = fmaxf(best[r], tile[at[r] + s]);
    }
    const float ig = inv[g];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = fmaxf(acc[r], (best[r] - base[r]) * ig);
  }
}

// atan in degrees; no valid candidate (-inf) -> NaN, as the reference's
// np.nanmax of an all-NaN slice.
static __device__ __forceinline__ float sx_degrees(float max_ratio) {
  return max_ratio == -INFINITY ? NAN : atanf(max_ratio) * 57.29577951308232f;
}

static __device__ __forceinline__ bool sx_interior(int y, int x, int h, int w,
                                                   int border) {
  return y >= border && y < h - border && x >= border && x < w - border;
}
