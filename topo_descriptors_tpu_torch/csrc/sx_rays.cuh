// Per-pixel Sx arithmetic shared by the Sx kernels (sx_block.cu, sx_sweep.cu,
// sx_chunked.cuh).
//
// One azimuth's rays are grouped by identical 1/distance: `offsets` holds
// (oy, ox) pairs ordered by group, group g owns pairs
// group_ptr[g] .. group_ptr[g + 1] - 1 and has reciprocal distance inv[g].
// The max ratio of pixel (y, x), with base = dem[y, x] + height, is
//   acc = -inf; for g in order:
//     best = NaN; for k in group g, in order:
//       best = fmaxf(best, dem[y + oy_k, x + ox_k])   (NaN outside the grid)
//     acc = fmaxf(acc, (best - base) * inv[g])
// so -inf when no candidate is valid (no rays, or every read or ratio NaN),
// and never NaN. Every kernel computes it through these functions, so all
// of them run the same operations in the same order and their outputs agree
// bit for bit.
//
// Grouping is exact: rounding of (s - base) and of the product by inv >= 0
// is monotonic, and the inv = +inf distance-0 quirk gives +-inf or a
// 0 * inf NaN that fmaxf drops, exactly as the per-ray form does.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The max ratio over a run of groups, for kR pixels of one thread at once
// (the halo tiles and chunks of sx_block.cu, sx_sweep.cu and
// sx_chunked.cuh). `tile` holds the DEM around the block with NaN outside
// the grid, so pixel r reads tile[at[r] + soff[k]] where the definition
// above reads dem[y + oy_k, x + ox_k] (or NaN). The run has n_seg
// segments: segment g owns rays group_ptr[g] .. group_ptr[g + 1] - 1 and
// has reciprocal distance inv[g]. A segment is a whole group, or the part
// of a group that a chunk of the chunked route holds: with `carry_in`
// segment 0 goes on with the group whose running max `best` the previous
// chunk left; with `carry_out` the last segment's group goes on in the next
// chunk, so its max stays in `best` and does not join `acc` yet. `best`
// starts from a group's first ray instead of NaN, which saves one fmax per
// group (most groups hold a single ray): every group holds at least one
// ray (ray_groups), and fmaxf(NaN, v) is v. So each pixel sees the values
// of the definition above in the same order, across chunks too, and the two
// agree bit for bit.
template <int kR>
static __device__ __forceinline__ void sx_max_ratio_run(
    const float* tile, const int* soff, const int* group_ptr, const float* inv,
    int n_seg, bool carry_in, bool carry_out, const int (&at)[kR],
    const float (&base)[kR], float (&acc)[kR], float (&best)[kR]) {
  for (int g = 0; g < n_seg; ++g) {
    int k = group_ptr[g];
    const int k1 = group_ptr[g + 1];
    if (g > 0 || !carry_in) {
      const int s0 = soff[k++];
#pragma unroll
      for (int r = 0; r < kR; ++r) best[r] = tile[at[r] + s0];
    }
    for (; k < k1; ++k) {
      const int s = soff[k];
#pragma unroll
      for (int r = 0; r < kR; ++r) best[r] = fmaxf(best[r], tile[at[r] + s]);
    }
    if (carry_out && g == n_seg - 1) break;
    const float ig = inv[g];
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[r] = fmaxf(acc[r], (best[r] - base[r]) * ig);
  }
}

// A whole table of n_groups groups in one staged tile (the tile routes):
// sx_max_ratio_run from acc = -inf, with no group open at either end.
template <int kR>
static __device__ __forceinline__ void sx_max_ratio_tile(
    const float* tile, const int* soff, const int* group_ptr, const float* inv,
    int n_groups, const int (&at)[kR], const float (&base)[kR],
    float (&acc)[kR]) {
  float best[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = -INFINITY;
  sx_max_ratio_run<kR>(tile, soff, group_ptr, inv, n_groups, false, false, at,
                       base, acc, best);
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
