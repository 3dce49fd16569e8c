// Sx (Winstral wind-shelter) horizon scan for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_descriptors_tpu/ops/pallas/sx_block.py::_sx_kernel
// together with the XLA epilogue that sx_pallas runs after it
// (sx_block.py:735-742). Per pixel:
//   acc = max over distance groups g of (max_{k in g} dem[y+oy_k, x+ox_k]
//                                        - (dem[y, x] + height)) * inv_g,
// with fmaxf dropping NaN (reads outside the grid count as NaN), then
// atan, degrees, -inf -> NaN (no valid candidate) and the zero border.
// The per-pixel arithmetic lives in sx_rays.cuh, shared with sx_sweep.cu.
//
// What bounds it on the H100: load instructions, not device memory. Each
// pixel reads K deduplicated ray pixels (32 at r = 500 m, 464 at r = 2000 m
// on 30 m) and does one fmax per read; the bytes it must move (the DEM
// once, the output once) take ~0.16 ms at 8192^2. Served from L1/L2 as
// bounds-checked scalar loads, with four table loads per ray, the earlier
// one-pixel-per-thread kernel took ~4.2 ms there.
//
// What the design does about it. Two routes, chosen by the wrapper from
// the halo's bytes against the shared-memory limit alone:
//   * TILE (the halo fits: every radius up to ~5 km at any azimuth, the
//     500 m and 2000 m of the main path among them). One block computes a
//     kTileH x kTileW tile of outputs. It stages the DEM its rays reach in
//     dynamic shared memory: the tile grown by the bounding box of the ray
//     offsets, [min oy, max oy] x [min ox, max ox], worked out by the
//     wrapper from the signed offsets (one-sided for one azimuth, and
//     mirrored when the grid's dy is negative), one warp per row with
//     16-byte loads, with NaN for cells outside the grid, so the inner loop
//     has no bounds checks and reads exactly what sx_max_ratio reads. The ray table is staged there once per
//     block, each ray as one offset into the tile (its reads are
//     broadcasts). Each thread computes 8 outputs (4 rows x 2 columns 32
//     apart), so one table read feeds 8 fmaxes and every warp load is 32
//     consecutive words.
//   * GLOBAL (the halo does not fit: large radii at oblique azimuths). One
//     thread per output pixel in 64 x 4 blocks reads through L1/L2 with
//     sx_max_ratio's bounds checks.
// Both routes run sx_max_ratio's operations in its order (sx_rays.cuh), so
// their planes are bit-equal to each other and to sx_sweep.cu's. The ray
// tables are runtime data, so one build serves every radius and azimuth.

#include "sx_rays.cuh"
#include "tile_stage.cuh"

namespace {

// The tile route's output tile and block; ops/cuda/sx_block.py mirrors the
// tile to size the shared memory and choose the route.
constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kCols = kTileW / kThreadsX;  // 2
constexpr int kRows = kTileH / kThreadsY;  // 4

__global__ void sx_block_kernel(const float* __restrict__ dem,
                                const int* __restrict__ offsets,
                                const int* __restrict__ group_ptr,
                                const float* __restrict__ inv, int n_groups,
                                float* __restrict__ out, int h, int w,
                                int border, float height, int zero_border) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < h;
       y += gridDim.y * blockDim.y) {
    const int64_t idx = static_cast<int64_t>(y) * w + x;
    if (zero_border && !sx_interior(y, x, h, w, border)) {
      out[idx] = 0.0f;
      continue;
    }
    const float base = dem[idx] + height;
    out[idx] = sx_degrees(sx_max_ratio(dem, offsets, group_ptr, inv, 0,
                                       n_groups, h, w, y, x, base));
  }
}

// Tile route. Block (tx, ty) computes outputs y0 .. y0 + kTileH - 1,
// x0 .. x0 + kTileW - 1. Staged row i, column j holds dem[y0 + oy0 + i,
// x0 + ox0 + j] (NaN outside the grid), i < sh = kTileH + max oy - oy0,
// j < sw = kTileW + max ox - ox0. Shared memory: the rays' tile offsets
// (n_rays ints), group_ptr (n_groups + 1 ints), inv (n_groups floats),
// padded to 16 bytes, then the staged halo tile.
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
sx_block_tile(const float* __restrict__ dem, const int* __restrict__ offsets,
              const int* __restrict__ group_ptr, const float* __restrict__ inv,
              int n_rays, int n_groups, float* __restrict__ out, int h, int w,
              int oy0, int ox0, int sh, int sw, int border, float height,
              int zero_border, int tiles_y, int vec) {
  extern __shared__ __align__(16) float smem[];
  int* soff = reinterpret_cast<int*>(smem);
  int* gp = soff + n_rays;
  float* ig = reinterpret_cast<float*>(gp + n_groups + 1);
  float* tile = smem + ((2 * n_groups + 1 + n_rays + 3) & ~3);
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int x0 = blockIdx.x * kTileW;

  for (int k = tid; k < n_rays; k += kThreadsX * kThreadsY) {
    soff[k] = (offsets[2 * k] - oy0) * sw + (offsets[2 * k + 1] - ox0);
  }
  for (int g = tid; g <= n_groups; g += kThreadsX * kThreadsY) {
    gp[g] = group_ptr[g];
    if (g < n_groups) ig[g] = inv[g];
  }

  for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
    const int y0 = ty * kTileH;
    __syncthreads();  // the ray table is in place; the previous tile is done
    // stage: one warp per halo row, NaN for the cells outside the grid
    for (int i = warp; i < sh; i += kThreadsY) {
      const int ys = y0 + oy0 + i;
      const float* src =
          (ys >= 0 && ys < h) ? dem + static_cast<int64_t>(ys) * w : nullptr;
      stage_row(src, w, x0 + ox0, sw, tile + i * sw, lane, vec != 0, NAN);
    }
    __syncthreads();

    int at[kRows * kCols];
    float base[kRows * kCols];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int yl = warp + j * kThreadsY;
        const int xl = lane + c * kThreadsX;
        const int y = y0 + yl;
        const int x = x0 + xl;
        at[j * kCols + c] = yl * sw + xl;
        base[j * kCols + c] =
            (y < h && x < w) ? dem[static_cast<int64_t>(y) * w + x] + height : 0.0f;
      }
    }
    float acc[kRows * kCols];
    sx_max_ratio_tile<kRows * kCols>(tile, soff, gp, ig, n_groups, at, base, acc);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int y = y0 + warp + j * kThreadsY;
        const int x = x0 + lane + c * kThreadsX;
        if (y >= h || x >= w) continue;
        const int64_t idx = static_cast<int64_t>(y) * w + x;
        out[idx] = (zero_border && !sx_interior(y, x, h, w, border))
                       ? 0.0f
                       : sx_degrees(acc[j * kCols + c]);
      }
    }
  }
}

}  // namespace

// Global route. Returns cudaGetLastError().
extern "C" int sx_block_forward(const float* dem, const int* offsets,
                                const int* group_ptr, const float* inv,
                                int n_groups, float* out, int h, int w,
                                int border, float height, int zero_border,
                                cudaStream_t stream) {
  if (h > 0 && w > 0) {
    const dim3 threads(64, 4);
    const int gy = (h + threads.y - 1) / threads.y;
    const dim3 grid((w + threads.x - 1) / threads.x, gy < 65535 ? gy : 65535);
    sx_block_kernel<<<grid, threads, 0, stream>>>(dem, offsets, group_ptr, inv,
                                                  n_groups, out, h, w, border,
                                                  height, zero_border);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tile route, with the halo box (oy0, ox0, sh, sw) and `smem_bytes` of
// dynamic shared memory from the wrapper (tile_smem_bytes); `vec` = 1 when
// the DEM and its rows are 16-byte aligned. Returns cudaGetLastError(), so
// a launch refused for its shared memory reaches the wrapper.
extern "C" int sx_block_tile_forward(const float* dem, const int* offsets,
                                     const int* group_ptr, const float* inv,
                                     int n_rays, int n_groups, float* out,
                                     int h, int w, int oy0, int ox0, int sh,
                                     int sw, int border, float height,
                                     int zero_border, int smem_bytes, int vec,
                                     cudaStream_t stream) {
  if (h <= 0 || w <= 0) return 0;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sx_block_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_y = (h + kTileH - 1) / kTileH;
  const dim3 grid((w + kTileW - 1) / kTileW, tiles_y < 65535 ? tiles_y : 65535);
  sx_block_tile<<<grid, dim3(kThreadsX, kThreadsY), smem_bytes, stream>>>(
      dem, offsets, group_ptr, inv, n_rays, n_groups, out, h, w, oy0, ox0, sh,
      sw, border, height, zero_border, tiles_y, vec);
  return static_cast<int>(cudaGetLastError());
}
