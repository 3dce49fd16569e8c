// Sx for a whole fan of azimuths, (H, W) -> (A, H, W), for Hopper (sm_90a).
//
// Two kernels, both computing per (azimuth a, pixel p) what sx_block.cu
// computes for one azimuth, through the same per-pixel code (sx_rays.cuh)
// and the same 1/distance groups, so their planes equal sx_block's bit for
// bit. The fan's tables are runtime data, flattened over azimuths: azimuth a
// owns groups az_ptr[a] .. az_ptr[a + 1] - 1 of group_ptr / inv, whose rays
// are (oy, ox) pairs in `offsets`.
//
// * sx_sweep_kernel replaces topo_descriptors_tpu/ops/pallas/sx_block.py::
//   _sx_sweep_kernel (runtime tables, grid (gy, gx, A)) with the epilogue of
//   sx_sweep_pallas (sx_block.py:566-574): one thread per (pixel, azimuth),
//   the azimuth on the grid's z axis, so one launch serves any fan.
// * sx_fan_kernel replaces _sx_fan_kernel (each block's halo window read
//   once for every azimuth of a group) with the epilogue of sx_fan_pallas
//   (sx_block.py:446-455): one thread per pixel loads dem[p] + height once
//   and loops over every azimuth, writing the A planes; the rays of
//   neighbouring azimuths overlap, so they hit the same L1 lines.
//
// What bounds them on the H100: load instructions served by L1/L2, as for
// sx_block: one bounds-checked read and one fmax per deduplicated ray per
// (pixel, azimuth), 296 rays over the 36-azimuth fan at r = 200 m and
// 15,136 at r = 2000 m on 30 m. Device memory sees the DEM about once and
// the A output planes once. The TPU kernels' Mosaic workarounds (the
// (column, oy mod 8) CSR, the FAN_RAY_BUDGET azimuth groups, multiple
// accumulators, (8, 128) window rounding, double-buffered DMA) have no
// counterpart here. Output indices are 64-bit (36 x 8192^2 > 2^31) and the
// grid's y and z dimensions loop, so any size works. A shared-memory halo
// tile is left for a later change.

#include "sx_rays.cuh"

namespace {

__global__ void sx_sweep_kernel(const float* __restrict__ dem,
                                const int* __restrict__ offsets,
                                const int* __restrict__ group_ptr,
                                const float* __restrict__ inv,
                                const int* __restrict__ az_ptr, int n_az,
                                float* __restrict__ out, int h, int w,
                                int border, float height, int zero_border) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int a = blockIdx.z; a < n_az; a += gridDim.z) {
    const int g0 = az_ptr[a];
    const int g1 = az_ptr[a + 1];
    float* __restrict__ out_a = out + a * plane;
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < h;
         y += gridDim.y * blockDim.y) {
      const int64_t idx = static_cast<int64_t>(y) * w + x;
      if (zero_border && !sx_interior(y, x, h, w, border)) {
        out_a[idx] = 0.0f;
        continue;
      }
      const float base = dem[idx] + height;
      out_a[idx] = sx_degrees(sx_max_ratio(dem, offsets, group_ptr, inv, g0,
                                           g1, h, w, y, x, base));
    }
  }
}

__global__ void sx_fan_kernel(const float* __restrict__ dem,
                              const int* __restrict__ offsets,
                              const int* __restrict__ group_ptr,
                              const float* __restrict__ inv,
                              const int* __restrict__ az_ptr, int n_az,
                              float* __restrict__ out, int h, int w,
                              int border, float height, int zero_border) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < h;
       y += gridDim.y * blockDim.y) {
    const int64_t idx = static_cast<int64_t>(y) * w + x;
    if (zero_border && !sx_interior(y, x, h, w, border)) {
      for (int a = 0; a < n_az; ++a) out[a * plane + idx] = 0.0f;
      continue;
    }
    const float base = dem[idx] + height;
    for (int a = 0; a < n_az; ++a) {
      out[a * plane + idx] =
          sx_degrees(sx_max_ratio(dem, offsets, group_ptr, inv, az_ptr[a],
                                  az_ptr[a + 1], h, w, y, x, base));
    }
  }
}

dim3 pixel_grid(int h, int w, dim3 threads) {
  const int gy = (h + threads.y - 1) / threads.y;
  return dim3((w + threads.x - 1) / threads.x, gy < 65535 ? gy : 65535);
}

}  // namespace

extern "C" int sx_sweep_forward(const float* dem, const int* offsets,
                                const int* group_ptr, const float* inv,
                                const int* az_ptr, int n_az, float* out, int h,
                                int w, int border, float height,
                                int zero_border, cudaStream_t stream) {
  if (h > 0 && w > 0 && n_az > 0) {
    const dim3 threads(64, 4);
    dim3 grid = pixel_grid(h, w, threads);
    grid.z = n_az < 65535 ? n_az : 65535;
    sx_sweep_kernel<<<grid, threads, 0, stream>>>(
        dem, offsets, group_ptr, inv, az_ptr, n_az, out, h, w, border, height,
        zero_border);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sx_fan_forward(const float* dem, const int* offsets,
                              const int* group_ptr, const float* inv,
                              const int* az_ptr, int n_az, float* out, int h,
                              int w, int border, float height, int zero_border,
                              cudaStream_t stream) {
  if (h > 0 && w > 0 && n_az > 0) {
    const dim3 threads(64, 4);
    sx_fan_kernel<<<pixel_grid(h, w, threads), threads, 0, stream>>>(
        dem, offsets, group_ptr, inv, az_ptr, n_az, out, h, w, border, height,
        zero_border);
  }
  return static_cast<int>(cudaGetLastError());
}
