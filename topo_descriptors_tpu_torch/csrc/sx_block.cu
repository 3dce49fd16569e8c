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
// What bounds it on the H100: bytes and load instructions. Each pixel reads
// K deduplicated ray pixels (32 at r = 500 m, 464 at r = 2000 m on 30 m)
// and does one fmax per read; there is no matmul.
// What the design does about it: one thread per output pixel in 64 x 4
// blocks, so neighbouring threads read neighbouring columns of the same
// rows and a block's reads of the (64 + 2b) x (4 + 2b) halo are served by
// L1/L2; device memory sees about one read of the DEM and one write of the
// output. The ray tables are runtime data, so one build serves every radius
// and azimuth. A shared-memory halo tile is left for a later change.

#include "sx_rays.cuh"

namespace {

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

}  // namespace

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
