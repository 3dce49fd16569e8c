// Sx for a whole fan of azimuths, (H, W) -> (A, H, W), for Hopper (sm_90a).
//
// Two kernels, both computing per (azimuth a, pixel p) what sx_block.cu
// computes for one azimuth, through the same per-pixel code (sx_rays.cuh)
// and the same 1/distance groups, so their planes equal sx_block's bit for
// bit. The fan's tables are runtime data, flattened over azimuths: azimuth a
// owns groups az_ptr[a] .. az_ptr[a + 1] - 1 of group_ptr / inv, whose rays
// are (oy, ox) pairs in `offsets`.
//
// * sx_sweep replaces topo_descriptors_tpu/ops/pallas/sx_block.py::
//   _sx_sweep_kernel (runtime tables, grid (gy, gx, A)) with the epilogue of
//   sx_sweep_pallas (sx_block.py:566-574): one azimuth per block.
// * sx_fan replaces _sx_fan_kernel (one halo window read once for every
//   azimuth of a group) with the epilogue of sx_fan_pallas
//   (sx_block.py:446-455): one group of azimuths per block (tile route), or
//   one azimuth per block (chunked route).
//
// What bounds them on the H100: instruction issue and shared-memory loads,
// not device memory. Per (output, ray) the inner loop spends one shared load
// of the staged DEM and one fmax, and per (output, distance group) a
// subtraction, a product and an fmax; most groups hold one ray (14,076
// groups for 15,136 rays over the 36-azimuth fan at r = 2000 m on 30 m), so
// the group's cost is paid per ray. Device memory sees the DEM about once
// (the blocks of one output tile run together, so their halos hit L2) and
// the A planes once: at 8192^2 the 36 planes are 9.7 GB, ~2.9 ms.
//
// What the design does about it. Two routes per kernel, chosen by the
// wrapper (ops/cuda/sx_sweep.py::route) from the shared-memory bytes alone:
//   * TILE (every radius whose boxes fit in 227 KB: the 200 m, 500 m and
//     2000 m fans). One block computes a kTileH x kTileW output tile, 8
//     outputs per thread, from the DEM staged in dynamic shared memory
//     (stage_row: one warp per row, 16-byte loads, NaN outside the grid),
//     so the ray loop has no bounds checks, and runs sx_max_ratio_tile as
//     sx_block_tile does.
//     - sx_sweep_tile: block = (output tile, azimuth), the azimuth fastest,
//       so the A blocks of a tile share its halo in L2 instead of A passes
//       over a DEM larger than L2. It stages its azimuth's one-sided wedge
//       (the signed box of sx_block.halo_box) and, as sx_block_tile does,
//       the azimuth's rays as offsets into it with its group_ptr and inv.
//       Shared memory is sized for the largest azimuth (40.7 KB at 2000 m).
//     - sx_fan_tile: block = (output tile, group of consecutive azimuths),
//       the group fastest. It stages the union box of its group once and
//       loops over the group's azimuths, one plane each. Each azimuth's
//       table (its rays, already turned by the wrapper into offsets into
//       the group's box, with group_ptr and inv) streams through a double
//       shared buffer, one barrier per azimuth: on the H100 this measured
//       faster than reading the tables through the read-only path (every
//       lane of a warp on the same entry, a broadcast from L1), whose loads
//       cost more than shared ones. The groups keep
//       a block's box and buffers within a quarter of the SM's shared
//       memory, so that four blocks fit on an SM, as they do for the sweep
//       (the whole 2000 m disc, 125.6 KB, would allow one): the 2000 m fan
//       takes a few groups, the 200 m and 500 m fans one.
//     Both tile kernels are held to 64 registers, so that four blocks of
//     256 threads fit on an SM; with more registers and fewer blocks both
//     measured slower.
//   * GLOBAL (sx_sweep only, a box above 227 KB, e.g. the 10 km fan): the
//     first design, kept as it was. sx_sweep_kernel has one thread per
//     (pixel, azimuth), the azimuth on the grid's z axis, reading every ray
//     through L1/L2 with sx_max_ratio's bounds checks.
//   * CHUNKED (sx_fan, a box above 227 KB): block = (output tile, azimuth),
//     the azimuth fastest as in sx_sweep_tile, so a tile's blocks find its
//     DEM in L2. Each block runs sx_block's chunked route on its azimuth's
//     plan (sx_chunked.cuh): the rays stream through two shared-memory
//     stages one distance band at a time, the running maxima kept in
//     registers. A block per group of azimuths could stage one union box per
//     band for the group, but staging is ~1% of the work at 10 km (~45
//     staged values per output and azimuth against 3381-4420 ray reads),
//     so it could save little, at the price of a group's accumulators.
// Output indices are 64-bit (36 x 8192^2 > 2^31), and every grid loops, so
// any size works. The TPU kernels' Mosaic workarounds (the (column, oy mod
// 8) CSR, the FAN_RAY_BUDGET groups, (8, 128) window rounding,
// double-buffered DMA) have no counterpart here.

#include "sx_chunked.cuh"
#include "sx_rays.cuh"
#include "tile_stage.cuh"

namespace {

// The tile routes' output tile and block, as sx_block.cu's;
// ops/cuda/sx_sweep.py mirrors the tile to size the shared memory.
constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kCols = kTileW / kThreadsX;  // 2
constexpr int kRows = kTileH / kThreadsY;  // 4
constexpr int kOut = kRows * kCols;        // outputs per thread
constexpr int kBlocksPerSm = 4;            // 64 registers per thread at most
constexpr int64_t kMaxGrid = 1 << 30;      // blocks per launch; larger grids loop

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

// Stages DEM rows y0 + oy0 .. y0 + oy0 + sh - 1, columns x0 + ox0 ..
// x0 + ox0 + sw - 1 into tile (row stride sw), NaN outside the grid.
__device__ __forceinline__ void stage_box(const float* __restrict__ dem, int h,
                                          int w, int y0, int x0, int oy0,
                                          int ox0, int sh, int sw,
                                          float* tile, bool vec) {
  for (int i = threadIdx.y; i < sh; i += kThreadsY) {
    const int ys = y0 + oy0 + i;
    const float* src =
        (ys >= 0 && ys < h) ? dem + static_cast<int64_t>(ys) * w : nullptr;
    stage_row(src, w, x0 + ox0, sw, tile + i * sw, threadIdx.x, vec, NAN);
  }
}

// The thread's outputs: (y0 + threadIdx.y + j * kThreadsY,
// x0 + threadIdx.x + c * kThreadsX) is output j * kCols + c. Sets each one's
// staged-tile index (the cell of ray offset (oy0, ox0)) and dem + height.
__device__ __forceinline__ void tile_outputs(const float* __restrict__ dem,
                                             int h, int w, int y0, int x0,
                                             int sw, float height,
                                             int (&at)[kOut],
                                             float (&base)[kOut]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int yl = threadIdx.y + j * kThreadsY;
      const int xl = threadIdx.x + c * kThreadsX;
      const int y = y0 + yl;
      const int x = x0 + xl;
      at[j * kCols + c] = yl * sw + xl;
      base[j * kCols + c] =
          (y < h && x < w) ? dem[static_cast<int64_t>(y) * w + x] + height : 0.0f;
    }
  }
}

__device__ __forceinline__ void write_outputs(float* __restrict__ out_a,
                                              const float (&acc)[kOut], int h,
                                              int w, int y0, int x0,
                                              int border, int zero_border) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int y = y0 + threadIdx.y + j * kThreadsY;
      const int x = x0 + threadIdx.x + c * kThreadsX;
      if (y >= h || x >= w) continue;
      out_a[static_cast<int64_t>(y) * w + x] =
          (zero_border && !sx_interior(y, x, h, w, border))
              ? 0.0f
              : sx_degrees(acc[j * kCols + c]);
    }
  }
}

// Sweep tile route. Block index b = tile * n_az + a. `boxes` holds, per
// azimuth, (oy0, ox0, sh, sw): its staged tile covers DEM rows y0 + oy0 ..
// y0 + oy0 + sh - 1 and columns x0 + ox0 .. x0 + ox0 + sw - 1. Shared
// memory: the azimuth's rays as tile offsets (n_rays ints), its group_ptr
// rebased to 0 (n_groups + 1 ints) and inv (n_groups floats), padded to 16
// bytes, then the staged tile.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sx_sweep_tile(const float* __restrict__ dem, const int* __restrict__ offsets,
              const int* __restrict__ group_ptr, const float* __restrict__ inv,
              const int* __restrict__ az_ptr, const int* __restrict__ boxes,
              int n_az, float* __restrict__ out, int h, int w, int border,
              float height, int zero_border, int tiles_x, int64_t n_blocks,
              int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const int a = static_cast<int>(b % n_az);
    const int64_t t = b / n_az;
    const int y0 = static_cast<int>(t / tiles_x) * kTileH;
    const int x0 = static_cast<int>(t % tiles_x) * kTileW;
    const int g0 = az_ptr[a];
    const int n_groups = az_ptr[a + 1] - g0;
    const int k0 = group_ptr[g0];
    const int n_rays = group_ptr[g0 + n_groups] - k0;
    const int oy0 = boxes[4 * a];
    const int ox0 = boxes[4 * a + 1];
    const int sh = boxes[4 * a + 2];
    const int sw = boxes[4 * a + 3];
    int* soff = reinterpret_cast<int*>(smem);
    int* gp = soff + n_rays;
    float* ig = reinterpret_cast<float*>(gp + n_groups + 1);
    float* tile = smem + ((2 * n_groups + 1 + n_rays + 3) & ~3);

    __syncthreads();  // the previous block's tile and table are done with
    for (int k = tid; k < n_rays; k += kThreads) {
      const int kk = k0 + k;
      soff[k] = (offsets[2 * kk] - oy0) * sw + (offsets[2 * kk + 1] - ox0);
    }
    for (int g = tid; g <= n_groups; g += kThreads) {
      gp[g] = group_ptr[g0 + g] - k0;
      if (g < n_groups) ig[g] = inv[g0 + g];
    }
    stage_box(dem, h, w, y0, x0, oy0, ox0, sh, sw, tile, vec != 0);
    __syncthreads();

    int at[kOut];
    float base[kOut];
    tile_outputs(dem, h, w, y0, x0, sw, height, at, base);
    float acc[kOut];
    sx_max_ratio_tile<kOut>(tile, soff, gp, ig, n_groups, at, base, acc);
    write_outputs(out + a * plane, acc, h, w, y0, x0, border, zero_border);
  }
}

// Fan tile route. Block index b = tile * n_fan + j. `fan` holds, per group
// j of azimuths, (a0, a1, oy0, ox0, sh, sw): azimuths a0 .. a1 - 1 and the
// staged tile of their union box. `soff` holds each ray as an offset into
// its group's staged tile (indexed as `offsets` is). Shared memory: two
// table buffers of table_words each (an azimuth's soff, its group_ptr
// rebased to 0 and inv, as in sx_sweep_tile), then the staged tile.
// Azimuth a's table goes to buffer a & 1: the barrier after staging it
// also tells that every thread is done with azimuth a - 2, the buffer's
// last user, so one barrier per azimuth suffices.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sx_fan_tile(const float* __restrict__ dem, const int* __restrict__ soff,
            const int* __restrict__ group_ptr, const float* __restrict__ inv,
            const int* __restrict__ az_ptr, const int* __restrict__ fan,
            int n_fan, float* __restrict__ out, int h, int w, int border,
            float height, int zero_border, int tiles_x, int64_t n_blocks,
            int vec, int table_words) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  float* tile = smem + 2 * table_words;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const int* f = fan + 6 * static_cast<int>(b % n_fan);
    const int64_t t = b / n_fan;
    const int y0 = static_cast<int>(t / tiles_x) * kTileH;
    const int x0 = static_cast<int>(t % tiles_x) * kTileW;
    const int sw = f[5];

    __syncthreads();  // the previous block's tile and tables are done with
    stage_box(dem, h, w, y0, x0, f[2], f[3], f[4], sw, tile, vec != 0);
    int at[kOut];
    float base[kOut];
    tile_outputs(dem, h, w, y0, x0, sw, height, at, base);
    for (int a = f[0]; a < f[1]; ++a) {
      const int g0 = az_ptr[a];
      const int n_groups = az_ptr[a + 1] - g0;
      const int k0 = group_ptr[g0];
      const int n_rays = group_ptr[g0 + n_groups] - k0;
      int* s = reinterpret_cast<int*>(smem + (a & 1) * table_words);
      int* gp = s + n_rays;
      float* ig = reinterpret_cast<float*>(gp + n_groups + 1);
      for (int k = tid; k < n_rays; k += kThreads) s[k] = soff[k0 + k];
      for (int g = tid; g <= n_groups; g += kThreads) {
        gp[g] = group_ptr[g0 + g] - k0;
        if (g < n_groups) ig[g] = inv[g0 + g];
      }
      __syncthreads();  // this table (and, first time round, the tile) is in place
      float acc[kOut];
      sx_max_ratio_tile<kOut>(tile, s, gp, ig, n_groups, at, base, acc);
      write_outputs(out + a * plane, acc, h, w, y0, x0, border, zero_border);
    }
  }
}

// Fan chunked route. Block index b = tile * n_az + a: azimuth a's plane of
// the tile, from azimuth a's chunks of the plan (sx_chunked.cuh).
__global__ void __launch_bounds__(kThreads)
sx_fan_chunked(const float* __restrict__ dem, const int* __restrict__ plan,
               int n_az, int stage_floats, float* __restrict__ out, int h,
               int w, int border, float height, int zero_border, int tiles_x,
               int64_t n_blocks) {
  extern __shared__ __align__(16) float smem[];
  const sx_chunked::Chunk* chunks = sx_chunked::chunks_of(plan, n_az);
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const int a = static_cast<int>(b % n_az);
    const int64_t t = b / n_az;
    __syncthreads();  // the previous block is done with both stages
    sx_chunked::chunked_tile(dem, plan, chunks, __ldg(&plan[a]), __ldg(&plan[a + 1]),
                             stage_floats, smem, out + a * plane, h, w,
                             static_cast<int>(t / tiles_x) * kTileH,
                             static_cast<int>(t % tiles_x) * kTileW, border,
                             height, zero_border);
  }
}

dim3 pixel_grid(int h, int w, dim3 threads) {
  const int gy = (h + threads.y - 1) / threads.y;
  return dim3((w + threads.x - 1) / threads.x, gy < 65535 ? gy : 65535);
}

// Sets the kernel's dynamic shared memory limit where it exceeds the
// default 48 KB; then launches a 1-D grid of kThreadsX x kThreadsY blocks
// over n_blocks block indices.
template <typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int64_t n_blocks, int smem_bytes,
                 cudaStream_t stream, Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid =
      static_cast<unsigned>(n_blocks < kMaxGrid ? n_blocks : kMaxGrid);
  kernel<<<grid, dim3(kThreadsX, kThreadsY), smem_bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Global route of sx_sweep. Returns cudaGetLastError().
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

// Tile routes, with the per-azimuth boxes (sweep) or the azimuth groups
// and the table buffers' size (fan), and `smem_bytes` of dynamic shared
// memory from the wrapper; `vec` = 1 when the DEM and its rows are 16-byte
// aligned. Each returns
// cudaGetLastError(), so a launch refused for its shared memory reaches the
// wrapper.
extern "C" int sx_sweep_tile_forward(const float* dem, const int* offsets,
                                     const int* group_ptr, const float* inv,
                                     const int* az_ptr, const int* boxes,
                                     int n_az, float* out, int h, int w,
                                     int border, float height, int zero_border,
                                     int smem_bytes, int vec,
                                     cudaStream_t stream) {
  if (h <= 0 || w <= 0 || n_az <= 0) return 0;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int64_t n_blocks =
      static_cast<int64_t>((h + kTileH - 1) / kTileH) * tiles_x * n_az;
  return launch_tiles(sx_sweep_tile, n_blocks, smem_bytes, stream, dem,
                      offsets, group_ptr, inv, az_ptr, boxes, n_az, out, h, w,
                      border, height, zero_border, tiles_x, n_blocks, vec);
}

extern "C" int sx_fan_tile_forward(const float* dem, const int* soff,
                                   const int* group_ptr, const float* inv,
                                   const int* az_ptr, const int* fan,
                                   int n_fan, float* out, int h, int w,
                                   int border, float height, int zero_border,
                                   int smem_bytes, int vec, int table_words,
                                   cudaStream_t stream) {
  if (h <= 0 || w <= 0 || n_fan <= 0) return 0;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int64_t n_blocks =
      static_cast<int64_t>((h + kTileH - 1) / kTileH) * tiles_x * n_fan;
  return launch_tiles(sx_fan_tile, n_blocks, smem_bytes, stream, dem, soff,
                      group_ptr, inv, az_ptr, fan, n_fan, out, h, w, border,
                      height, zero_border, tiles_x, n_blocks, vec, table_words);
}

// Chunked route of sx_fan, with the plan of its n_az azimuths and their
// stage size from the wrapper (ops/cuda/sx_block.py::chunk_plan). Returns
// cudaGetLastError(), or the error of raising the shared-memory limit.
extern "C" int sx_fan_chunked_forward(const float* dem, const int* plan,
                                      int n_az, int stage_floats, float* out,
                                      int h, int w, int border, float height,
                                      int zero_border, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || n_az <= 0) return 0;
  const int err = sx_chunked::set_stage_smem(sx_fan_chunked, stage_floats);
  if (err != 0) return err;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int64_t n_blocks =
      static_cast<int64_t>((h + kTileH - 1) / kTileH) * tiles_x * n_az;
  const unsigned grid =
      static_cast<unsigned>(n_blocks < kMaxGrid ? n_blocks : kMaxGrid);
  const int smem_bytes = 2 * stage_floats * static_cast<int>(sizeof(float));
  sx_fan_chunked<<<grid, dim3(kThreadsX, kThreadsY), smem_bytes, stream>>>(
      dem, plan, n_az, stage_floats, out, h, w, border, height, zero_border,
      tiles_x, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
