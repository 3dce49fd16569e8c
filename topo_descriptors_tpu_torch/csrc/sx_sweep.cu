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
//   sx_sweep_pallas (sx_block.py:566-574): one azimuth per block (tile
//   route), or one range of an azimuth's distance bands per block (chunked
//   route).
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
//   * CHUNKED (a box above 227 KB, e.g. the 10 km fan), one kernel for
//     both: sx_sweep_chunked, block = (output tile, work item), the item
//     fastest as in sx_sweep_tile, so a tile's blocks find its DEM in L2. A
//     work item is a range of one azimuth's chunks of the host plan
//     (ops/cuda/sx_block.py::chunk_plan) that starts and ends distance
//     groups; its block runs sx_block's chunked route over that range
//     (sx_chunked.cuh): the rays stream through two shared-memory stages one
//     distance band at a time, the running maxima kept in registers.
//     - sx_fan: one item per azimuth, its planes written directly. A block
//       per group of azimuths could stage one union box per band for the
//       group, but staging is ~1% of the work at 10 km (~45 staged values
//       per output and azimuth against 3381-4420 ray reads), so it could
//       save little, at the price of a group's accumulators.
//     - sx_sweep: the items of the host's split plan
//       (ops/cuda/sx_block.py::split_plan). Where the grid leaves SMs idle
//       (one or two azimuths at 10 km on 900 x 1440: 104 tiles read rays,
//       so one lone block on each of 104 of the 132 SMs, at half the per-SM
//       rate of three blocks), the plan cuts an azimuth's chunks into S
//       ranges, so S blocks share its tile; each writes its maxima to a
//       workspace plane that holds only the box of the tiles that read rays
//       (ops/cuda/sx_sweep.py::workspace_shape), and sx_sweep_combine folds
//       the S planes (an exact fmax, sx_chunked.cuh), takes the atan and
//       zeroes the border. With S = 1 for every azimuth (a grid that fills
//       the SMs: the 36-azimuth fan, 8192^2) it runs as sx_fan does.
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
constexpr int kCombineThreads = 256;
constexpr int64_t kCombineGrid = 4096;     // sx_sweep_combine's blocks at most; they loop

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

// Chunked route. Block index b = tile * n_items + i: work item i,
// items[i] = (azimuth a, first chunk c0, end chunk c1, split s). Without
// kRaw (one item per azimuth) the block writes azimuth a's plane of `out`;
// with kRaw its running maxima to plane s * n_az + a of the workspace
// `out`, whose planes hold the box `ws` of the grid (chunked_tile), for
// sx_sweep_combine.
template <bool kRaw>
__global__ void __launch_bounds__(kThreads)
sx_sweep_chunked(const float* __restrict__ dem, const int* __restrict__ plan,
                 const int4* __restrict__ items, int n_items, int n_az,
                 int stage_floats, float* __restrict__ out, int4 ws, int h,
                 int w, int border, float height, int zero_border, int tiles_x,
                 int64_t n_blocks) {
  extern __shared__ __align__(16) float smem[];
  const sx_chunked::Chunk* chunks = sx_chunked::chunks_of(plan, n_az);
  const int64_t plane = kRaw ? static_cast<int64_t>(ws.z) * ws.w
                             : static_cast<int64_t>(h) * w;
  for (int64_t b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const int4 item = __ldg(&items[b % n_items]);
    const int64_t t = b / n_items;
    __syncthreads();  // the previous block is done with both stages
    sx_chunked::chunked_tile<kRaw>(
        dem, plan, chunks, item.y, item.z, stage_floats, smem,
        out + (static_cast<int64_t>(item.w) * n_az + item.x) * plane, h, w,
        static_cast<int>(t / tiles_x) * kTileH,
        static_cast<int>(t % tiles_x) * kTileW, border, height, zero_border,
        ws);
  }
}

// The split plan's fold: out[a, y, x] is the Sx of the fmax, from -inf and
// in split order, of workspace planes s * n_az + a, s < splits[a], at (y, x)
// of their box `ws`; 0 in the zero border, which holds every output outside
// the box and whose wholly-border tiles left the workspace unwritten.
__global__ void __launch_bounds__(kCombineThreads)
sx_sweep_combine(const float* __restrict__ wsp, const int* __restrict__ splits,
                 int n_az, int4 ws, float* __restrict__ out, int h, int w,
                 int border, int zero_border) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t box = static_cast<int64_t>(ws.z) * ws.w;
  const int64_t total = plane * n_az;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int a = static_cast<int>(i / plane);
    const int64_t p = i - a * plane;
    const int y = static_cast<int>(p / w);
    const int x = static_cast<int>(p - static_cast<int64_t>(y) * w);
    if (zero_border && !sx_interior(y, x, h, w, border)) {
      out[i] = 0.0f;
      continue;
    }
    const int64_t q = static_cast<int64_t>(y - ws.x) * ws.w + x - ws.y;
    float m = -INFINITY;
    const int n = __ldg(&splits[a]);
    for (int s = 0; s < n; ++s) {
      m = fmaxf(m, wsp[(static_cast<int64_t>(s) * n_az + a) * box + q]);
    }
    out[i] = sx_degrees(m);
  }
}

}  // namespace

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

// Chunked route of both kernels, with the plan of its n_az azimuths and its
// stage size (ops/cuda/sx_block.py::chunk_plan) and n_items work items, four
// ints each, 16-byte aligned (split_plan), from the wrapper. `splits` is
// null where every azimuth is one item: the blocks then write `out`. Else
// it holds each azimuth's items, the blocks write their maxima to the
// workspace `ws`, (max items, n_az, ws_h, ws_w) floats over rows ws_y0 ..
// and columns ws_x0 .. of the grid (every tile that reads rays lies
// there), and a second kernel folds it into `out`. Returns
// cudaGetLastError(), or the error of raising the shared-memory limit.
extern "C" int sx_sweep_chunked_forward(const float* dem, const int* plan,
                                        const int* items, int n_items, int n_az,
                                        int stage_floats, float* out, float* ws,
                                        const int* splits, int ws_y0, int ws_x0,
                                        int ws_h, int ws_w, int h, int w,
                                        int border, float height,
                                        int zero_border, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || n_az <= 0) return 0;
  if (n_items < n_az) return static_cast<int>(cudaErrorInvalidValue);
  const bool raw = splits != nullptr;
  const auto kernel = raw ? &sx_sweep_chunked<true> : &sx_sweep_chunked<false>;
  const int err = sx_chunked::set_stage_smem(kernel, stage_floats);
  if (err != 0) return err;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int64_t n_blocks =
      static_cast<int64_t>((h + kTileH - 1) / kTileH) * tiles_x * n_items;
  const unsigned grid =
      static_cast<unsigned>(n_blocks < kMaxGrid ? n_blocks : kMaxGrid);
  const int smem_bytes = 2 * stage_floats * static_cast<int>(sizeof(float));
  const int4 box = make_int4(ws_y0, ws_x0, ws_h, ws_w);
  kernel<<<grid, dim3(kThreadsX, kThreadsY), smem_bytes, stream>>>(
      dem, plan, reinterpret_cast<const int4*>(items), n_items, n_az,
      stage_floats, raw ? ws : out, box, h, w, border, height, zero_border,
      tiles_x, n_blocks);
  const cudaError_t launched = cudaGetLastError();
  if (!raw || launched != cudaSuccess) return static_cast<int>(launched);
  const int64_t outputs = static_cast<int64_t>(h) * w * n_az;
  const int64_t blocks = (outputs + kCombineThreads - 1) / kCombineThreads;
  sx_sweep_combine<<<static_cast<unsigned>(blocks < kCombineGrid ? blocks : kCombineGrid),
                     kCombineThreads, 0, stream>>>(ws, splits, n_az, box, out, h, w,
                                                   border, zero_border);
  return static_cast<int>(cudaGetLastError());
}
