// The chunked route of the Sx kernels (sx_block.cu; sx_sweep.cu, whose
// sx_sweep_chunked serves sx_sweep and sx_fan): one block computes one
// azimuth's kTileH x kTileW output tile from a ray table too large for one
// staged halo, or (sx_sweep's split plan) the maxima of one range of that
// table's chunks.
//
// The TPU kernel stages the whole window of a block in VMEM and splits fans
// over CHUNK_RAYS rays into chunks of whole distance groups, combined by an
// fmax (topo_descriptors_tpu/ops/pallas/sx_block.py:592-617, 730-733). A
// Hopper block has 227 KB of shared memory, so the host plan
// (ops/cuda/sx_block.py::chunk_plan) cuts the azimuth's grouped rays, in
// group order (ascending 1/distance), into chunks whose own halo box and
// table fit one stage: each chunk is one distance band of the wedge, whose
// box is far smaller than the wedge's. The chunks stream through two stages
// of dynamic shared memory: chunk c + 1's table and box are copied in
// (cp.async, NaN stored by plain stores for cells outside the grid) while
// chunk c is summed. Each thread keeps its 8 outputs' running max (acc) in
// registers over all chunks, and the running max of a group that a chunk
// boundary splits (best) as well, so every output runs the max ratio's
// operations (sx_rays.cuh) in their order and its plane equals the tile
// route's bit for bit. One chunk is the tile route. A tile that lies wholly
// in the zero border writes its zeros and reads no ray.
//
// A range of chunks that starts a distance group (its first chunk has no
// kCarryIn) and ends one (its last has no kCarryOut) can run alone: no open
// group crosses its ends. sx_sweep's split plan cuts an azimuth's chunks into
// such ranges, one block each, and writes each range's maxima (kRaw) for a
// second kernel to fold: acc starts at -inf and fmaxf drops NaN, so no
// maximum is NaN, and the fmax over the ranges' maxima equals the one-pass
// maximum bit for bit, whatever the order.
//
// Plan layout (int32 words; ops/cuda/sx_block.py::chunk_plan): n_az + 1
// chunk pointers (azimuth a owns chunks plan[a] .. plan[a + 1] - 1), padded
// to 16 bytes; per chunk two int4 records (table word, rays, segments,
// flags) and (oy0, ox0, sh, sw); then each chunk's table, which is copied
// word for word to the front of its stage: the rays as offsets into the
// chunk's box, the segment pointers and the reciprocal distances. The box
// starts after the table, padded to 16 bytes, as in the tile route.

#pragma once

#include "sx_rays.cuh"
#include "tile_stage.cuh"

namespace sx_chunked {

constexpr int kTileW = 64;
constexpr int kTileH = 32;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kCols = kTileW / kThreadsX;  // 2
constexpr int kRows = kTileH / kThreadsY;  // 4
constexpr int kOut = kRows * kCols;        // outputs per thread
constexpr int kCarryIn = 1;   // the first segment goes on with the open group
constexpr int kCarryOut = 2;  // the last segment's group goes on in the next chunk

struct Chunk {
  int4 table;  // word of the table in the plan, rays, segments, flags
  int4 box;    // oy0, ox0, sh, sw
};

__device__ __forceinline__ const Chunk* chunks_of(const int* plan, int n_az) {
  return reinterpret_cast<const Chunk*>(plan + ((n_az + 1 + 3) & ~3));
}

// Issues (does not wait for) the copies of chunk `c` into the stage `buf`
// for the tile at (y0, x0).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ dem,
                                            const int* __restrict__ plan,
                                            const Chunk* chunks, int c, float* buf,
                                            int h, int w, int y0, int x0) {
  const int4 t = __ldg(&chunks[c].table);
  const int4 b = __ldg(&chunks[c].box);
  const int words = (t.y + 2 * t.z + 1 + 3) & ~3;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  for (int q = tid; q < words / 4; q += kThreads) {
    cp_async_16(buf + 4 * q, plan + t.x + 4 * q, true);
  }
  stage_box_async(dem, h, w, y0 + b.x, x0 + b.y, b.z, b.w, buf + words, tid,
                  kThreads, NAN);
}

// The block's tile at (y0, x0) of one azimuth, whose chunks are c0 .. c1 - 1
// of the plan; writes it to the (h, w) plane `out_a`: its Sx in degrees
// with the zero border. With kRaw it writes its running maxima (-inf where
// no candidate was valid) to a workspace plane that holds only the box
// `ws` = (first row, first column, rows, columns) of the grid, output (y, x)
// at (y - ws.x) * ws.w + x - ws.y, and nothing for a tile wholly in the
// zero border. Both stages (2 x stage_floats floats of `smem`) must be
// free: the caller's __syncthreads() says so.
template <bool kRaw>
__device__ __forceinline__ void chunked_tile(
    const float* __restrict__ dem, const int* __restrict__ plan,
    const Chunk* chunks, int c0, int c1, int stage_floats, float* smem,
    float* __restrict__ out_a, int h, int w, int y0, int x0, int border,
    float height, int zero_border, int4 ws = make_int4(0, 0, 0, 0)) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  if (zero_border && (y0 + kTileH <= border || y0 >= h - border ||
                      x0 + kTileW <= border || x0 >= w - border)) {
    // the whole tile lies in the zero border (86% of the 900 x 1440 grid at
    // 10 km): its outputs are 0 whatever the rays read
    if (kRaw) return;  // the folding kernel writes them
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int y = y0 + warp + j * kThreadsY;
        const int x = x0 + lane + c * kThreadsX;
        if (y < h && x < w) out_a[static_cast<int64_t>(y) * w + x] = 0.0f;
      }
    }
    return;
  }
  float base[kOut];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int y = y0 + warp + j * kThreadsY;
      const int x = x0 + lane + c * kThreadsX;
      base[j * kCols + c] =
          (y < h && x < w) ? dem[static_cast<int64_t>(y) * w + x] + height : 0.0f;
    }
  }
  float acc[kOut];
  float best[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    acc[r] = -INFINITY;
    best[r] = NAN;
  }
  if (c0 < c1) stage_chunk(dem, plan, chunks, c0, smem, h, w, y0, x0);
  cp_async_commit();
  for (int c = c0; c < c1; ++c) {
    const int k = c - c0;
    if (c + 1 < c1) {
      stage_chunk(dem, plan, chunks, c + 1, smem + ((k + 1) & 1) * stage_floats,
                  h, w, y0, x0);
    }
    cp_async_commit();
    cp_async_wait_group<1>();  // chunk c's copies have landed
    __syncthreads();           // ... for every thread, with its NaN stores
    const float* buf = smem + (k & 1) * stage_floats;
    const int4 t = __ldg(&chunks[c].table);
    const int sw = __ldg(&chunks[c].box).w;
    const int* soff = reinterpret_cast<const int*>(buf);
    const int* gp = soff + t.y;
    const float* ig = reinterpret_cast<const float*>(gp + t.z + 1);
    const float* tile = buf + ((t.y + 2 * t.z + 1 + 3) & ~3);
    int at[kOut];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        at[j * kCols + cc] = (warp + j * kThreadsY) * sw + lane + cc * kThreadsX;
      }
    }
    sx_max_ratio_run<kOut>(tile, soff, gp, ig, t.z, (t.w & kCarryIn) != 0,
                           (t.w & kCarryOut) != 0, at, base, acc, best);
    __syncthreads();  // the next chunk stages into this buffer
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int y = y0 + warp + j * kThreadsY;
      const int x = x0 + lane + c * kThreadsX;
      if (y >= h || x >= w) continue;
      if (kRaw) {
        out_a[static_cast<int64_t>(y - ws.x) * ws.w + x - ws.y] = acc[j * kCols + c];
      } else {
        out_a[static_cast<int64_t>(y) * w + x] =
            (zero_border && !sx_interior(y, x, h, w, border))
                ? 0.0f
                : sx_degrees(acc[j * kCols + c]);
      }
    }
  }
}

// The dynamic shared memory of the two stages, raised above the default
// 48 KB where needed; returns the CUDA error of the attribute call.
template <typename Kernel>
int set_stage_smem(Kernel kernel, int stage_floats) {
  const int bytes = 2 * stage_floats * static_cast<int>(sizeof(float));
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace sx_chunked
