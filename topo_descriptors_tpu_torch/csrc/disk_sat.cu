// Disk ({0,1}-kernel) convolution through row prefix sums, for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_descriptors_tpu/ops/pallas/disk_sat.py::_sat_kernel
// and computes the same function as its XLA twin ops/conv.py::_conv2d_sat:
// every run [a, b] of ones in row r of the flipped kernel contributes
// P[y + r, x + b + 1] - P[y + r, x + a], where P is the row prefix sum of
// the zero-padded field with one sentinel zero column on the left. Rows
// that share (a, b) are summed before the two column reads: within a group
// the rows in table order (hi, lo), then hi - lo, then the groups in table
// order, as the plain PyTorch twin sums them. Above 2^24 a float32 sum is
// exact only in that order, so integer fields stay bit-equal to the twin.
//
// What bounds it on the H100: load instructions, not device memory. Per
// output pixel it reads 2 x (number of kernel runs) prefix values (136 for
// the 67-px TPI disk) and does one add per read; the bytes it must move
// (the field once, the output once) take ~0.16 ms at 8192^2, the ~206 adds
// per pixel ~0.2 ms at the float32 peak. Served from L1/L2 one scalar load
// at a time, the earlier two-launch design took ~7 ms there.
//
// What the design does about it. Two routes, chosen by the wrapper from
// the kernel's shape and the shared-memory limit alone (never the grid's
// size, so a banded run and a single pass take the same route):
//   * FUSED (the kernel's staged tile fits in shared memory: every disk up
//     to ~166 px, the 17- and 67-px disks of the main path among them).
//     disk_sat_row_scan<kTileW> writes only P at the tile boundaries (a
//     carry plane of one value per kTileW columns, 1/128 of the prefix
//     plane), then disk_sat_tile gives one block a kTileH x kTileW tile of
//     outputs. It stages the (kTileH + kh - 1) x (kTileW + kw - 1) padded
//     inputs its runs reach in dynamic shared memory with cp.async (every
//     value of the tile in flight at once, zeros outside the field in
//     place of the padding), scans each staged row from its carry (each
//     lane a segment in registers, then a shuffle scan of the lanes'
//     totals), and computes the run sums from shared memory, with the run
//     table staged there too (its reads are broadcasts). Each thread
//     produces 16 outputs, 4 consecutive rows x 4 columns 32 apart: one
//     table read feeds 16 outputs, every warp load is 32 consecutive words
//     (no bank conflicts), and two consecutive kernel rows of a group (the
//     disk's flat middle rows) are read from one 5-row window (109 loads
//     per output instead of 136 for the 67-px disk). Measured on the H100
//     against a 4-row window shifted in registers (more moves than loads
//     saved) and one-row-at-a-time reads, this was the fastest.
//     The prefix is carried in from the row's start, not restarted per
//     tile, because bit-equality on integer fields needs the twin's P
//     values; the full prefix plane and its two HBM round trips are gone.
//   * WIDE (the tile does not fit: the 20 km and 100 km disks of the
//     example batch, 667 and 3333 px). disk_sat_row_scan<1> writes the
//     full prefix plane P and disk_sat_run_sum reads it, one thread per
//     output pixel, neighbouring threads on neighbouring columns.
// The run table is runtime data, so one build serves every disk size.
// Indices into the fields, P and the output are 64-bit; tile loops replace
// the 65535 cap on gridDim.y.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stage.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;

// The fused route's output tile; ops/cuda/disk_sat.py mirrors these to
// size the shared memory and choose the route.
constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kRowsPerWarp = kTileH / kTileWarps;  // 4
constexpr int kColsPerLane = kTileW / 32;          // 4
// Most prefix values one lane scans per staged row: kTileW + kw - 1 <=
// 32 * kSegMax, i.e. kw <= 193 (the 227 KB tile already stops at ~166).
constexpr int kSegMax = 10;

// One block per row of P (B * hp rows). Row `row` holds the prefix sums of
// padded row r = row % hp of field b = row / hp; the padded row is the
// source row r - ly when that lies in [0, h), else all zeros. With
// kStride = 1 this is the full prefix plane: P[.., 0] = 0 and P[.., j + 1]
// = sum of padded columns 0..j, padded column j reading source column
// j - lx when that lies in [0, w). With kStride > 1 only P[.., k * kStride]
// is written, at index k < pq: the fused route's carry plane.
template <int kStride>
__global__ void __launch_bounds__(kScanThreads)
disk_sat_row_scan(const float* __restrict__ x, float* __restrict__ p, int h,
                  int w, int ly, int lx, int hp, int n, int pq) {
  const int64_t row = blockIdx.x;
  const int64_t b = row / hp;
  const int ys = static_cast<int>(row % hp) - ly;
  const float* xrow =
      (ys >= 0 && ys < h) ? x + (b * h + ys) * static_cast<int64_t>(w) : nullptr;
  float* prow = p + row * static_cast<int64_t>(pq);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ float warp_sums[kScanWarps];

  if (threadIdx.x == 0) prow[0] = 0.0f;
  float carry = 0.0f;
  for (int base = 0; base < n; base += kScanChunk) {
    const int j0 = base + threadIdx.x * kScanItems;
    float v[kScanItems];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = j0 + k;
      const int xs = j - lx;
      const float val =
          (xrow != nullptr && j < n && xs >= 0 && xs < w) ? xrow[xs] : 0.0f;
      run += val;
      v[k] = run;  // inclusive within the thread
    }
    // inclusive scan of the thread totals across the warp
    float t = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, t, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) warp_sums[warp] = t;
    __syncthreads();
    if (warp == 0) {
      float s = lane < kScanWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
      for (int off = 1; off < kScanWarps; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += up;
      }
      if (lane < kScanWarps) warp_sums[lane] = s;
    }
    __syncthreads();
    const float prefix =
        carry + (warp > 0 ? warp_sums[warp - 1] : 0.0f) + excl;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int j = j0 + k;
      if (j < n && (j + 1) % kStride == 0 && (j + 1) / kStride < pq) {
        prow[(j + 1) / kStride] = prefix + v[k];
      }
    }
    carry += warp_sums[kScanWarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
}

// Wide route: one thread per output pixel (b, y, x). `table` holds n_groups
// records of (a, b, first_row, end_row) followed by the row indices they
// point into; the sums run in table order so they match the twin.
__global__ void disk_sat_run_sum(const float* __restrict__ p,
                                 const int* __restrict__ table, int n_groups,
                                 float* __restrict__ out, int hp, int wq,
                                 int h_out, int w_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w_out) return;
  const int64_t b = blockIdx.z;
  const int* rows = table + 4 * n_groups;
  for (int y = blockIdx.y; y < h_out; y += gridDim.y) {
    const float* pb = p + (b * hp + y) * static_cast<int64_t>(wq);
    float acc = 0.0f;
    for (int g = 0; g < n_groups; ++g) {
      const int a = table[4 * g];
      const int bc = table[4 * g + 1];
      const int r0 = table[4 * g + 2];
      const int r1 = table[4 * g + 3];
      float hi = 0.0f;
      float lo = 0.0f;
      for (int i = r0; i < r1; ++i) {
        const float* pr = pb + rows[i] * static_cast<int64_t>(wq);
        if (i == r0) {
          hi = pr[x + bc + 1];
          lo = pr[x + a];
        } else {
          hi += pr[x + bc + 1];
          lo += pr[x + a];
        }
      }
      const float term = hi - lo;
      acc = g == 0 ? term : acc + term;
    }
    out[(b * h_out + y) * static_cast<int64_t>(w_out) + x] = acc;
  }
}

// Fused route. Block (tx, ty, b) computes outputs y0 .. y0 + kTileH - 1,
// x0 .. x0 + kTileW - 1 of field b. Staged row i (i < kh + kTileH - 1) is
// padded row y0 + i; its shared-memory slot s[i * pitch + k], k = 0 ..
// kTileW + kw - 1, receives P[y0 + i, x0 + k]: the carry P[y0 + i, x0]
// from the carry plane plus the tile's own scan. An output (y, x) then
// reads slot (y - y0 + r) * pitch + (x - x0) + a for P[y + r, x + a].
// Shared memory: the run table (4 * n_groups + n_rows ints, padded to a
// multiple of 4), then the staged rows.
__global__ void __launch_bounds__(kTileThreads)
disk_sat_tile(const float* __restrict__ x, const float* __restrict__ carry,
              const int* __restrict__ table, int n_groups, int table_len,
              float* __restrict__ out, int h, int w, int ly, int lx, int hp,
              int cq, int kh, int kw, int h_out, int w_out, int tiles_y) {
  extern __shared__ __align__(16) float smem[];
  int* tab = reinterpret_cast<int*>(smem);
  const int tab_pad = (table_len + 3) & ~3;
  float* s = smem + tab_pad;
  const int n_stage = kTileH + kh - 1;
  const int n_cols = kTileW + kw - 1;  // padded input columns per staged row
  const int pitch = n_cols + 1;        // P values per staged row
  const int seg = (n_cols + 31) / 32;  // scanned values per lane, <= kSegMax
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z;
  const int cx = blockIdx.x;
  const int x0 = cx * kTileW;

  for (int i = threadIdx.x; i < table_len; i += kTileThreads) tab[i] = table[i];
  const int* rows = tab + 4 * n_groups;

  for (int ty = blockIdx.y; ty < tiles_y; ty += gridDim.y) {
    const int y0 = ty * kTileH;
    __syncthreads();  // the table is in place; the previous tile is done
    // stage: every value of the tile in flight at once, zeros outside the
    // field; slot 0 of each row takes its carry
    for (int i = warp; i < n_stage; i += kTileWarps) {
      const int prow = y0 + i;  // padded row
      const int ys = prow - ly;
      const bool row_ok = prow < hp && ys >= 0 && ys < h;
      const float* src = x + (b * h + (row_ok ? ys : 0)) * static_cast<int64_t>(w);
      float* srow = s + i * pitch;
      for (int c = lane; c < n_cols; c += 32) {
        const int xs = x0 - lx + c;
        const bool ok = row_ok && xs >= 0 && xs < w;
        cp_async_f32(srow + 1 + c, ok ? src + xs : x, ok);
      }
      if (lane == 0) {
        const bool ok = prow < hp;
        cp_async_f32(srow, ok ? carry + (b * hp + prow) * static_cast<int64_t>(cq) + cx
                              : carry, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // scan: one warp per staged row, each lane `seg` consecutive values in
    // registers, then a shuffle scan of the lanes' totals
    for (int i = warp; i < n_stage; i += kTileWarps) {
      float* srow = s + i * pitch;
      const int k0 = 1 + lane * seg;
      float v[kSegMax];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < kSegMax; ++k) {
        if (k < seg && k0 + k <= n_cols) run += srow[k0 + k];
        v[k] = run;
      }
      float t = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, t, 1);
      if (lane == 0) excl = 0.0f;
      const float base = srow[0] + excl;  // no lane writes slot 0
#pragma unroll
      for (int k = 0; k < kSegMax; ++k) {
        if (k < seg && k0 + k <= n_cols) srow[k0 + k] = base + v[k];
      }
    }
    __syncthreads();

    // run sums: warp `warp` takes the kRowsPerWarp consecutive tile rows
    // from yl0, each lane the columns lane + 32 * c. A group's rows come in
    // ascending order; where row r + 1 follows row r (the disk's flat
    // middle rows), the pair is summed from one window of kRowsPerWarp + 1
    // staged rows: 5 loads for 8 reads per column. The sums still run row
    // by row, in table order.
    const int yl0 = warp * kRowsPerWarp;
    float acc[kRowsPerWarp][kColsPerLane] = {};
    for (int g = 0; g < n_groups; ++g) {
      const int a = tab[4 * g];
      const int bc1 = tab[4 * g + 1] + 1;
      const int r0 = tab[4 * g + 2];
      const int r1 = tab[4 * g + 3];  // > r0: a group holds at least one row
      float hi[kRowsPerWarp][kColsPerLane];
      float lo[kRowsPerWarp][kColsPerLane];
      for (int i = r0; i < r1;) {
        const int r = rows[i];
        const float* base = s + (yl0 + r) * pitch + lane;
        const bool first = i == r0;
        if (i + 1 < r1 && rows[i + 1] == r + 1) {
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            float vh[kRowsPerWarp + 1];
            float vl[kRowsPerWarp + 1];
#pragma unroll
            for (int j = 0; j <= kRowsPerWarp; ++j) {
              vh[j] = base[j * pitch + 32 * c + bc1];
              vl[j] = base[j * pitch + 32 * c + a];
            }
#pragma unroll
            for (int j = 0; j < kRowsPerWarp; ++j) {
              hi[j][c] = (first ? vh[j] : hi[j][c] + vh[j]) + vh[j + 1];
              lo[j][c] = (first ? vl[j] : lo[j][c] + vl[j]) + vl[j + 1];
            }
          }
          i += 2;
        } else {
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
#pragma unroll
            for (int j = 0; j < kRowsPerWarp; ++j) {
              const float vh = base[j * pitch + 32 * c + bc1];
              const float vl = base[j * pitch + 32 * c + a];
              hi[j][c] = first ? vh : hi[j][c] + vh;
              lo[j][c] = first ? vl : lo[j][c] + vl;
            }
          }
          i += 1;
        }
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c) {
          const float term = hi[j][c] - lo[j][c];
          acc[j][c] = g == 0 ? term : acc[j][c] + term;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int y = y0 + yl0 + j;
      if (y >= h_out) continue;
      float* orow = out + (b * h_out + y) * static_cast<int64_t>(w_out);
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) {
        const int xo = x0 + lane + 32 * c;
        if (xo < w_out) orow[xo] = acc[j][c];
      }
    }
  }
}

}  // namespace

// Wide route: the full prefix plane p (n_fields x hp x wq) and the run-sum
// pass. Returns cudaGetLastError().
extern "C" int disk_sat_forward(const float* x, float* p, float* out,
                                const int* table, int n_groups, int n_fields,
                                int h, int w, int ly, int lx, int hp, int wq,
                                int h_out, int w_out, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(n_fields) * hp;
  if (rows > 0) {
    disk_sat_row_scan<1><<<static_cast<unsigned>(rows), kScanThreads, 0, stream>>>(
        x, p, h, w, ly, lx, hp, wq - 1, wq);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_fields > 0 && h_out > 0 && w_out > 0) {
    const int threads = 128;
    const dim3 grid((w_out + threads - 1) / threads,
                    h_out < 65535 ? h_out : 65535, n_fields);
    disk_sat_run_sum<<<grid, threads, 0, stream>>>(p, table, n_groups, out, hp,
                                                   wq, h_out, w_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Fused route: the carry plane (n_fields x hp x cq, cq = number of column
// tiles) and the tiled run sums, with `smem_bytes` of dynamic shared memory
// (the wrapper's fused_smem_bytes). Returns cudaGetLastError(), so a launch
// refused for its shared memory reaches the wrapper.
extern "C" int disk_sat_fused_forward(const float* x, float* carry, float* out,
                                      const int* table, int n_groups,
                                      int table_len, int n_fields, int h, int w,
                                      int ly, int lx, int hp, int wq, int kh,
                                      int kw, int h_out, int w_out,
                                      int smem_bytes, cudaStream_t stream) {
  if (n_fields <= 0 || h_out <= 0 || w_out <= 0) return 0;
  const int cq = (w_out + kTileW - 1) / kTileW;
  const int64_t rows = static_cast<int64_t>(n_fields) * hp;
  disk_sat_row_scan<kTileW><<<static_cast<unsigned>(rows), kScanThreads, 0, stream>>>(
      x, carry, h, w, ly, lx, hp, wq - 1, cq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(disk_sat_tile,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_y = (h_out + kTileH - 1) / kTileH;
  const dim3 grid(cq, tiles_y < 65535 ? tiles_y : 65535, n_fields);
  disk_sat_tile<<<grid, kTileThreads, smem_bytes, stream>>>(
      x, carry, table, n_groups, table_len, out, h, w, ly, lx, hp, cq, kh, kw,
      h_out, w_out, tiles_y);
  return static_cast<int>(cudaGetLastError());
}
