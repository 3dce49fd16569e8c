// Disk ({0,1}-kernel) convolution through row prefix sums, for Hopper (sm_90a).
//
// Replaces the TPU kernel topo_descriptors_tpu/ops/pallas/disk_sat.py::_sat_kernel
// and computes the same function as its XLA twin ops/conv.py::_conv2d_sat:
// every run [a, b] of ones in row r of the flipped kernel contributes
// P[y + r, x + b + 1] - P[y + r, x + a], where P is the row prefix sum of
// the zero-padded field with one sentinel zero column on the left. Rows
// that share (a, b) are summed before the two column reads.
//
// What bounds it on the H100: bytes. Per output pixel the run-sum pass reads
// 2 x (number of kernel runs) prefix values (136 for the 67-px TPI disk) and
// does one add per read; there is no matmul to feed the tensor cores.
// What the design does about it:
//   (a) disk_sat_row_scan writes P once: one block per padded row, the
//       zero padding comes from masked loads (no separate pad pass), and the
//       scan is a warp-shuffle scan with a carry across 1024-column chunks;
//   (b) disk_sat_run_sum gives one thread per output pixel; neighbouring
//       threads read neighbouring columns of the same P rows, so the
//       ~2 x runs reads per pixel are coalesced and mostly served by L1/L2
//       instead of device memory.
// The run table is runtime data (a small int32 device array), so one build
// serves every disk size. Indices into P and the output are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanChunk = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;

// One block per row of P (B * hp rows). Row `row` holds the prefix sums of
// padded row r = row % hp of field b = row / hp; the padded row is the
// source row r - ly when that lies in [0, h), else all zeros. P[.., 0] = 0
// and P[.., j + 1] = sum of padded columns 0..j, with padded column j
// reading source column j - lx when that lies in [0, w).
__global__ void __launch_bounds__(kScanThreads)
disk_sat_row_scan(const float* __restrict__ x, float* __restrict__ p, int h,
                  int w, int ly, int lx, int hp, int wq) {
  const int64_t row = blockIdx.x;
  const int64_t b = row / hp;
  const int ys = static_cast<int>(row % hp) - ly;
  const float* xrow =
      (ys >= 0 && ys < h) ? x + (b * h + ys) * static_cast<int64_t>(w) : nullptr;
  float* prow = p + row * static_cast<int64_t>(wq);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = wq - 1;  // padded columns
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
      if (j < n) prow[j + 1] = prefix + v[k];
    }
    carry += warp_sums[kScanWarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
}

// One thread per output pixel (b, y, x). `table` holds n_groups records of
// (a, b, first_row, end_row) followed by the row indices they point into;
// the sums run in table order so they match the plain PyTorch twin.
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

}  // namespace

extern "C" int disk_sat_forward(const float* x, float* p, float* out,
                                const int* table, int n_groups, int n_fields,
                                int h, int w, int ly, int lx, int hp, int wq,
                                int h_out, int w_out, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(n_fields) * hp;
  if (rows > 0) {
    disk_sat_row_scan<<<static_cast<unsigned>(rows), kScanThreads, 0, stream>>>(
        x, p, h, w, ly, lx, hp, wq);
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
