// Staging field values into shared memory, shared by the tiled kernels
// (disk_sat.cu, sx_block.cu, sx_sweep.cu, sx_chunked.cuh). Three ways, each
// the faster one on the H100 for the kernel that uses it, or the one its
// double buffer needs:
//   * cp.async (disk_sat.cu): one 4-byte copy per value, issued by every
//     thread without waiting, then one wait: the whole tile's loads are in
//     flight together (the fused route); or 16-byte copies grouped per
//     stage of a double buffer (the wide route);
//   * stage_row (sx_block.cu, sx_sweep.cu): one warp per row, one 16-byte load per lane
//     where the row is aligned;
//   * stage_box_async (sx_chunked.cuh): a box for one stage of a double
//     buffer, 4-byte cp.async for the cells inside the field and plain
//     stores of a fill (NaN) for the others, since cp.async's own fill is
//     zero.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// dst = *src when `valid`, else 0 (cp.async's zero fill: no byte is read
// from `src`, which must still be a device address).
static __device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                                    bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Waits for this thread's copies; a __syncthreads() after it publishes the
// tile to the block.
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 16 bytes, dst = *src when `valid`, else zeros; both addresses 16-byte
// aligned. Copies are grouped by cp_async_commit() and waited for by
// group (cp_async_wait_group<N>: all but the N most recent groups done),
// so one stage of a double buffer lands while the other is read.
static __device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                                   bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies source columns [c0, c0 + n) of `src` (a row of w floats, or
// nullptr for a row outside the field) into dst[0 .. n), with `fill` for
// columns outside [0, w). Called by one warp: its lanes take consecutive
// aligned quads, one 16-byte load each where the quad lies inside the row
// and `vec` says the rows are 16-byte aligned, four scalar loads at the
// edges, so a warp reads 512 contiguous bytes at a time.
static __device__ __forceinline__ void stage_row(const float* __restrict__ src,
                                                 int w, int c0, int n,
                                                 float* dst, int lane, bool vec,
                                                 float fill) {
  const int q0 = c0 >= 0 ? c0 & ~3 : -((3 - c0) & ~3);  // floor to a multiple of 4
  for (int q = q0 + 4 * lane; q < c0 + n; q += 128) {
    float v[4];
    if (src != nullptr && vec && q >= 0 && q + 3 < w) {
      const float4 f = *reinterpret_cast<const float4*>(src + q);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = q + t;
        v[t] = (src != nullptr && c >= 0 && c < w) ? src[c] : fill;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = q + t - c0;
      if (d >= 0 && d < n) dst[d] = v[t];
    }
  }
}

// Issues (does not wait for) the copies of the sh x sw box of the h x w
// field `src` whose first cell is (r0, c0) into dst (row stride sw): one
// 4-byte cp.async per cell inside the field, and `fill` stored into the
// others. Called by every thread of a block of n_threads (a multiple of
// 32), thread `tid`: warps take rows, lanes consecutive columns, so a warp
// reads 128 contiguous bytes at a time. The copies are grouped with the
// caller's cp_async_commit(); the fill stores are seen after its
// __syncthreads().
static __device__ __forceinline__ void stage_box_async(
    const float* __restrict__ src, int h, int w, int r0, int c0, int sh,
    int sw, float* dst, int tid, int n_threads, float fill) {
  const int lane = tid & 31;
  for (int i = tid >> 5; i < sh; i += n_threads >> 5) {
    const int y = r0 + i;
    float* d = dst + i * sw;
    if (y < 0 || y >= h) {
      for (int j = lane; j < sw; j += 32) d[j] = fill;
      continue;
    }
    const float* row = src + static_cast<int64_t>(y) * w;
    for (int j = lane; j < sw; j += 32) {
      const int x = c0 + j;
      if (x >= 0 && x < w) {
        cp_async_f32(d + j, row + x, true);
      } else {
        d[j] = fill;
      }
    }
  }
}
