// Staging field values into shared memory, shared by the tiled kernels
// (disk_sat.cu, sx_block.cu). Two ways, each the faster one on the H100
// for the kernel that uses it:
//   * cp.async (disk_sat.cu): one 4-byte copy per value, issued by every
//     thread without waiting, then one wait: the whole tile's loads are in
//     flight together;
//   * stage_row (sx_block.cu): one warp per row, one 16-byte load per lane
//     where the row is aligned.

#pragma once

#include <cuda_runtime.h>

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
