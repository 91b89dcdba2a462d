// The separable blur's two passes, shared by the fused octave kernel
// (octave.cu) and the stand-alone blur (blur.cu).
//
// Exactness rules both keep:
// - clamp-to-edge is an index clamp on the logical grid, exact for any
//   radius, including one that passes the plane size;
// - products and sums are rounded separately (__fmul_rn/__fadd_rn, and
//   the build passes -fmad=false): a fused multiply-add would round once
//   and differ from the plain PyTorch tap loop;
// - taps accumulate in tap order, row pass (x) first, then column pass (y).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ int clamp_index(int v, int hi) {
  return min(max(v, 0), hi);
}

// Row pass: dst[b][y][x] = sum_t taps[t] * L(y, clamp(x + t - r)) over the
// logical (H, W) grid. L is the octave base; with shift = 1 the base is
// the half-resolution image and L(y, x) = src[y >> 1][x >> 1].
__global__ void row_pass_kernel(const float* __restrict__ src,
                                float* __restrict__ dst, int h, int w,
                                int shift, const float* __restrict__ taps,
                                int r) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int b = blockIdx.z;
  const int src_h = h >> shift;
  const int src_w = w >> shift;
  const float* row =
      src + ((size_t)b * src_h + (size_t)(y >> shift)) * (size_t)src_w;
  float acc = __fmul_rn(row[clamp_index(x - r, w - 1) >> shift], taps[0]);
  for (int t = 1; t <= 2 * r; ++t) {
    const float v = row[clamp_index(x + t - r, w - 1) >> shift];
    acc = __fadd_rn(acc, __fmul_rn(v, taps[t]));
  }
  dst[((size_t)b * h + y) * (size_t)w + x] = acc;
}

// Column pass over the row-pass output: dst[b][y][x] =
// sum_t taps[t] * src[b][clamp(y + t - r)][x]; dst has batch stride
// dst_batch_stride (a plane of the (B, S, H, W) Gaussian stack).
__global__ void col_pass_kernel(const float* __restrict__ src,
                                float* __restrict__ dst,
                                size_t dst_batch_stride, int h, int w,
                                const float* __restrict__ taps, int r) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int b = blockIdx.z;
  const float* col = src + (size_t)b * h * w + x;
  float acc = __fmul_rn(col[(size_t)clamp_index(y - r, h - 1) * w], taps[0]);
  for (int t = 1; t <= 2 * r; ++t) {
    const float v = col[(size_t)clamp_index(y + t - r, h - 1) * w];
    acc = __fadd_rn(acc, __fmul_rn(v, taps[t]));
  }
  dst[(size_t)b * dst_batch_stride + (size_t)y * w + x] = acc;
}

}  // namespace
