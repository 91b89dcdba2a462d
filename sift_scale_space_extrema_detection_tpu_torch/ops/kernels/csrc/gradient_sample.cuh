// The scale-space gradient sampled bilinearly on one plane of a slot: the
// device code of K2 (describe.cu), which the describe stages' kernels
// (histograms.cu) run too, so that their samples are K2's bit for bit.
//
// Contract (K2's, and ops/sampling.py's scale_space_gradients +
// bilinear_sample): a slot {batch, octave, scale_level, valid} samples plane
// ``scale_level`` of image ``batch`` in octave ``octave``'s contiguous
// float32 stack (batch, n_scales, H_o, W_o). An invalid slot, or one whose
// octave is not in the table, reads nothing. Batch and scale level are
// clamped to the stack. The gradients are central differences, their
// border rows (gy) and columns (gx) exactly zero, sampled at coordinates
// clamped to the plane; every difference, product and sum rounded on its
// own (the library is built with -fmad=false as well).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sift_sample {

constexpr int kMaxOctaves = 8;

struct OctaveTable {
  const float* stack[kMaxOctaves];
  int h[kMaxOctaves];
  int w[kMaxOctaves];
};

// Fill ``table`` from host arrays of ``n_octaves`` entries; false for a
// count the table does not hold.
inline bool fill_table(OctaveTable& table, const void* const* stacks,
                       const int* heights, const int* widths, int n_octaves) {
  if (n_octaves < 1 || n_octaves > kMaxOctaves) return false;
  for (int o = 0; o < kMaxOctaves; ++o) {
    const bool used = o < n_octaves;
    table.stack[o] = used ? static_cast<const float*>(stacks[o]) : nullptr;
    table.h[o] = used ? heights[o] : 0;
    table.w[o] = used ? widths[o] : 0;
  }
  return true;
}

// The plane ``slot`` (batch, octave, scale, valid) samples and its size, or
// nullptr where the slot reads nothing. 64-bit offsets: a stack may pass
// 2^31 elements.
__device__ __forceinline__ const float* slot_plane(const OctaveTable& table,
                                                   int n_octaves, int batch,
                                                   int n_scales, int4 slot,
                                                   int& h, int& w) {
  if (slot.w == 0 || slot.y < 0 || slot.y >= n_octaves) return nullptr;
  h = table.h[slot.y];
  w = table.w[slot.y];
  const int b = min(max(slot.x, 0), batch - 1);
  const int s = min(max(slot.z, 0), n_scales - 1);
  return table.stack[slot.y] + ((size_t)b * n_scales + s) * ((size_t)h * w);
}

// gy at integer (y, x): (P[y+1][x] - P[y-1][x]) / 2 inside, 0 on the
// plane's first and last row.
__device__ __forceinline__ float grad_y(const float* __restrict__ p, int y,
                                        int x, int h, int w) {
  if (y < 1 || y > h - 2) return 0.f;
  return __fmul_rn(
      __fsub_rn(p[(size_t)(y + 1) * w + x], p[(size_t)(y - 1) * w + x]), 0.5f);
}

// gx at integer (y, x): (P[y][x+1] - P[y][x-1]) / 2 inside, 0 on the
// plane's first and last column.
__device__ __forceinline__ float grad_x(const float* __restrict__ p, int y,
                                        int x, int h, int w) {
  if (x < 1 || x > w - 2) return 0.f;
  return __fmul_rn(
      __fsub_rn(p[(size_t)y * w + x + 1], p[(size_t)y * w + x - 1]), 0.5f);
}

// top = v00 (1 - fx) + v01 fx, bot alike, out = top (1 - fy) + bot fy,
// every product and sum rounded on its own.
__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float gx1 = __fsub_rn(1.0f, fx);
  const float gy1 = __fsub_rn(1.0f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx1), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx1), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy1), __fmul_rn(bot, fy));
}

// (gy, gx) of ``plane`` (h × w) sampled bilinearly at (ys, xs), the
// coordinates clamped to the plane before the fractional part is taken.
__device__ __forceinline__ void sample_gradient(const float* __restrict__ plane,
                                                int h, int w, float ys,
                                                float xs, float& gy,
                                                float& gx) {
  const float y = fminf(fmaxf(ys, 0.f), (float)(h - 1));
  const float x = fminf(fmaxf(xs, 0.f), (float)(w - 1));
  const float y_floor = floorf(y);
  const float x_floor = floorf(x);
  const float fy = __fsub_rn(y, y_floor);
  const float fx = __fsub_rn(x, x_floor);
  const int y0 = min(max((int)y_floor, 0), h - 1);
  const int x0 = min(max((int)x_floor, 0), w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);
  gy = blend(grad_y(plane, y0, x0, h, w), grad_y(plane, y0, x1, h, w),
             grad_y(plane, y1, x0, h, w), grad_y(plane, y1, x1, h, w), fx, fy);
  gx = blend(grad_x(plane, y0, x0, h, w), grad_x(plane, y0, x1, h, w),
             grad_x(plane, y1, x0, h, w), grad_x(plane, y1, x1, h, w), fx, fy);
}

}  // namespace sift_sample
