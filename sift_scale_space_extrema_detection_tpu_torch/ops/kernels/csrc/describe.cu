// Bilinear samples of the scale-space gradient for the describe stages, on
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   sift_scale_space_extrema_detection_tpu/ops/pallas/describe.py::
//   window_sample_pair (kernel body _make_kernel).
// The plain PyTorch version is window_sample_pair_reference in
// ../describe.py: bilinear_sample(scale_space_gradients(stack)) on the
// slot's plane. The two round every difference, product and sum
// identically, so on the card they agree bit for bit.
//
// Contract. A slot is one keypoint (orientation stage) or one (keypoint,
// orientation) pair (descriptor stage): slots[m] = {batch, octave,
// scale_level, valid}. Sample i of slot m sits at (ys, xs)[m][i] in the
// coordinates of plane ``scale_level`` of stack ``octave`` (B, S, H_o, W_o).
// The outputs are the central-difference gradients (gy, gx) of that plane,
// sampled bilinearly there: coordinates clamped to the plane before the
// fractional part is taken, the gradient's border rows (gy) and columns
// (gx) exactly zero. An invalid slot, or one whose octave is not in the
// table, reads nothing and gives zeros. Batch and scale level are clamped
// to the stack (keypoints only hold levels 1..spo; nothing is checked on
// the device before the launch).
//
// What bounds it on this card: bytes. A sample costs some 40 float
// operations against 16 bytes of coordinates read and samples written, and
// the card's float32 line is ~20 flop/byte. The least traffic is the
// coordinates in, the samples out, the slot table, and each valid slot's
// window of its plane once.
//
// What this design does about it: one thread per (slot, sample), a slot's
// samples on neighbouring threads, so coordinates and outputs move
// coalesced and exactly once. Each thread reads the 16 plane values its
// four gradient corners need; a slot's samples fall in one small window,
// so L1/L2 serve most of those reads and device memory sees about the
// window. A redesign for speed takes one block per slot, brings the window
// to shared memory once (cp.async or TMA), forms the gradient there and
// samples from it. The TPU kernel's aligned window planner, its padding of
// stacks and slot count, and its interpolation by tent-weight matrix
// products answer that chip's DMA and matrix unit and have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOctaves = 8;
constexpr int kThreads = 256;

struct OctaveTable {
  const float* stack[kMaxOctaves];
  int h[kMaxOctaves];
  int w[kMaxOctaves];
};

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

// The table is a __grid_constant__ parameter: indexing it by the slot's octave
// reads the parameter bank directly, with no per-thread copy.
__global__ void window_sample_kernel(const __grid_constant__ OctaveTable table,
                                     int n_octaves,
                                     int batch, int n_scales,
                                     const int4* __restrict__ slots,
                                     const float* __restrict__ ys,
                                     const float* __restrict__ xs,
                                     float* __restrict__ gy_out,
                                     float* __restrict__ gx_out,
                                     size_t total, int n_samples) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int4 slot = slots[i / n_samples];  // batch, octave, scale, valid
  if (slot.w == 0 || slot.y < 0 || slot.y >= n_octaves) {
    gy_out[i] = 0.f;
    gx_out[i] = 0.f;
    return;
  }
  const int h = table.h[slot.y];
  const int w = table.w[slot.y];
  const int b = min(max(slot.x, 0), batch - 1);
  const int s = min(max(slot.z, 0), n_scales - 1);
  const float* plane =
      table.stack[slot.y] + ((size_t)b * n_scales + s) * ((size_t)h * w);

  const float y = fminf(fmaxf(ys[i], 0.f), (float)(h - 1));
  const float x = fminf(fmaxf(xs[i], 0.f), (float)(w - 1));
  const float y_floor = floorf(y);
  const float x_floor = floorf(x);
  const float fy = __fsub_rn(y, y_floor);
  const float fx = __fsub_rn(x, x_floor);
  const int y0 = min(max((int)y_floor, 0), h - 1);
  const int x0 = min(max((int)x_floor, 0), w - 1);
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);

  gy_out[i] = blend(grad_y(plane, y0, x0, h, w), grad_y(plane, y0, x1, h, w),
                    grad_y(plane, y1, x0, h, w), grad_y(plane, y1, x1, h, w),
                    fx, fy);
  gx_out[i] = blend(grad_x(plane, y0, x0, h, w), grad_x(plane, y0, x1, h, w),
                    grad_x(plane, y1, x0, h, w), grad_x(plane, y1, x1, h, w),
                    fx, fy);
}

}  // namespace

// Sample ``n_slots`` slots of ``n_samples`` samples each. ``stacks``,
// ``heights`` and ``widths`` are host arrays of ``n_octaves`` entries: the
// device pointer and plane size of each octave's contiguous float32 stack
// (batch, n_scales, H_o, W_o). ``slots`` (n_slots, 4) int32, ``ys``/``xs``
// and the outputs ``gy``/``gx`` (n_slots, n_samples) float32 are device
// memory. Returns cudaGetLastError(), or cudaErrorInvalidValue for a table
// or a grid the kernel does not take.
extern "C" int sift_window_sample_pair(const void* const* stacks,
                                       const int* heights, const int* widths,
                                       int n_octaves, int batch, int n_scales,
                                       const int* slots, const float* ys,
                                       const float* xs, float* gy, float* gx,
                                       long long n_slots, int n_samples,
                                       void* stream) {
  if (n_octaves < 1 || n_octaves > kMaxOctaves || n_samples < 1 ||
      n_slots < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  OctaveTable table;
  for (int o = 0; o < kMaxOctaves; ++o) {
    const bool used = o < n_octaves;
    table.stack[o] = used ? static_cast<const float*>(stacks[o]) : nullptr;
    table.h[o] = used ? heights[o] : 0;
    table.w[o] = used ? widths[o] : 0;
  }
  const size_t total = (size_t)n_slots * (size_t)n_samples;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647ull) return (int)cudaErrorInvalidValue;
  window_sample_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_octaves, batch, n_scales, reinterpret_cast<const int4*>(slots),
      ys, xs, gy, gx, total, n_samples);
  return (int)cudaGetLastError();
}
