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
//
// Where it launches: for a caller's own sampler of the describe stages
// (ops/descriptor.py's tensor code with sample_fn=window_sample_pair). The
// frontend's describe stages run histograms.cu's two kernels, which sample
// with this kernel's device code (gradient_sample.cuh) inside their
// histograms and write no samples to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gradient_sample.cuh"

namespace {

using sift_sample::OctaveTable;
constexpr int kThreads = 256;

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
  int h = 0, w = 0;
  const float* plane = sift_sample::slot_plane(table, n_octaves, batch,
                                               n_scales, slots[i / n_samples],
                                               h, w);
  if (plane == nullptr) {
    gy_out[i] = 0.f;
    gx_out[i] = 0.f;
    return;
  }
  sift_sample::sample_gradient(plane, h, w, ys[i], xs[i], gy_out[i], gx_out[i]);
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
  OctaveTable table;
  if (!sift_sample::fill_table(table, stacks, heights, widths, n_octaves) ||
      n_samples < 1 || n_slots < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  const size_t total = (size_t)n_slots * (size_t)n_samples;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647ull) return (int)cudaErrorInvalidValue;
  window_sample_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_octaves, batch, n_scales, reinterpret_cast<const int4*>(slots),
      ys, xs, gy, gx, total, n_samples);
  return (int)cudaGetLastError();
}
