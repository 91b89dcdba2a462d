// One separable Gaussian blur on Hopper (sm_90a): a row pass into a scratch
// plane, a column pass into the output, clamp-to-edge as an index clamp.
//
// Replaces the Pallas TPU kernel
//   sift_scale_space_extrema_detection_tpu/ops/pallas/blur.py::blur_pallas
//   (kernel body _blur_stripe_kernel).
// The plain PyTorch version is ops/gaussian.py::blur_separable; the two
// round every product and sum identically (see blur_passes.cuh), so on the
// card they agree bit for bit.
//
// What bounds it on this card: bytes, up to a radius of about 40. A pass
// does 2(2r+1) flop per pixel against 8 bytes of device-memory traffic, and
// the card's float32 line is ~20 flop/byte (67 TFLOP/s over 3.35 TB/s).
// The least traffic is one read and one write of the plane.
//
// What this design does about it: one thread per output pixel, a warp along
// a row, so reads and writes are coalesced and L1/L2 serve the overlapping
// tap reads. The scratch plane costs a second read and write of the plane
// (twice the least traffic); a redesign keeps a row stripe with its halo in
// shared memory and runs both passes there. The TPU kernel's stripe planner,
// edge padding and size gate are sizing for that chip's fast memory and have
// no counterpart: any radius is taken.

#include <cuda_runtime.h>

#include "blur_passes.cuh"

// Blur ``src`` (B, H, W) with the ``2 * radius + 1`` taps at ``taps``
// (device memory) into ``dst`` (B, H, W); ``tmp`` (B, H, W) is scratch.
// Both launches go on ``stream``; returns cudaGetLastError().
extern "C" int sift_blur(const float* src, int batch, int h, int w,
                         const float* taps, int radius, float* tmp,
                         float* dst, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY,
                  batch);
  row_pass_kernel<<<grid, block, 0, st>>>(src, tmp, h, w, 0, taps, radius);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  col_pass_kernel<<<grid, block, 0, st>>>(tmp, dst, (size_t)h * w, h, w, taps,
                                          radius);
  return (int)cudaGetLastError();
}
