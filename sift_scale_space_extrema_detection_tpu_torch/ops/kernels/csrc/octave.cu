// One SIFT octave on Hopper (sm_90a): all Gaussian scales, the DoG planes,
// the next octave's seed scale and the packed 26-neighbour extrema masks.
//
// Replaces the Pallas TPU kernel
//   sift_scale_space_extrema_detection_tpu/ops/pallas/octave.py::fused_octave
//   (kernel body _octave_kernel).
// The plain PyTorch version is fused_octave_reference in ../octave.py; the
// two round every product and sum identically, so on the card they agree
// bit for bit.
//
// What bounds it on this card: bytes. A blur pass does about 4r+1 flop per
// output pixel against 8 bytes of device-memory traffic (one float read,
// one written): 3 flop/byte at octave 0's largest radius (6), where about
// three quarters of the bytes are, against the H100's float32 line of ~20
// flop/byte (67 TFLOP/s over 3.35 TB/s). The DoG + scan pass is a stencil
// of a few flop per byte. Only octave 3's radius 47 (~24 flop/byte) passes
// the line, on 1/64 of octave 0's pixels.
//
// What this design does about it: it keeps every read coalesced (one
// thread per output pixel, a warp along a row) and lets L1/L2 serve the
// overlapping tap and 3x3 neighbourhood reads, so device memory sees about
// one read and one write per plane and pass. It does not yet keep the
// Gaussian stack on chip: each scale goes through device memory twice
// (row pass into a scratch plane, column pass into the stack), and one
// last pass forms the DoG, the seed and the masks from the stack. Fusing
// the passes in shared memory is the next step for speed.
//
// Exactness rules the kernels keep (the row and column passes and their
// rules are in blur_passes.cuh, shared with the stand-alone blur):
// - the 2x nearest upsample of octave 0 is the index shift
//   src[clamp(y) >> 1][clamp(x) >> 1], bit-exact;
// - products, sums and differences are rounded separately: a fused
//   multiply-add would round once and flip rare strict-extremum near-ties
//   against the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blur_passes.cuh"

namespace {

// DoG planes dog[s-1] = L[s-1] - L[s], the seed L[spo], and the packed
// extrema codes. Trio t (DoG planes t, t+1, t+2, centred on t+1) owns bits
// [2t, 2t+2): 1 for a strict 26-neighbour extremum with |centre| >= thr,
// 2 for one below it, 0 otherwise; only the interior 1 <= y <= H-2,
// 1 <= x <= W-2 is set. Each thread walks the DoG planes with a sliding
// window of three planes' 3x3 min/max (the centre plane's 8-neighbour ring
// kept apart so the test stays strict), as the TPU kernel does.
__global__ void dog_scan_kernel(const float* __restrict__ stack,
                                float* __restrict__ dog,
                                float* __restrict__ seed, void* masks,
                                int mask16, int n_scales, int h, int w,
                                int spo, float thr) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int b = blockIdx.z;
  const size_t hw = (size_t)h * w;
  const size_t p = (size_t)y * w + x;
  const float* L = stack + (size_t)b * n_scales * hw;
  float* D = dog + (size_t)b * (n_scales - 1) * hw;
  seed[(size_t)b * hw + p] = L[(size_t)spo * hw + p];

  int packed = 0;
  if (y >= 1 && y <= h - 2 && x >= 1 && x <= w - 2) {
    // Offsets of the 3x3 neighbourhood, centre at index 4.
    const size_t nb[9] = {p - w - 1, p - w, p - w + 1, p - 1, p,
                          p + 1,     p + w - 1, p + w, p + w + 1};
    float upper[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) upper[i] = L[nb[i]];
    // Window: plane q-2 (lo_*), plane q-1 (mid_*), current plane q.
    float lo_min = 0.f, lo_max = 0.f;
    float mid_min = 0.f, mid_max = 0.f, mid_ring_min = 0.f,
          mid_ring_max = 0.f, mid_ctr = 0.f;
    for (int q = 0; q < n_scales - 1; ++q) {
      const float* Lq1 = L + (size_t)(q + 1) * hw;
      float d[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const float lower = upper[i];
        upper[i] = Lq1[nb[i]];
        d[i] = __fsub_rn(lower, upper[i]);
      }
      D[(size_t)q * hw + p] = d[4];
      float ring_min = d[0], ring_max = d[0];
#pragma unroll
      for (int i = 1; i < 9; ++i) {
        if (i == 4) continue;
        ring_min = fminf(ring_min, d[i]);
        ring_max = fmaxf(ring_max, d[i]);
      }
      const float min9 = fminf(ring_min, d[4]);
      const float max9 = fmaxf(ring_max, d[4]);
      if (q >= 2) {
        const float nb_min = fminf(fminf(lo_min, min9), mid_ring_min);
        const float nb_max = fmaxf(fmaxf(lo_max, max9), mid_ring_max);
        const bool is_ext = (mid_ctr > nb_max) || (mid_ctr < nb_min);
        const int code = is_ext ? (fabsf(mid_ctr) >= thr ? 1 : 2) : 0;
        packed |= code << (2 * (q - 2));
      }
      lo_min = mid_min;
      lo_max = mid_max;
      mid_min = min9;
      mid_max = max9;
      mid_ring_min = ring_min;
      mid_ring_max = ring_max;
      mid_ctr = d[4];
    }
  } else {
    for (int q = 0; q < n_scales - 1; ++q) {
      D[(size_t)q * hw + p] =
          __fsub_rn(L[(size_t)q * hw + p], L[(size_t)(q + 1) * hw + p]);
    }
  }
  if (mask16) {
    static_cast<int16_t*>(masks)[(size_t)b * hw + p] = (int16_t)packed;
  } else {
    static_cast<int32_t*>(masks)[(size_t)b * hw + p] = packed;
  }
}

}  // namespace

// One octave for a batch of B bases. ``h``, ``w`` are the logical plane
// size (2x the base's with ``upsample2x``). Scale s blurs with the
// ``2 * radii[s] + 1`` taps at ``taps + tap_offsets[s]`` (device memory;
// ``radii`` and ``tap_offsets`` are host arrays). ``stack`` (B, S, H, W)
// and ``tmp`` (B, H, W) are scratch; ``dog`` (B, S-1, H, W), ``seed``
// (B, H, W) and ``masks`` (B, H, W, int16 when ``mask16`` else int32) are
// written; ``stack`` holds the Gaussian scales afterwards, for a caller
// that wants them. All launches go on ``stream``; returns cudaGetLastError().
extern "C" int sift_fused_octave(const float* base, int batch, int h, int w,
                                 int upsample2x, const float* taps,
                                 const int* tap_offsets, const int* radii,
                                 int n_scales, int spo, float contrast_thr,
                                 float* stack, float* tmp, float* dog,
                                 float* seed, void* masks, int mask16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY,
                  batch);
  const size_t hw = (size_t)h * w;
  for (int s = 0; s < n_scales; ++s) {
    const float* t = taps + tap_offsets[s];
    row_pass_kernel<<<grid, block, 0, st>>>(base, tmp, h, w,
                                            upsample2x ? 1 : 0, t, radii[s]);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    col_pass_kernel<<<grid, block, 0, st>>>(tmp, stack + (size_t)s * hw,
                                            (size_t)n_scales * hw, h, w, t,
                                            radii[s]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dog_scan_kernel<<<grid, block, 0, st>>>(stack, dog, seed, masks, mask16,
                                          n_scales, h, w, spo, contrast_thr);
  return (int)cudaGetLastError();
}

// Message for a code returned by one of the library's entry points.
extern "C" const char* sift_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
