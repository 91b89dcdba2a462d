// One separable Gaussian blur on Hopper (sm_90a) in one launch: both
// passes on a tile held in shared memory, clamp-to-edge as an index clamp.
//
// Replaces the Pallas TPU kernel
//   sift_scale_space_extrema_detection_tpu/ops/pallas/blur.py::blur_pallas
//   (kernel body _blur_stripe_kernel).
// The plain PyTorch version is ops/gaussian.py::blur_separable; the two
// round every product and sum identically (see blur_passes.cuh), so on the
// card they agree bit for bit.
//
// What bounds it on this card: by the contract, bytes, up to a radius of
// about 40 — one read and one write of the plane against 2(2r+1) flop per
// pixel and pass, where the card's float32 line is ~20 flop/byte. What the
// kernel has to watch is the SM's instruction rate: a tap is a product and
// a sum (no fused multiply-add), and every shared-memory load competes with
// them.
//
// What this design does about it: the tile passes of the fused octave
// kernel (blur_passes.cuh). A block loads its tile's window (tile + radius
// each way) once, runs the row pass into a shared row buffer and the
// column pass straight to the output: the plane crosses device memory
// twice, plus the halo. The wrapper's planner (../tiles.py) picks the tile.
// The TPU kernel's stripe planner, edge padding and size gate are sizing
// for that chip's fast memory; here a radius whose window does not fit the
// block's shared memory takes the passes' clamped mode, a second
// instantiation of the kernel (no window: the row pass taps the plane in
// device memory over the plane's rows only, every tap clamping its index).

#include <cuda_runtime.h>

#include "blur_passes.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kClamp>
__global__ void __launch_bounds__(kThreads)
blur_kernel(const float* __restrict__ src, float* __restrict__ dst, int h,
            int w, const float* __restrict__ taps, int r, int tile_h,
            int tile_w, unsigned row_magic, unsigned col_magic) {
  extern __shared__ float smem[];
  const TileLayout lay =
      tile_layout(tile_h, tile_w, 0, r, 0, 2 * r + 1, h, kClamp);
  float* win = smem;
  float* rowbuf = win + lay.window;
  float* staps = rowbuf + lay.wh * lay.ds;

  const int x0 = blockIdx.x * tile_w;
  const int y0 = blockIdx.y * tile_h;
  const size_t plane = (size_t)blockIdx.z * h * w;

  const RowSpan span = row_span<kClamp>(lay, y0, 0, r, h);
  copy_taps<kThreads>(taps, staps, 2 * r + 1);
  if (!kClamp) {
    fill_window<kThreads>(src + plane, h, w, 0, span.oy, x0 - r, win, lay.wh,
                          lay.ws, lay.ws);
  }
  __syncthreads();
  if (kClamp) {
    row_pass_tile<kThreads, true>(src + plane, w, span.oy, x0 - r, w - 1, 0,
                                  staps, r, rowbuf, lay.ds, span.rows,
                                  magic_of(lay.ngx), lay.ngx);
  } else {
    row_pass_tile<kThreads, false>(win, lay.ws, 0, 0, 0, 0, staps, r, rowbuf,
                                   lay.ds, lay.wh, row_magic, lay.ngx);
  }
  __syncthreads();
  float* out = dst + plane;
  col_pass_tile<kThreads, kClamp>(
      rowbuf, lay.ds, y0 - r - span.oy, -span.oy, h - 1 - span.oy, staps, r,
      lay.ngy, lay.cw, col_magic, [&](int y, int x, float v) {
        if (y0 + y < h && x0 + x < w) {
          out[(size_t)(y0 + y) * w + x0 + x] = v;
        }
      });
}

}  // namespace

// Blur ``src`` (B, H, W) with the ``2 * radius + 1`` taps at ``taps``
// (device memory) into ``dst`` (B, H, W), in one launch on ``stream``.
// ``tile_h`` and ``tile_w`` (multiples of 4) are the block's tile and
// ``clamped`` the mode of the passes, chosen by the caller so that the
// block's shared memory fits; ``shared_bytes`` is the caller's count of that
// memory, and a launch whose own count differs is refused
// (cudaErrorInvalidValue). Returns a cudaError_t, 0 for success.
extern "C" int sift_blur(const float* src, int batch, int h, int w,
                         const float* taps, int radius, int tile_h,
                         int tile_w, int clamped, int shared_bytes, float* dst,
                         void* stream) {
  if (tile_h < 4 || tile_h % 4 != 0 || tile_w < 4 || tile_w % 4 != 0 ||
      radius < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bytes = 4 * tile_layout(tile_h, tile_w, 0, radius, 0,
                                    2 * radius + 1, h, clamped != 0)
                            .floats;
  if (bytes != shared_bytes) return (int)cudaErrorInvalidValue;
  auto kernel = clamped ? blur_kernel<true> : blur_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, batch);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      src, dst, h, w, taps, radius, tile_h, tile_w,
      magic_of(tile_h + 2 * radius), magic_of(tile_w));
  return (int)cudaGetLastError();
}
