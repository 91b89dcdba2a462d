// One SIFT octave on Hopper (sm_90a) in one launch: all Gaussian scales,
// the DoG planes, the next octave's seed scale and the packed 26-neighbour
// extrema masks, with the Gaussian stack kept in shared memory.
//
// Replaces the Pallas TPU kernel
//   sift_scale_space_extrema_detection_tpu/ops/pallas/octave.py::fused_octave
//   (kernel body _octave_kernel).
// The plain PyTorch version is fused_octave_reference in ../octave.py; the
// two round every product, sum and difference identically, so on the card
// they agree bit for bit.
//
// What bounds it on this card: by the contract, bytes — the base is read
// once and the DoG planes, the seed and the masks are written once (with
// emit_scales the Gaussian scales too), a few flop per byte against the
// card's ~20. What the kernel has to watch is the SM's instruction rate: a
// pixel of octave 0 takes ~68 taps per pass, each a product and a sum because a
// fused multiply-add would change the rounding; every shared-memory load
// and every minimum or maximum of the scan (half rate) takes its slots
// from them, and the halo repeats part of the work.
//
// What this design does about it. A block of 512 threads owns a tile of one
// image's octave plane (at most 2048 pixels) and produces everything for it:
// 1. it loads the tile's window of the base (tile + ring of 1 + the
//    octave's largest radius each way) into shared memory once, filled by
//    clamped plane coordinates (and >> 1 for octave 0's 2x nearest
//    upsample), so taps need no clamp;
// 2. for each scale in turn, a row pass (window -> row buffer) and a column
//    pass (row buffer -> L_s on the tile plus ring), each thread producing
//    kOut consecutive outputs from a sliding register window
//    (blur_passes.cuh);
// 3. the column pass forms D_{s-1} = L_{s-1} - L_s on the tile plus ring in
//    shared memory; then each thread, for the column of four pixels it
//    owns, reads their 3x3 neighbourhoods of D once, writes D's centre to
//    ``dog`` and slides three planes' min/max through registers: the strict
//    26-neighbour test with the contrast prefilter, ORed into the pixel's
//    packed code;
// 4. device memory sees the window read and the outputs written, a warp
//    along a row, and nothing else: no Gaussian scale crosses it unless the
//    caller asked for the stack.
// Two __syncthreads per scale order the reuse of the row buffer and of the
// L and D planes. The halo makes the row pass redundant by
// (tile_h + 2r + 2) / tile_h; the wrapper's planner (../tiles.py) picks the
// tile that does the least work among those that fit shared memory. Where
// the radius is too large for any window (the last octaves of a deep
// pyramid), it picks the clamped mode of the passes, a second instantiation
// of this kernel: no window, the row pass taps the base in device memory
// with a clamp per tap, over the plane's rows only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blur_passes.cuh"

namespace {

// 512 threads that each own one column of kStrip pixels in the scan: the
// scan state fits 64 registers a thread, so two blocks (32 warps) share an
// SM.
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
constexpr int kStrip = 4;
constexpr int kMaxTilePixels = kThreads * kStrip;
constexpr int kMaxScales = 19;  // 16 trios of 2 bits fill an int32 mask

struct ScaleTaps {
  int offset[kMaxScales];  // of scale s's taps in the tap array
  int radius[kMaxScales];
  unsigned row_magic[kMaxScales];  // magic_of(the row pass's rows at scale s)
  unsigned col_magic;              // magic_of(the column pass's columns)
};

// Sliding state of one pixel: plane q-2's 3x3 min/max and plane q-1's
// 8-neighbour ring min/max and centre (kept apart so the test is strict).
struct ScanState {
  float lo_min, lo_max, ring_min, ring_max, ctr;
};

template <bool kClamp>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_octave_kernel(const float* __restrict__ base, int h, int w, int shift,
                    const float* __restrict__ taps, int n_taps,
                    const __grid_constant__ ScaleTaps scales, int n_scales,
                    int spo, float thr, int tile_h, int tile_w, int rmax,
                    float* __restrict__ dog, float* __restrict__ seed,
                    float* __restrict__ stack, void* __restrict__ masks,
                    int mask16) {
  extern __shared__ float smem[];
  const TileLayout lay =
      tile_layout(tile_h, tile_w, 1, rmax, 2, n_taps, h, kClamp);
  float* win = smem;
  float* rowbuf = win + lay.window;
  float* lprev = rowbuf + lay.wh * lay.ds;  // L_s on the tile plus ring
  float* dplane = lprev + lay.ch * lay.cw;  // D_{s-1} on the tile plus ring
  float* staps = dplane + lay.ch * lay.cw;

  const int x0 = blockIdx.x * tile_w;
  const int y0 = blockIdx.y * tile_h;
  const int b = blockIdx.z;
  const size_t hw = (size_t)h * w;
  const float* src = base + (size_t)b * (h >> shift) * (w >> shift);
  float* dog_b = dog + (size_t)b * (n_scales - 1) * hw;
  float* seed_b = seed + (size_t)b * hw;
  float* stack_b = stack ? stack + (size_t)b * n_scales * hw : nullptr;

  const RowSpan span = row_span<kClamp>(lay, y0, 1, rmax, h);
  copy_taps<kThreads>(taps, staps, n_taps);
  if (!kClamp) {
    fill_window<kThreads>(src, h, w, shift, span.oy, x0 - 1 - rmax, win,
                          lay.wh, lay.ws, lay.ws);
  }

  // The pixels this thread owns in the scan: the column of kStrip pixels at
  // tile column sx, from tile row kStrip * strip down. ``centre`` is its
  // first pixel in the tile-plus-ring planes, ``pixel`` in the image's
  // planes. Bit k of ``inside`` says pixel k lies in the plane, bit k of
  // ``inner`` that it may hold an extremum.
  const int strip = threadIdx.x / tile_w;
  const int sx = threadIdx.x - strip * tile_w;
  const int centre = (strip * kStrip + 1) * lay.cw + sx + 1;
  const int pixel = (y0 + strip * kStrip) * w + x0 + sx;
  int inside = 0, inner = 0;
  ScanState st[kStrip];
  int packed[kStrip];
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    const int x = x0 + sx;
    const int y = y0 + strip * kStrip + k;
    const bool in = strip * kStrip < tile_h && x < w && y < h;
    inside |= (int)in << k;
    inner |= (int)(in && x >= 1 && x <= w - 2 && y >= 1 && y <= h - 2) << k;
    packed[k] = 0;
    st[k] = ScanState{0.f, 0.f, 0.f, 0.f, 0.f};
  }
  __syncthreads();

  for (int s = 0; s < n_scales; ++s) {
    const int r = scales.radius[s];
    const float* t = staps + scales.offset[s];
    // Unclamped: row buffer row i is plane row y0 - 1 - r + i; window row 0
    // is plane row y0 - 1 - rmax, window column 0 plane column
    // x0 - 1 - rmax. Clamped: row buffer row i is plane row span.oy + i,
    // tapped from the base in device memory, and the taps clamp to the plane.
    if (kClamp) {
      row_pass_tile<kThreads, true>(src, w >> shift, span.oy, x0 - 1 - r,
                                    w - 1, shift, t, r, rowbuf, lay.ds,
                                    span.rows, magic_of(lay.ngx), lay.ngx);
    } else {
      row_pass_tile<kThreads, false>(win + (rmax - r) * (lay.ws + 1), lay.ws,
                                     0, 0, 0, 0, t, r, rowbuf, lay.ds,
                                     lay.ch + 2 * r, scales.row_magic[s],
                                     lay.ngx);
    }
    __syncthreads();
    col_pass_tile<kThreads, kClamp>(
        rowbuf, lay.ds, y0 - 1 - r - span.oy, -span.oy, h - 1 - span.oy, t, r,
        lay.ngy, lay.cw, scales.col_magic, [&](int y, int x, float v) {
          const int i = y * lay.cw + x;
          if (s > 0) dplane[i] = __fsub_rn(lprev[i], v);
          lprev[i] = v;
        });
    __syncthreads();
    if (inside == 0) continue;  // no barrier below: the thread may skip

    if (stack_b != nullptr || s == spo) {
#pragma unroll
      for (int k = 0; k < kStrip; ++k) {
        if (!(inside >> k & 1)) continue;
        const float v = lprev[centre + k * lay.cw];
        if (stack_b != nullptr) stack_b[s * hw + pixel + k * w] = v;
        if (s == spo) seed_b[pixel + k * w] = v;
      }
    }
    if (s == 0) continue;
    const int q = s - 1;  // the DoG plane just formed
    // The 3x3 neighbourhoods of the kStrip pixels: kStrip + 2 rows.
    float d[kStrip + 2][3];
    const float* dp = dplane + centre - lay.cw - 1;
#pragma unroll
    for (int i = 0; i < kStrip + 2; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) d[i][c] = dp[i * lay.cw + c];
    }
    // Each row's min/max without and with its middle value, shared by the
    // pixels above and below (min and max are exact: their order is free).
    float side_min[kStrip + 2], side_max[kStrip + 2];
    float row_min[kStrip + 2], row_max[kStrip + 2];
#pragma unroll
    for (int i = 0; i < kStrip + 2; ++i) {
      side_min[i] = fminf(d[i][0], d[i][2]);
      side_max[i] = fmaxf(d[i][0], d[i][2]);
      row_min[i] = fminf(side_min[i], d[i][1]);
      row_max[i] = fmaxf(side_max[i], d[i][1]);
    }
#pragma unroll
    for (int k = 0; k < kStrip; ++k) {
      const float ctr = d[k + 1][1];
      if (inside >> k & 1) dog_b[q * hw + pixel + k * w] = ctr;
      const float ring_min =
          fminf(fminf(row_min[k], row_min[k + 2]), side_min[k + 1]);
      const float ring_max =
          fmaxf(fmaxf(row_max[k], row_max[k + 2]), side_max[k + 1]);
      const float min9 = fminf(ring_min, ctr);
      const float max9 = fmaxf(ring_max, ctr);
      ScanState& p = st[k];
      if (q >= 2 && (inner >> k & 1)) {
        const float nb_min = fminf(fminf(p.lo_min, min9), p.ring_min);
        const float nb_max = fmaxf(fmaxf(p.lo_max, max9), p.ring_max);
        const bool is_ext = (p.ctr > nb_max) || (p.ctr < nb_min);
        const int code = is_ext ? (fabsf(p.ctr) >= thr ? 1 : 2) : 0;
        packed[k] |= code << (2 * (q - 2));
      }
      p.lo_min = fminf(p.ring_min, p.ctr);
      p.lo_max = fmaxf(p.ring_max, p.ctr);
      p.ring_min = ring_min;
      p.ring_max = ring_max;
      p.ctr = ctr;
    }
  }

#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    if (!(inside >> k & 1)) continue;
    const size_t i = (size_t)b * hw + pixel + k * w;
    if (mask16) {
      static_cast<int16_t*>(masks)[i] = (int16_t)packed[k];
    } else {
      static_cast<int32_t*>(masks)[i] = packed[k];
    }
  }
}

}  // namespace

// One octave for a batch of B bases, in one launch. ``h``, ``w`` are the
// logical plane size (2x the base's with ``upsample2x``). Scale s blurs
// with the ``2 * radii[s] + 1`` taps at ``taps + tap_offsets[s]`` (device
// memory, scale after scale; ``radii`` and ``tap_offsets`` are host
// arrays). ``tile_h`` (a multiple of 4) and ``tile_w`` are the block's
// tile, at most 2048 pixels, and ``clamped`` the mode of the passes, both
// chosen by the caller so that the block's shared memory fits;
// ``shared_bytes`` is the caller's count of that memory, and a launch whose
// own count differs is refused (cudaErrorInvalidValue).
// ``dog`` (B, S-1, H, W), ``seed`` (B, H, W) and
// ``masks`` (B, H, W, int16 when ``mask16`` else int32) are written, and
// ``stack`` (B, S, H, W), the Gaussian scales, unless it is null. The
// launch goes on ``stream``; returns a cudaError_t, 0 for success.
extern "C" int sift_fused_octave(const float* base, int batch, int h, int w,
                                 int upsample2x, const float* taps,
                                 const int* tap_offsets, const int* radii,
                                 int n_scales, int spo, float contrast_thr,
                                 int tile_h, int tile_w, int clamped,
                                 int shared_bytes, float* stack, float* dog, float* seed,
                                 void* masks, int mask16, void* stream) {
  if (n_scales < 2 || n_scales > kMaxScales || tile_h < kStrip ||
      tile_h % kStrip != 0 || tile_w < 1 ||
      tile_h * tile_w > kMaxTilePixels) {
    return (int)cudaErrorInvalidValue;
  }
  ScaleTaps scales;
  int rmax = 0;
  for (int s = 0; s < n_scales; ++s) {
    scales.offset[s] = tap_offsets[s];
    scales.radius[s] = radii[s];
    if (radii[s] > rmax) rmax = radii[s];
  }
  const int n_taps = tap_offsets[n_scales - 1] + 2 * radii[n_scales - 1] + 1;
  const TileLayout lay =
      tile_layout(tile_h, tile_w, 1, rmax, 2, n_taps, h, clamped != 0);
  for (int s = 0; s < n_scales; ++s) {
    scales.row_magic[s] = magic_of(lay.ch + 2 * radii[s]);
  }
  scales.col_magic = magic_of(lay.cw);
  const int bytes = 4 * lay.floats;
  if (bytes != shared_bytes) return (int)cudaErrorInvalidValue;
  auto kernel =
      clamped ? fused_octave_kernel<true> : fused_octave_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, batch);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      base, h, w, upsample2x ? 1 : 0, taps, n_taps, scales, n_scales, spo,
      contrast_thr, tile_h, tile_w, rmax, dog, seed, stack, masks, mask16);
  return (int)cudaGetLastError();
}

// Message for a code returned by one of the library's entry points.
extern "C" const char* sift_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
