// The separable blur on a tile held in shared memory: the window fill, the
// row pass and the column pass that the fused octave kernel (octave.cu)
// and the stand-alone blur (blur.cu) are both made of.
//
// A block of kThreads threads owns a tile of one plane. With R the largest
// radius it blurs with, it loads the tile's window (the tile and a halo of
// R each way) from device memory once; a row pass takes the window to a
// row buffer and a column pass takes the row buffer to the blurred tile,
// both in shared memory. What the passes cost on this card is
// instructions and latency, not bytes: a tap is a product and a sum (two
// instructions, no fused multiply-add), every load of a value or a tap
// takes a slot beside them, and at small radii a thread's fixed work per
// item (indices, the first tap, the stores) weighs as much as its taps. So
// a thread produces kOut consecutive outputs along the pass direction from
// a sliding register window (one load of a value feeds kOut products and
// sums), the host works out the divisions' magic numbers, and the window is
// filled by asynchronous copies that are all in flight at once.
//
// A radius so large that this window does not fit a block's shared memory
// (the last octaves of a deep pyramid: radius 116 on a 60x80 plane) takes
// the clamped mode of the same passes: there is no window, the row pass
// taps the plane in device memory (through L1 and L2: such planes are
// small, or the radius reuses every value hundreds of times), over the
// plane's rows only, and every tap of both passes clamps its index. Only
// the row buffer and the taps have to fit then: a radius up to about 1,000
// on any plane, and a larger one on a plane of fewer than about 2,000 rows.
//
// Exactness rules (the plain PyTorch version is ops/gaussian.py::
// blur_separable, and the two agree bit for bit):
// - clamp-to-edge is an index clamp on the plane's grid, never on the
//   tile's: window entry (i, j) holds the plane at the clamped logical
//   coordinate, computed once per entry, and taps index the window by the
//   unclamped position. A halo value computed by one block is therefore
//   the same number as the owner block's;
// - with shift = 1 the plane is the 2x nearest upsample of a
//   half-resolution source, L(y, x) = src[y >> 1][x >> 1], bit-exact;
// - products and sums are rounded separately (__fmul_rn/__fadd_rn, and
//   the build passes -fmad=false): a fused multiply-add would round once
//   and differ from the plain tap loop;
// - taps accumulate in tap order, acc = v0*t0; acc = acc + v_t*t_t, row
//   pass (x) first, then column pass (y).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 4;  // consecutive outputs of a thread along a pass

// Shared-memory layout of a tile_h x tile_w tile with a ring of ``ring``
// pixels around it (the fused octave's scan reads a 3x3 neighbourhood:
// ring 1; the stand-alone blur: ring 0) of an h x w plane, blurred with
// radii up to ``rmax``. The computed extent (tile plus ring) is rounded up
// to whole groups of kOut; the window adds rmax each way; strides walked by
// the lanes of a warp are odd, so that such a walk touches 32 different
// banks. In clamped mode there is no window and the row buffer holds the
// rows of that reach that lie inside the plane (at most h).
// The host-side planner (ops/kernels/tiles.py::tile_layout) chooses the tile
// by the same arithmetic; every launch carries the planner's byte count and
// is refused where the two differ.
struct TileLayout {
  int ngx, ngy;  // groups of kOut outputs across and down the extent
  int cw, ch;    // computed extent: kOut * ngx columns, kOut * ngy rows
  int ws, wh;    // window: row stride (odd) and rows; wh also the row buffer's
  int ds;        // row stride of the row buffer (odd)
  int window;    // floats of the window (0 in clamped mode)
  int floats;    // window + row buffer + planes * ch * cw + n_taps
};

__host__ __device__ inline TileLayout tile_layout(int tile_h, int tile_w,
                                                  int ring, int rmax,
                                                  int planes, int n_taps,
                                                  int h, bool clamped) {
  TileLayout t;
  t.ngx = (tile_w + 2 * ring + kOut - 1) / kOut;
  t.ngy = (tile_h + 2 * ring + kOut - 1) / kOut;
  t.cw = kOut * t.ngx;
  t.ch = kOut * t.ngy;
  t.wh = t.ch + 2 * rmax;
  if (clamped && t.wh > h) t.wh = h;
  t.ws = (t.cw + 2 * rmax) | 1;
  t.ds = t.cw | 1;
  t.window = clamped ? 0 : t.wh * t.ws;
  t.floats = t.window + t.wh * t.ds + planes * t.ch * t.cw + n_taps;
  return t;
}

__device__ __forceinline__ int clamp_index(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// n / d as a multiplication by magic_of(d) = ceil(2^32 / d): exact for
// n * d < 2^32 / d (a tile's items and extents are far below). 2^32 does
// not fit for d = 1: magic_of(1) is 0, which div_by reads as "n itself". Where the divisor is the same for every
// block, the host works the magic number out and the launch carries it.
__host__ __device__ inline unsigned magic_of(int d) {
  return d == 1 ? 0u : 0xFFFFFFFFu / (unsigned)d + 1u;
}
__device__ __forceinline__ int div_by(int n, unsigned magic) {
  return magic == 0u ? n : (int)__umulhi((unsigned)n, magic);
}

// win[i][j] = L(clamp(oy + i), clamp(ox + j)) for i < rows, j < cols, with
// L the logical (h, w) plane over ``src`` (see ``shift`` above) and ``ws``
// the window's row stride. A warp walks a row, so the reads coalesce; every
// entry is an asynchronous copy (cp.async), so a thread has all its entries
// in flight at once and pays the device memory's latency once. The window
// is complete for the block after the __syncthreads that follows.
template <int kThreads>
__device__ __forceinline__ void fill_window(const float* __restrict__ src,
                                            int h, int w, int shift, int oy,
                                            int ox, float* win, int rows,
                                            int cols, int ws) {
  const int lane = threadIdx.x & 31;
  const int src_w = w >> shift;
  for (int i = threadIdx.x >> 5; i < rows; i += kThreads / 32) {
    const float* row =
        src + (size_t)(clamp_index(oy + i, 0, h - 1) >> shift) * src_w;
    for (int j = lane; j < cols; j += 32) {
      __pipeline_memcpy_async(
          win + i * ws + j, row + (clamp_index(ox + j, 0, w - 1) >> shift),
          sizeof(float));
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

template <int kThreads>
__device__ __forceinline__ void copy_taps(const float* __restrict__ taps,
                                          float* dst, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = taps[i];
}

// acc[k] = sum_t taps[t] * value(k + t) for k < kOut and t <= 2r, in tap
// order, from a sliding register window: one load of a value a tap.
// value(i) is p[i * stride]; in clamped mode it is
// p[(clamp(base + i, lo, hi) >> shift) * stride].
template <bool kClamp>
__device__ __forceinline__ void tap_line(const float* p, int stride, int base,
                                         int lo, int hi, int shift,
                                         const float* taps, int r,
                                         float (&acc)[kOut]) {
  auto value = [&](int i) {
    return p[(kClamp ? clamp_index(base + i, lo, hi) >> shift : i) * stride];
  };
  float v[kOut];
  const float t0 = taps[0];
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    v[k] = value(k);
    acc[k] = __fmul_rn(v[k], t0);
  }
#pragma unroll 4
  for (int t = 1; t <= 2 * r; ++t) {
#pragma unroll
    for (int k = 0; k < kOut - 1; ++k) v[k] = v[k + 1];
    v[kOut - 1] = value(t + kOut - 1);
    const float tap = taps[t];
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      acc[k] = __fadd_rn(acc[k], __fmul_rn(v[k], tap));
    }
  }
}

// Row pass: dst[y][x] = sum_t taps[t] * win[y][x + t] for y < nrows and
// x < kOut * ngx (``magic`` is magic_of(nrows)); the caller offsets ``win``
// so that tap 0 of output 0 is win[0][0]. A thread owns kOut consecutive x
// of one row; the lanes of a warp walk down the rows, which the odd strides
// keep free of bank conflicts. In clamped mode ``win`` is the source in
// device memory and ``ws`` its row stride, row y of the output is logical
// plane row y_base + y and tap t of output x is logical column
// clamp(x_base + x + t, 0, x_hi), both >> shift in the source; the lanes
// then walk along the row first, and ``magic`` is magic_of(ngx).
template <int kThreads, bool kClamp>
__device__ __forceinline__ void row_pass_tile(const float* win, int ws,
                                              int y_base, int x_base, int x_hi,
                                              int shift, const float* taps,
                                              int r, float* dst, int ds,
                                              int nrows, unsigned magic,
                                              int ngx) {
  const int n_items = nrows * ngx;
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    int g, y;
    if (kClamp) {  // lanes along the row: their loads of device memory coalesce
      y = div_by(item, magic);
      g = item - y * ngx;
    } else {
      g = div_by(item, magic);
      y = item - g * nrows;
    }
    const float* row = kClamp ? win + (size_t)((y_base + y) >> shift) * ws
                              : win + y * ws + g * kOut;
    float acc[kOut];
    tap_line<kClamp>(row, 1, x_base + g * kOut, 0, x_hi, shift, taps, r, acc);
    float* q = dst + y * ds + g * kOut;
#pragma unroll
    for (int k = 0; k < kOut; ++k) q[k] = acc[k];
  }
}

// Column pass: emit(y, x, sum_t taps[t] * src[y + t][x]) for y < kOut * ngy
// and x < ncols (``magic`` is magic_of(ncols)). In clamped mode the source
// row is clamp(y_base + y + t, y_lo, y_hi) instead of y + t. A thread owns
// kOut consecutive y of one column; the lanes of a warp walk along a row.
template <int kThreads, bool kClamp, typename Emit>
__device__ __forceinline__ void col_pass_tile(const float* src, int ds,
                                              int y_base, int y_lo, int y_hi,
                                              const float* taps, int r,
                                              int ngy, int ncols,
                                              unsigned magic, Emit emit) {
  const int n_items = ngy * ncols;
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    const int g = div_by(item, magic);
    const int x = item - g * ncols;
    float acc[kOut];
    tap_line<kClamp>(src + x + (kClamp ? 0 : g * kOut * ds), ds,
                     y_base + g * kOut, y_lo, y_hi, 0, taps, r, acc);
#pragma unroll
    for (int k = 0; k < kOut; ++k) emit(g * kOut + k, x, acc[k]);
  }
}

// The plane rows a block's row buffer holds: its first plane row and their
// number. Unclamped, the tile plus ring plus rmax each way whatever the
// plane (the window's rows); clamped, the part of that inside the plane.
struct RowSpan {
  int oy, rows;
};

template <bool kClamp>
__device__ __forceinline__ RowSpan row_span(const TileLayout& lay, int y0,
                                            int ring, int rmax, int h) {
  RowSpan s = {y0 - ring - rmax, lay.wh};
  if (kClamp) {
    const int y1 = min(s.oy + lay.ch + 2 * rmax, h);
    s.oy = max(s.oy, 0);
    s.rows = y1 - s.oy;
  }
  return s;
}

}  // namespace
