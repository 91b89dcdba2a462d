// The describe layer's two sampling stages, each one launch, on Hopper
// (sm_90a): R3 ``orient_slots`` (orientation) and R4 ``describe_pairs``
// (descriptor).
//
// They replace no TPU kernel: the JAX package runs the histograms around its
// window-sampling kernel as array code, and so does the port's tensor code
// (ops/descriptor.py: _orientation_coords -> window_sample_pair ->
// _orientation_post -> _smooth_circular -> _extract_peaks, and
// _descriptor_coords -> window_sample_pair -> _descriptor_post), which stays
// as their plain version for CPU tensors and explicit samplers.
//
// Contract. A slot is a keypoint (R3) or a (keypoint, orientation) pair (R4):
// slots[m] = {batch, octave, scale_level, valid}, with its octave-local
// position and scale (y_loc, x_loc, sigma_loc)[m], and for R4 its θ. The
// samples are K2's (gradient_sample.cuh, shared with describe.cu), at the
// coordinates the tensor code forms, every product and sum rounded on its
// own, with the IEEE functions the tensor code runs on the card (expf,
// atan2f, sinf, cosf, correctly rounded division and square root; the
// library is built without --use_fast_math and with -fmad=false).
// - R3 writes (theta, valid) (M, k): the k strongest peaks of the smoothed
//   36-bin histogram, strictly above both neighbours and at least
//   peak_ratio x its largest bin, in descending order, equal peaks lower bin
//   first, each placed by a parabola; theta = 0 where valid is false.
// - R4 writes the (M, cells x n_ori) descriptors: each sample's weight split
//   over its two orientation bins and its bilinear spatial cells, normalised,
//   clamped at clip x the norm and normalised again.
// An invalid slot, or one whose octave is not in the table, reads nothing:
// R3 writes theta 0 and valid false, R4 zeros. The histograms differ from
// the tensor code's only in the order of their sums (it sums by matrix
// products), ~1e-7 relative a bin.
//
// What bounds it on this card: neither bytes nor operations, at these
// sizes. The work is ~60 float operations and 16 cached loads a sample, for
// valid slots alone; the bytes are the slot fields in and the outputs out.
// The tensor code it replaces wrote every slot's 256 samples, a (M, 256, 36)
// one-hot and several (M, 8, 256) splits to device memory (gigabytes a
// batch) and ran ~250 operations a batch; most slots are empty
// (describe_capacity() is sized for the densest frame).
//
// What this design does about it: one warp a slot, so that an empty slot
// costs one read of its row of the table and one short write; a valid
// slot's samples and histogram stay in shared memory and registers. The
// sums are deterministic, in a fixed order with no atomics: each sample's
// (bin, weight) is staged in shared memory, then each bin is summed by one
// lane in sample order (R3), or over the samples of its spatial cell in
// sample order (R4: the cell lists are constants of the configuration,
// built on the host beside _descriptor_constants). A rerun is bit-equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gradient_sample.cuh"

namespace {

using sift_sample::OctaveTable;

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;        // warps (slots) a block
constexpr int kMaxOriBins = 64;     // R3: two bins a lane
constexpr int kMaxDescBins = 256;   // R4: eight bins a lane
constexpr int kMaxSamples = 1024;   // a 32 x 32 grid
constexpr int kSharedLimit = 48 * 1024;

struct OrientParams {
  int n_samples;     // G², the unit grid's points
  int nbins;         // orientation bins
  int n_peaks;       // k, orientations kept a slot
  int smooth;        // box-filter passes
  float radius_factor;  // 3 λ_ori
  float lambda;         // λ_ori
  float peak_ratio;
  float two_pi;         // float32(2π)
};

struct DescribeParams {
  int n_samples;   // G²
  int n_ori;       // orientation bins a cell
  int n_cells;     // spatial cells (nh²)
  int cell_len;    // entries a cell list (padded with -1)
  float clip;
  float two_pi;
};

// torch.remainder for float32: fmod, then the divisor's sign.
__device__ __forceinline__ float remainder_f(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m = __fadd_rn(m, b);
  return m;
}

// A stage's slot: its plane, or nullptr where it reads nothing.
struct Slot {
  const float* plane;
  int h, w;
};

__device__ __forceinline__ Slot load_slot(const OctaveTable& table,
                                          int n_octaves, int batch,
                                          int n_scales, int4 slot) {
  Slot s{nullptr, 0, 0};
  s.plane = sift_sample::slot_plane(table, n_octaves, batch, n_scales, slot,
                                    s.h, s.w);
  return s;
}

// The interior the gradients need: one pixel of margin (_inbounds_mask).
__device__ __forceinline__ bool inside(float ys, float xs, int h, int w) {
  return ys >= 1.f && ys <= (float)h - 2.f && xs >= 1.f && xs <= (float)w - 2.f;
}

// ---------------------------------------------------------------------------
// R3: orientation
// ---------------------------------------------------------------------------

// (value, bin) of the better of two peaks: higher value, then lower bin.
__device__ __forceinline__ void better(float& v, int& b, float v2, int b2) {
  if (v2 > v || (v2 == v && b2 < b)) {
    v = v2;
    b = b2;
  }
}

__global__ void orient_slots_kernel(
    const __grid_constant__ OctaveTable table, int n_octaves, int batch,
    int n_scales, const int4* __restrict__ slots,
    const float* __restrict__ y_loc, const float* __restrict__ x_loc,
    const float* __restrict__ sigma_loc, const float* __restrict__ uy,
    const float* __restrict__ ux, const OrientParams p, long long n_slots,
    float* __restrict__ theta_out, bool* __restrict__ valid_out) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long m = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (m >= n_slots) return;  // the whole warp
  // This warp's (bin, weight) a sample, then the histogram.
  int2* staged = reinterpret_cast<int2*>(shared) + (size_t)warp * p.n_samples;
  float* hist = reinterpret_cast<float*>(
                    reinterpret_cast<int2*>(shared) +
                    (size_t)(blockDim.x / kWarp) * p.n_samples) +
                warp * kMaxOriBins;
  const int k = p.n_peaks;
  const Slot s = load_slot(table, n_octaves, batch, n_scales, slots[m]);
  if (s.plane == nullptr) {
    for (int j = lane; j < k; j += kWarp) {
      theta_out[m * k + j] = 0.f;
      valid_out[m * k + j] = false;
    }
    return;
  }
  const float yl = y_loc[m], xl = x_loc[m], sigma = sigma_loc[m];
  const float radius = __fmul_rn(sigma, p.radius_factor);
  const float r2 = __fmul_rn(radius, radius);
  const float ls = __fmul_rn(p.lambda, sigma);
  const float sig2 = __fmul_rn(2.f, __fmul_rn(ls, ls));
  const float nbins_f = (float)p.nbins;

  for (int i = lane; i < p.n_samples; i += kWarp) {
    const float dy = __fmul_rn(uy[i], radius);
    const float dx = __fmul_rn(ux[i], radius);
    const float ys = __fadd_rn(yl, dy);
    const float xs = __fadd_rn(xl, dx);
    const float d2 = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
    float gy, gx;
    sift_sample::sample_gradient(s.plane, s.h, s.w, ys, xs, gy, gx);
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(gy, gy), __fmul_rn(gx, gx)));
    const float ang = remainder_f(atan2f(gy, gx), p.two_pi);
    float weight = __fmul_rn(expf(__fdiv_rn(-d2, sig2)), mag);
    if (!(d2 <= r2) || !inside(ys, xs, s.h, s.w)) weight = 0.f;
    // θ/2π·nbins can round up to nbins, hence the modulo.
    int bin = (int)floorf(__fmul_rn(__fdiv_rn(ang, p.two_pi), nbins_f));
    bin = ((bin % p.nbins) + p.nbins) % p.nbins;
    staged[i] = make_int2(bin, __float_as_int(weight));
  }
  __syncwarp();

  // Bins lane and lane + 32, each summed in sample order.
  float acc0 = 0.f, acc1 = 0.f;
  for (int i = 0; i < p.n_samples; ++i) {
    const int2 e = staged[i];
    const float v = __int_as_float(e.y);
    if (e.x == lane) acc0 = __fadd_rn(acc0, v);
    if (e.x == lane + kWarp) acc1 = __fadd_rn(acc1, v);
  }
  const int nb = p.nbins;
  const bool own0 = lane < nb, own1 = lane + kWarp < nb;
  if (own0) hist[lane] = acc0;
  if (own1) hist[lane + kWarp] = acc1;
  __syncwarp();

  // Circular [1, 1, 1] / 3, ``smooth`` times: (h[b-1] + h[b]) + h[b+1].
  const int b0 = lane, b1 = lane + kWarp;
  for (int it = 0; it < p.smooth; ++it) {
    float n0 = 0.f, n1 = 0.f;
    if (own0)
      n0 = __fdiv_rn(__fadd_rn(__fadd_rn(hist[(b0 + nb - 1) % nb], hist[b0]),
                               hist[(b0 + 1) % nb]), 3.f);
    if (own1)
      n1 = __fdiv_rn(__fadd_rn(__fadd_rn(hist[(b1 + nb - 1) % nb], hist[b1]),
                               hist[(b1 + 1) % nb]), 3.f);
    __syncwarp();
    if (own0) hist[b0] = n0;
    if (own1) hist[b1] = n1;
    __syncwarp();
  }

  // Peaks: strictly above both neighbours, at least peak_ratio × the largest.
  float top = own0 ? hist[b0] : 0.f;
  if (own1) top = fmaxf(top, hist[b1]);
  for (int off = kWarp / 2; off > 0; off /= 2)
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
  const float threshold = __fmul_rn(p.peak_ratio, top);
  auto is_peak = [&](int b) {
    const float v = hist[b];
    return v > hist[(b + nb - 1) % nb] && v > hist[(b + 1) % nb] &&
           v >= threshold;
  };
  bool peak0 = own0 && is_peak(b0);
  bool peak1 = own1 && is_peak(b1);

  // The k strongest, one at a time: a warp arg-max by (value, lower bin).
  for (int j = 0; j < k; ++j) {
    float v = -INFINITY;
    int b = nb;
    if (peak0) better(v, b, hist[b0], b0);
    if (peak1) better(v, b, hist[b1], b1);
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
      const int bb = __shfl_xor_sync(0xffffffffu, b, off);
      better(v, b, v2, bb);
    }
    const bool found = b < nb && v > 0.f && isfinite(v);
    if (lane == 0) {
      float theta = 0.f;
      if (found) {
        const float hk = hist[b];
        const float hp = hist[(b + nb - 1) % nb];
        const float hn = hist[(b + 1) % nb];
        const float denom = __fadd_rn(__fsub_rn(hp, __fmul_rn(2.f, hk)), hn);
        const float offset =
            fabsf(denom) > 1e-12f
                ? __fdiv_rn(__fsub_rn(hp, hn), __fmul_rn(2.f, denom))
                : 0.f;
        theta = __fmul_rn(
            __fdiv_rn(__fadd_rn(__fadd_rn((float)b, 0.5f), offset), nbins_f),
            p.two_pi);
        theta = remainder_f(theta, p.two_pi);
      }
      theta_out[m * k + j] = theta;
      valid_out[m * k + j] = found;
    }
    if (b == b0) peak0 = false;
    if (b == b1) peak1 = false;
  }
}

// ---------------------------------------------------------------------------
// R4: descriptor
// ---------------------------------------------------------------------------

struct Staged {
  int bin;      // the lower orientation bin, in [0, n_ori)
  float frac;   // the share of the upper bin
  float weight;
};

__global__ void describe_pairs_kernel(
    const __grid_constant__ OctaveTable table, int n_octaves, int batch,
    int n_scales, const int4* __restrict__ slots,
    const float* __restrict__ y_loc, const float* __restrict__ x_loc,
    const float* __restrict__ sigma_loc, const float* __restrict__ theta_in,
    const float* __restrict__ yhat, const float* __restrict__ xhat,
    const float* __restrict__ window, const int* __restrict__ cell_index,
    const float* __restrict__ cell_weight, const DescribeParams p,
    long long n_slots, float* __restrict__ desc_out) {
  extern __shared__ __align__(16) unsigned char shared[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long m = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (m >= n_slots) return;  // the whole warp
  Staged* staged = reinterpret_cast<Staged*>(shared) + (size_t)warp * p.n_samples;
  const int n_bins = p.n_cells * p.n_ori;
  float* out = desc_out + (size_t)m * n_bins;
  const Slot s = load_slot(table, n_octaves, batch, n_scales, slots[m]);
  if (s.plane == nullptr) {
    for (int q = lane; q < n_bins; q += kWarp) out[q] = 0.f;
    return;
  }
  const float yl = y_loc[m], xl = x_loc[m], sigma = sigma_loc[m];
  const float theta = theta_in[m];
  const float ct = cosf(theta), st = sinf(theta);
  const float n_ori_f = (float)p.n_ori;

  for (int i = lane; i < p.n_samples; i += kWarp) {
    const float yh = yhat[i], xh = xhat[i];
    const float ys = __fadd_rn(
        yl, __fmul_rn(sigma, __fadd_rn(__fmul_rn(st, xh), __fmul_rn(ct, yh))));
    const float xs = __fadd_rn(
        xl, __fmul_rn(sigma, __fsub_rn(__fmul_rn(ct, xh), __fmul_rn(st, yh))));
    float gy, gx;
    sift_sample::sample_gradient(s.plane, s.h, s.w, ys, xs, gy, gx);
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(gy, gy), __fmul_rn(gx, gx)));
    const float ang = remainder_f(__fsub_rn(atan2f(gy, gx), theta), p.two_pi);
    float weight = __fmul_rn(window[i], mag);
    if (!inside(ys, xs, s.h, s.w)) weight = 0.f;
    const float b = __fmul_rn(__fdiv_rn(ang, p.two_pi), n_ori_f);
    const float lower = floorf(b);
    int bin = (int)lower;
    bin = ((bin % p.n_ori) + p.n_ori) % p.n_ori;
    staged[i] = Staged{bin, __fsub_rn(b, lower), weight};
  }
  __syncwarp();

  // Bin q = cell · n_ori + o: the samples of the cell's list, in sample
  // order, each (split · weight) · spatial as the tensor code forms it.
  constexpr int kPerLane = kMaxDescBins / kWarp;
  float acc[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    acc[t] = 0.f;
    const int q = lane + t * kWarp;
    if (q >= n_bins) continue;
    const int cell = q / p.n_ori, o = q % p.n_ori;
    const int* idx = cell_index + (size_t)cell * p.cell_len;
    const float* wts = cell_weight + (size_t)cell * p.cell_len;
    float sum = 0.f;
    for (int e = 0; e < p.cell_len; ++e) {
      const int i = __ldg(idx + e);
      if (i < 0) break;
      const Staged g = staged[i];
      float split;
      if (g.bin == o) {
        split = __fsub_rn(1.f, g.frac);
      } else if ((g.bin + 1) % p.n_ori == o) {
        split = g.frac;
      } else {
        continue;
      }
      sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(split, g.weight), __ldg(wts + e)));
    }
    acc[t] = sum;
  }

  // Normalise, clamp at clip · ‖d‖, normalise again. The butterfly gives
  // every lane the same total (each step adds the same two numbers).
  float sq = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) sq = __fadd_rn(sq, __fmul_rn(acc[t], acc[t]));
  for (int off = kWarp / 2; off > 0; off /= 2)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
  const float limit = __fmul_rn(p.clip, __fsqrt_rn(__fadd_rn(sq, 1e-12f)));
  float sq2 = 0.f;
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    acc[t] = fminf(acc[t], limit);
    sq2 = __fadd_rn(sq2, __fmul_rn(acc[t], acc[t]));
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    sq2 = __fadd_rn(sq2, __shfl_xor_sync(0xffffffffu, sq2, off));
  const float norm2 = __fsqrt_rn(__fadd_rn(sq2, 1e-12f));
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    const int q = lane + t * kWarp;
    if (q < n_bins) out[q] = __fdiv_rn(acc[t], norm2);
  }
}

// Warps a block for ``per_warp`` bytes of shared memory a warp: up to
// kMaxWarps, within the default 48 KB.
int warps_for(size_t per_warp) {
  const size_t fit = kSharedLimit / per_warp;
  return (int)(fit < (size_t)kMaxWarps ? fit : (size_t)kMaxWarps);
}

bool grid_for(long long n_slots, int warps, unsigned& blocks) {
  const long long b = (n_slots + warps - 1) / warps;
  if (b > 2147483647ll) return false;
  blocks = (unsigned)b;
  return true;
}

}  // namespace

// R3 over ``n_slots`` slots. ``stacks``, ``heights``, ``widths``: host
// arrays of ``n_octaves`` entries (device pointer and plane size of each
// octave's contiguous float32 stack (batch, n_scales, H_o, W_o)).
// ``slots`` (n_slots, 4) int32, ``y_loc``/``x_loc``/``sigma_loc``
// (n_slots,) float32, the unit grid ``uy``/``ux`` (n_samples,) float32, and
// the outputs ``theta`` (n_slots, n_peaks) float32 and ``valid`` (n_slots,
// n_peaks) bool are device memory. ``scalars``: host array of radius
// factor (3 λ_ori), λ_ori, peak ratio and 2π, as float32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for sizes the kernel does not
// take.
extern "C" int sift_orient_slots(const void* const* stacks, const int* heights,
                                 const int* widths, int n_octaves, int batch,
                                 int n_scales, const int* slots,
                                 const float* y_loc, const float* x_loc,
                                 const float* sigma_loc, const float* uy,
                                 const float* ux, int n_samples, int nbins,
                                 int n_peaks, int smooth, const float* scalars,
                                 float* theta, bool* valid, long long n_slots,
                                 void* stream) {
  OctaveTable table;
  if (!sift_sample::fill_table(table, stacks, heights, widths, n_octaves) ||
      n_samples < 1 || n_samples > kMaxSamples || nbins < 3 ||
      nbins > kMaxOriBins || n_peaks < 1 || n_peaks > nbins || smooth < 0 ||
      n_slots < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  const OrientParams p{n_samples, nbins, n_peaks, smooth,
                       scalars[0], scalars[1], scalars[2], scalars[3]};
  const size_t per_warp = (size_t)n_samples * sizeof(int2) + kMaxOriBins * sizeof(float);
  const int warps = warps_for(per_warp);
  unsigned blocks;
  if (!grid_for(n_slots, warps, blocks)) return (int)cudaErrorInvalidValue;
  orient_slots_kernel<<<blocks, warps * kWarp, warps * per_warp,
                        static_cast<cudaStream_t>(stream)>>>(
      table, n_octaves, batch, n_scales, reinterpret_cast<const int4*>(slots),
      y_loc, x_loc, sigma_loc, uy, ux, p, n_slots, theta, valid);
  return (int)cudaGetLastError();
}

// R4 over ``n_slots`` pair slots: as R3's table, slots and fields, with
// ``theta_in`` (n_slots,) float32; the grid ``yhat``/``xhat``/``window``
// (n_samples,) float32; the cell lists ``cell_index`` (n_cells, cell_len)
// int32 (sample indices in ascending order, then -1) and ``cell_weight``
// (n_cells, cell_len) float32; the output ``desc`` (n_slots, n_cells ·
// n_ori) float32. ``scalars``: host array of clip and 2π, as float32.
extern "C" int sift_describe_pairs(const void* const* stacks, const int* heights,
                                   const int* widths, int n_octaves, int batch,
                                   int n_scales, const int* slots,
                                   const float* y_loc, const float* x_loc,
                                   const float* sigma_loc, const float* theta_in,
                                   const float* yhat, const float* xhat,
                                   const float* window, const int* cell_index,
                                   const float* cell_weight, int n_samples,
                                   int n_ori, int n_cells, int cell_len,
                                   const float* scalars, float* desc,
                                   long long n_slots, void* stream) {
  OctaveTable table;
  if (!sift_sample::fill_table(table, stacks, heights, widths, n_octaves) ||
      n_samples < 1 || n_samples > kMaxSamples || n_ori < 2 || n_cells < 1 ||
      n_cells * n_ori > kMaxDescBins || cell_len < 1 || n_slots < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_slots == 0) return (int)cudaSuccess;
  const DescribeParams p{n_samples, n_ori, n_cells, cell_len, scalars[0], scalars[1]};
  const size_t per_warp = (size_t)n_samples * sizeof(Staged);
  const int warps = warps_for(per_warp);
  unsigned blocks;
  if (!grid_for(n_slots, warps, blocks)) return (int)cudaErrorInvalidValue;
  describe_pairs_kernel<<<blocks, warps * kWarp, warps * per_warp,
                          static_cast<cudaStream_t>(stream)>>>(
      table, n_octaves, batch, n_scales, reinterpret_cast<const int4*>(slots),
      y_loc, x_loc, sigma_loc, theta_in, yhat, xhat, window, cell_index,
      cell_weight, p, n_slots, desc);
  return (int)cudaGetLastError();
}
