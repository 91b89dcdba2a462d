// Newton refinement of SIFT candidates and its compaction ladder, on Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package refines with plain array code
// (sift_scale_space_extrema_detection_tpu/ops/refine.py), and so did the
// port until this kernel. That tensor code stays as the plain version:
// ../../refine.py::_iterate and _step, which launch ~200 small elementwise
// operations a Newton step from the host. Here one launch runs every step
// of the ladder, and each product, sum and division is rounded on its own in
// _step's order, so on the card the two agree bit for bit.
//
// Contract. A state is ``batch`` rows of ``n_slots`` slots, one row an image.
// The octave table gives each octave of the row its DoG (batch, depth, h, w)
// float32, its candidates' fields (batch, n) (y, x, scale level int32,
// value float32, valid bool), where its n slots start in the row, its
// octave number, its delta and sigma constant. Step 0 admits the first
// caps[0] valid slots of a row; step i > 0 the first caps[i] slots that step
// i - 1 admitted and that moved (all in slot order, as ../../refine.py::
// _first_active counts them). An admitted slot gathers the 19 points of its
// 3x3x3 cube (position clipped into the interior) and takes one Newton step:
// a singular Hessian, convergence (with the contrast and edge tests) or a
// step out of the interior ends it with a reason; else it moves. A slot no
// step admits keeps its state. Outputs: the Keypoints fields (octave, scale
// level, y, x, reason int32; abs_y, abs_x, abs_sigma, omega float32; valid
// = reason == ACCEPTED) and each row's count of admitted slots a step.
//
// What bounds it on this card: latency. A batch's state is a few MB and a
// step's work is microseconds (some 1-10 % of the slots are still live),
// so the tensor code's cost was the host issuing its operations, not the
// card. The least time is a chain of dependent gathers and IEEE divisions a
// step.
//
// What this design does about it: one block a row, which runs the whole
// ladder with no host in the loop. Thread t owns slots t, t + kThreads, ...
// for every phase, so a slot's state (kept in the outputs, L1/L2-resident)
// is read and written by one thread only. Between steps the block scans the
// slots still going in tiles of kThreads (a warp ballot, then the warps'
// counts in shared memory), carrying the count across tiles, so a row of any
// length is admitted in slot order. The valid output holds the "still
// going" flag until the last step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxOctaves = 8;
constexpr int kMaxSteps = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The reasons of ../../../core/types.py.
constexpr int kAccepted = 0;
constexpr int kLowContrast = 1;
constexpr int kEdge = 2;
constexpr int kOutOfBounds = 3;
constexpr int kMaxIterations = 4;
constexpr int kSingular = 5;

struct Octave {
  const float* dog;             // (batch, depth, h, w)
  const int* y;                 // (batch, n) each
  const int* x;
  const int* s;
  const float* value;
  const unsigned char* valid;
  int h, w, n, first, octave;
  float delta, sigc;
};

struct Table {
  Octave oct[kMaxOctaves];
  int caps[kMaxSteps];
};

struct Limits {
  float convergence, contrast, edge, spo;
};

// The outputs of one row, each (batch, n_slots) of its field.
struct Row {
  int* octave;
  int* s;
  int* m;
  int* n;
  int* reason;
  float* abs_y;
  float* abs_x;
  float* abs_sigma;
  float* omega;
  unsigned char* going;  // the valid output, a flag until the end
};

__device__ __forceinline__ int octave_of(const Table& t, int n_octaves, int k) {
  int o = 0;
  for (int i = 1; i < n_octaves; ++i) o = k >= t.oct[i].first ? i : o;
  return o;
}

// One Newton step of slot k (its octave's slot j), in _step's order.
// Returns whether the slot moved, and so may be admitted again.
__device__ bool newton_step(const Octave& oc, const Row& r, int k, int row,
                            int j, int depth, const Limits& lim) {
  const int s = r.s[k], m = r.m[k], n = r.n[k];
  const int sc = min(max(s, 1), depth - 2);
  const int mc = min(max(m, 1), oc.h - 2);
  const int nc = min(max(n, 1), oc.w - 2);
  const long long w = oc.w;
  const long long hw = (long long)oc.h * w;
  const float* __restrict__ c =
      oc.dog + ((long long)row * depth + sc) * hw + mc * w + nc;
  // v(a, b, d): the point at (s + a - 1, m + b - 1, n + d - 1).
  auto v = [&](int a, int b, int d) {
    return __ldg(c + (a - 1) * hw + (b - 1) * w + (d - 1));
  };
  const float v111 = v(1, 1, 1);
  const float v011 = v(0, 1, 1), v211 = v(2, 1, 1);
  const float v101 = v(1, 0, 1), v121 = v(1, 2, 1);
  const float v110 = v(1, 1, 0), v112 = v(1, 1, 2);
  const float v001 = v(0, 0, 1), v021 = v(0, 2, 1);
  const float v201 = v(2, 0, 1), v221 = v(2, 2, 1);
  const float v010 = v(0, 1, 0), v012 = v(0, 1, 2);
  const float v210 = v(2, 1, 0), v212 = v(2, 1, 2);
  const float v100 = v(1, 0, 0), v102 = v(1, 0, 2);
  const float v120 = v(1, 2, 0), v122 = v(1, 2, 2);

  // x / 2 and x / 4: the tensor code divides by a Python scalar, which
  // CUDA does through its reciprocal, exact for both.
  const float two_ctr = __fmul_rn(2.f, v111);
  const float g0 = __fmul_rn(__fsub_rn(v211, v011), 0.5f);
  const float g1 = __fmul_rn(__fsub_rn(v121, v101), 0.5f);
  const float g2 = __fmul_rn(__fsub_rn(v112, v110), 0.5f);
  const float h11 = __fsub_rn(__fadd_rn(v211, v011), two_ctr);
  const float h22 = __fsub_rn(__fadd_rn(v121, v101), two_ctr);
  const float h33 = __fsub_rn(__fadd_rn(v112, v110), two_ctr);
  const float h12 = __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(v221, v201), v021), v001), 0.25f);
  const float h13 = __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(v212, v210), v012), v010), 0.25f);
  const float h23 = __fmul_rn(
      __fadd_rn(__fsub_rn(__fsub_rn(v122, v120), v102), v100), 0.25f);

  const float m00 = __fsub_rn(__fmul_rn(h22, h33), __fmul_rn(h23, h23));
  const float m01 = __fsub_rn(__fmul_rn(h12, h33), __fmul_rn(h23, h13));
  const float m02 = __fsub_rn(__fmul_rn(h12, h23), __fmul_rn(h22, h13));
  const float m10 = __fsub_rn(__fmul_rn(h12, h33), __fmul_rn(h13, h23));
  const float m11 = __fsub_rn(__fmul_rn(h11, h33), __fmul_rn(h13, h13));
  const float m12 = __fsub_rn(__fmul_rn(h11, h23), __fmul_rn(h12, h13));
  const float m20 = __fsub_rn(__fmul_rn(h12, h23), __fmul_rn(h13, h22));
  const float m21 = __fsub_rn(__fmul_rn(h11, h23), __fmul_rn(h13, h12));
  const float m22 = __fsub_rn(__fmul_rn(h11, h22), __fmul_rn(h12, h12));
  const float det = __fadd_rn(
      __fsub_rn(__fmul_rn(h11, m00), __fmul_rn(h12, m01)), __fmul_rn(h13, m02));

  const bool singular = fabsf(det) < 0x1p-52f;  // JS Number.EPSILON
  const float det_safe = singular ? 1.f : det;
  // True IEEE divisions, as the tensor code's tensor divisors.
  const float i00 = __fdiv_rn(m00, det_safe);
  const float i01 = -__fdiv_rn(m10, det_safe);
  const float i02 = __fdiv_rn(m20, det_safe);
  const float i10 = -__fdiv_rn(m01, det_safe);
  const float i11 = __fdiv_rn(m11, det_safe);
  const float i12 = -__fdiv_rn(m21, det_safe);
  const float i20 = __fdiv_rn(m02, det_safe);
  const float i21 = -__fdiv_rn(m12, det_safe);
  const float i22 = __fdiv_rn(m22, det_safe);
  const float a0 = __fadd_rn(
      __fadd_rn(__fmul_rn(-i00, g0), __fmul_rn(-i01, g1)), __fmul_rn(-i02, g2));
  const float a1 = __fadd_rn(
      __fadd_rn(__fmul_rn(-i10, g0), __fmul_rn(-i11, g1)), __fmul_rn(-i12, g2));
  const float a2 = __fadd_rn(
      __fadd_rn(__fmul_rn(-i20, g0), __fmul_rn(-i21, g1)), __fmul_rn(-i22, g2));

  if (singular) {
    r.reason[k] = kSingular;
    return false;
  }
  const bool converged = fabsf(a0) < lim.convergence &&
                         fabsf(a1) < lim.convergence &&
                         fabsf(a2) < lim.convergence;
  const float sf = (float)s, mf = (float)m, nf = (float)n;
  if (converged) {
    const float value = oc.value[(long long)row * oc.n + j];
    const float omega = __fadd_rn(
        value,
        __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(0.5f, a0), g0),
                            __fmul_rn(__fmul_rn(0.5f, a1), g1)),
                  __fmul_rn(__fmul_rn(0.5f, a2), g2)));
    const bool contrast_fail = fabsf(omega) < lim.contrast;
    const float tr = __fadd_rn(h22, h33);
    const float det2 = __fsub_rn(__fmul_rn(h22, h33), __fmul_rn(h23, h23));
    const bool edge_fail = __fdiv_rn(__fmul_rn(tr, tr), det2) > lim.edge;
    const int verdict =
        contrast_fail ? kLowContrast : (edge_fail ? kEdge : kAccepted);
    r.reason[k] = verdict;
    if (verdict == kAccepted) {
      r.abs_y[k] = __fmul_rn(oc.delta, __fadd_rn(a1, mf));
      r.abs_x[k] = __fmul_rn(oc.delta, __fadd_rn(a2, nf));
      r.abs_sigma[k] =
          __fmul_rn(oc.sigc, exp2f(__fdiv_rn(__fadd_rn(a0, sf), lim.spo)));
      r.omega[k] = omega;
    }
    return false;
  }
  // JS Math.round, then the conversion PyTorch's CUDA cast makes: toward
  // zero, saturating, NaN to 0.
  const int new_s = (int)floorf(__fadd_rn(__fadd_rn(sf, a0), 0.5f));
  const int new_m = (int)floorf(__fadd_rn(__fadd_rn(mf, a1), 0.5f));
  const int new_n = (int)floorf(__fadd_rn(__fadd_rn(nf, a2), 0.5f));
  if (new_s < 1 || new_s >= depth - 1 || new_m < 1 || new_m >= oc.h - 1 ||
      new_n < 1 || new_n >= oc.w - 1) {
    r.reason[k] = kOutOfBounds;
    return false;
  }
  r.s[k] = new_s;
  r.m[k] = new_m;
  r.n[k] = new_n;
  return true;
}

__global__ void __launch_bounds__(kThreads)
    newton_ladder_kernel(const __grid_constant__ Table table, int n_octaves,
                         int depth, int n_slots, int n_steps, Limits lim,
                         int* __restrict__ ints, float* __restrict__ floats,
                         unsigned char* __restrict__ going,
                         int* __restrict__ live) {
  const int row = blockIdx.x;
  const long long field = (long long)gridDim.x * n_slots;
  const long long at = (long long)row * n_slots;
  const Row r{ints + at,          ints + field + at,   ints + 2 * field + at,
              ints + 3 * field + at, ints + 4 * field + at, floats + at,
              floats + field + at, floats + 2 * field + at,
              floats + 3 * field + at, going + at};

  for (int k = threadIdx.x; k < n_slots; k += kThreads) {
    const int o = octave_of(table, n_octaves, k);
    const Octave& oc = table.oct[o];
    const long long src = (long long)row * oc.n + (k - oc.first);
    const bool valid = oc.valid[src] != 0;
    r.octave[k] = oc.octave;
    r.s[k] = oc.s[src];
    r.m[k] = oc.y[src];
    r.n[k] = oc.x[src];
    r.reason[k] = valid ? kMaxIterations : -1;
    r.abs_y[k] = 0.f;
    r.abs_x[k] = 0.f;
    r.abs_sigma[k] = 0.f;
    r.omega[k] = 0.f;
    r.going[k] = valid;
  }

  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int step = 0; step < n_steps; ++step) {
    // Admit the first caps[step] slots still going, in slot order.
    const int cap = table.caps[step];
    int carry = 0;
    for (int base = 0; base < n_slots; base += kThreads) {
      const int k = base + threadIdx.x;
      const bool candidate = k < n_slots && r.going[k];
      const unsigned ballot = __ballot_sync(0xffffffffu, candidate);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int rank = carry + __popc(ballot & ((1u << lane) - 1u));
      int tile = 0;
      for (int i = 0; i < kWarps; ++i) {
        const int c = warp_count[i];
        rank += i < warp ? c : 0;
        tile += c;
      }
      __syncthreads();
      carry += tile;
      if (candidate && rank >= cap) r.going[k] = 0;
    }
    if (threadIdx.x == 0) live[(long long)row * n_steps + step] = min(carry, cap);
    for (int k = threadIdx.x; k < n_slots; k += kThreads) {
      if (!r.going[k]) continue;
      const int o = octave_of(table, n_octaves, k);
      const Octave& oc = table.oct[o];
      r.going[k] = newton_step(oc, r, k, row, k - oc.first, depth, lim);
    }
  }
  for (int k = threadIdx.x; k < n_slots; k += kThreads) {
    r.going[k] = r.reason[k] == kAccepted;
  }
}

}  // namespace

// Run the ladder over ``batch`` rows of ``n_slots`` slots. Host arrays of
// ``n_octaves`` entries: ``dogs`` and ``fields`` (5 an octave: y, x, scale
// level, value, valid) hold device pointers; ``dims`` 5 ints an octave (h,
// w, n, first slot, octave), ``geometry`` 2 floats (delta, sigma constant);
// ``caps`` ``n_steps`` ints; ``limits`` 4 floats (convergence, contrast and
// edge thresholds, scales per octave). Outputs in device memory: ``ints``
// (5, batch, n_slots), ``floats`` (4, batch, n_slots), ``valid`` (batch,
// n_slots), ``live`` (batch, n_steps). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table the kernel does not take.
extern "C" int sift_newton_ladder(const void* const* dogs,
                                  const void* const* fields, const int* dims,
                                  const float* geometry, int n_octaves,
                                  int batch, int depth, int n_slots,
                                  const int* caps, int n_steps,
                                  const float* limits, int* ints,
                                  float* floats, unsigned char* valid,
                                  int* live, void* stream) {
  if (n_octaves < 1 || n_octaves > kMaxOctaves || n_steps < 0 ||
      n_steps > kMaxSteps || batch < 0 || n_slots < 0 || depth < 3) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) return (int)cudaSuccess;
  Table table{};
  for (int o = 0; o < n_octaves; ++o) {
    Octave& oc = table.oct[o];
    oc.dog = static_cast<const float*>(dogs[o]);
    oc.y = static_cast<const int*>(fields[5 * o]);
    oc.x = static_cast<const int*>(fields[5 * o + 1]);
    oc.s = static_cast<const int*>(fields[5 * o + 2]);
    oc.value = static_cast<const float*>(fields[5 * o + 3]);
    oc.valid = static_cast<const unsigned char*>(fields[5 * o + 4]);
    oc.h = dims[5 * o];
    oc.w = dims[5 * o + 1];
    oc.n = dims[5 * o + 2];
    oc.first = dims[5 * o + 3];
    oc.octave = dims[5 * o + 4];
    oc.delta = geometry[2 * o];
    oc.sigc = geometry[2 * o + 1];
    if (oc.h < 3 || oc.w < 3) return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < n_steps; ++i) table.caps[i] = caps[i];
  const Limits lim{limits[0], limits[1], limits[2], limits[3]};
  newton_ladder_kernel<<<batch, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, n_octaves, depth, n_slots, n_steps, lim, ints, floats, valid,
      live);
  return (int)cudaGetLastError();
}
