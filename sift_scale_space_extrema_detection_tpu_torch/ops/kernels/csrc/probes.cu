// The card's probes on Hopper (sm_90a): streaming write, copy and read of
// device memory, and a chain of shifted products and sums, the arithmetic
// the blur passes are made of. They measure the ceilings that the octave
// and blur kernels are held to; no detect, describe or SLAM path runs them.
//
// Replace the Pallas TPU kernels
//   benchmarks/bw_probe.py::main.pl_write (kernel body _write_kernel),
//   benchmarks/bw_probe.py::main.pl_copy  (kernel body _copy_kernel),
//   benchmarks/bw_probe.py::main.pl_read  (kernel body _read_kernel),
//   benchmarks/tap_probe.py::make(mode).run (kernel body kern).
// The plain PyTorch versions are in ../probes.py; the write, the copy and
// the float32 chain agree with them bit for bit, and so does the read,
// whose sums are taken in one fixed order (below).
//
// What bounds them on this card: write, copy and read are bytes and nothing
// else; the chain is operations (844 a element, 2 MB in and out). The
// TPU kernels cut the arrays into 128-row blocks that a sequential grid
// walked; here blocks run in parallel in no order, so:
// - write and copy give each block one stretch of 256 float4s, one
//   16-byte access a thread with the streaming cache hints (__ldcs/__stcs),
//   neighbouring threads on neighbouring addresses, as many blocks as
//   stretches (262,144 for the 1 GiB buffer). The blocks are handed out in
//   order, so the accesses in flight form one compact window of the buffer
//   and the last wave is one block deep. On an H100 80GB HBM3 at 700 W the
//   first design, a grid-stride loop over 32 blocks a multiprocessor
//   (ptxas kept four loads in flight a thread), copied about 4 % slower
//   than clone, and Hopper's bulk copies (cp.async.bulk through a ring of
//   shared memory) about 3 % slower. tools/probe_designs.cu holds both;
//   chip_smoke.py's phase 21 and tools/torch_probe_designs.py time them
//   beside these kernels (PERF.md §6);
// - the read cannot carry its (8, 128) sum from block to block as the TPU's
//   grid did, and float atomics would sum in an order that changes from run
//   to run: each block of 128 rows writes its own (8, 128) partial sum, and
//   a second launch adds the partials in block order;
// - the chain is one thread per output element (float32) or per pair of
//   columns (bf16, as __nv_bfloat162), its 13 input rows in registers. The
//   products do not change from one repetition to the next, and the
//   compiler computes each once (an empty asm statement hiding the input
//   does not stop ptxas from it): the float32 chain runs 13 FMUL and 831
//   FADD a element, no FFMA, the same result as 832 products with another
//   mix of instructions; bf16_pair's pair sums are computed once too. The
//   rate the chain measures is therefore taken per float instruction
//   executed, as cuobjdump -sass counts them (chip_smoke.py phase 21).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReadBlockRows = 128;  // the TPU kernel's block of rows
constexpr int kReadRows = 8;         // the (8, 128) accumulator tile
constexpr int kReadCols = 128;
constexpr int kTaps = 13;
constexpr int kReps = 64;

// Modes of the chain, as in tap_probe.py.
constexpr int kF32 = 0;
constexpr int kBf16Carry = 1;
constexpr int kBf16Full = 2;
constexpr int kBf16Pair = 3;

// The blocks of a stretch stream over ``n4`` float4s, or 0 past the
// grid's limit.
int stretches(long long n4) {
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  return blocks <= 0x7fffffffLL ? (int)blocks : 0;
}

__global__ void __launch_bounds__(kThreads)
write_kernel(float4* __restrict__ out, long long n4, float value) {
  const long long first = blockIdx.x * (long long)kThreads;
  if (threadIdx.x < n4 - first) {
    __stcs(out + first + threadIdx.x, make_float4(value, value, value, value));
  }
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
            long long n4) {
  const long long first = blockIdx.x * (long long)kThreads;
  if (threadIdx.x < n4 - first) {
    __stcs(dst + first + threadIdx.x, __ldcs(src + first + threadIdx.x));
  }
}

// Pass 1 of the read: block k sums rows [128k, 128k + 128). Thread (a, q)
// (a = threadIdx.x / 32, q = threadIdx.x % 32) owns the four columns
// 4q..4q+3 of tile row a, and adds x[r, 128j + 4q + i] into its
// accumulator i for r = 128k + a, +8, ... (row after row) and, within a
// row, j = 0, 1, ... (128-column group after group), starting from 0.
__global__ void __launch_bounds__(kThreads)
read_partial_kernel(const float* __restrict__ x, int cols,
                    float* __restrict__ partial) {
  const int a = threadIdx.x / 32;
  const int q = threadIdx.x % 32;
  const int groups = cols / kReadCols;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
  const float* block = x + (size_t)blockIdx.x * kReadBlockRows * cols;
  for (int rr = 0; rr < kReadBlockRows / kReadRows; ++rr) {
    const float4* row = reinterpret_cast<const float4*>(
        block + (size_t)(rr * kReadRows + a) * cols) + q;
#pragma unroll 8
    for (int j = 0; j < groups; ++j) {
      const float4 v = row[j * (kReadCols / 4)];
      acc0 = __fadd_rn(acc0, v.x);
      acc1 = __fadd_rn(acc1, v.y);
      acc2 = __fadd_rn(acc2, v.z);
      acc3 = __fadd_rn(acc3, v.w);
    }
  }
  float4* out = reinterpret_cast<float4*>(
      partial + ((size_t)blockIdx.x * kReadRows + a) * kReadCols) + q;
  *out = make_float4(acc0, acc1, acc2, acc3);
}

// Pass 2: out[a, b] = sum of partial[k, a, b] over k = 0, 1, ... in order,
// starting from 0.
__global__ void __launch_bounds__(kReadRows * kReadCols)
read_total_kernel(const float* __restrict__ partial, int blocks,
                  float* __restrict__ out) {
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (int k = 0; k < blocks; ++k) {
    acc = __fadd_rn(acc, partial[(size_t)k * kReadRows * kReadCols + t]);
  }
  out[t] = acc;
}

// One float32 output element: acc = x[y]·t0, then 64 repetitions of the 13
// taps (the first repetition from tap 1), each acc + x[y + t]·t_t.
__global__ void __launch_bounds__(kThreads)
tap_f32_kernel(const float* __restrict__ x, int width,
               const float* __restrict__ taps, float* __restrict__ out,
               int rows) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (c >= width || y >= rows) return;
  float xr[kTaps], tr[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    xr[t] = x[(size_t)(y + t) * width + c];
    tr[t] = taps[t];
  }
  float acc = __fmul_rn(xr[0], tr[0]);
#pragma unroll
  for (int rep = 0; rep < kReps; ++rep) {
#pragma unroll
    for (int t = rep == 0 ? 1 : 0; t < kTaps; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(xr[t], tr[t]));
    }
  }
  out[(size_t)y * width + c] = acc;
}

__device__ __forceinline__ float2 add_f32(float2 acc, __nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return make_float2(__fadd_rn(acc.x, f.x), __fadd_rn(acc.y, f.y));
}

// The bf16 modes for the two columns 2p, 2p + 1 at once. The data and the
// taps are rounded to bf16 once; every bf16 product and sum rounds once
// (the _rn intrinsics, never contracted to a fused multiply-add).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
tap_bf16_kernel(const float* __restrict__ x, int width,
                const float* __restrict__ taps, float* __restrict__ out,
                int rows) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (2 * p >= width || y >= rows) return;
  __nv_bfloat162 xr[kTaps], tr[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const float2 v =
        reinterpret_cast<const float2*>(x + (size_t)(y + t) * width)[p];
    xr[t] = __floats2bfloat162_rn(v.x, v.y);
    tr[t] = __float2bfloat162_rn(taps[t]);
  }
  auto prod = [&](int t) { return __hmul2_rn(xr[t], tr[t]); };
  float2 result;
  if (kMode == kBf16Full) {
    __nv_bfloat162 acc = prod(0);
#pragma unroll
    for (int rep = 0; rep < kReps; ++rep) {
#pragma unroll
      for (int t = rep == 0 ? 1 : 0; t < kTaps; ++t) {
        acc = __hadd2_rn(acc, prod(t));
      }
    }
    result = __bfloat1622float2(acc);
  } else {
    float2 acc = __bfloat1622float2(prod(0));
#pragma unroll
    for (int rep = 0; rep < kReps; ++rep) {
      const int first = rep == 0 ? 1 : 0;
      if (kMode == kBf16Carry) {
#pragma unroll
        for (int t = first; t < kTaps; ++t) acc = add_f32(acc, prod(t));
      } else {  // kBf16Pair: taps in pairs summed in bf16, a last odd one alone
        const int n = kTaps - first;
#pragma unroll
        for (int k = 0; k + 1 < n; k += 2) {
          acc = add_f32(acc, __hadd2_rn(prod(first + k), prod(first + k + 1)));
        }
        if (n % 2) acc = add_f32(acc, prod(kTaps - 1));
      }
    }
    result = acc;
  }
  reinterpret_cast<float2*>(out + (size_t)y * width)[p] = result;
}

}  // namespace

// Store ``value`` into the ``n`` floats at ``out`` (16-byte aligned, n a
// multiple of 4), on ``stream``. Returns a cudaError_t, 0 for success.
extern "C" int sift_probe_write(float* out, long long n, float value,
                                void* stream) {
  const int blocks = stretches(n / 4);
  if (n <= 0 || n % 4 != 0 || blocks == 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  write_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(out), n4, value);
  return (int)cudaGetLastError();
}

// Copy the ``n`` floats at ``src`` to ``dst`` (both 16-byte aligned, n a
// multiple of 4), on ``stream``.
extern "C" int sift_probe_copy(const float* src, float* dst, long long n,
                               void* stream) {
  const int blocks = stretches(n / 4);
  if (n <= 0 || n % 4 != 0 || blocks == 0) return (int)cudaErrorInvalidValue;
  const long long n4 = n / 4;
  copy_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst),
      n4);
  return (int)cudaGetLastError();
}

// The (8, 128) sum of ``x`` (rows, cols): out[a, b] sums x[r, c] over
// r % 8 == a and c % 128 == b, in the order of the two passes above.
// ``rows`` is a multiple of 128 and ``cols`` of 128; ``partial`` holds
// rows / 128 tiles of (8, 128) floats. Two launches on ``stream``.
extern "C" int sift_probe_read(const float* x, int rows, int cols,
                               float* partial, float* out, void* stream) {
  if (rows <= 0 || rows % kReadBlockRows != 0 || cols <= 0 ||
      cols % kReadCols != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = rows / kReadBlockRows;
  auto s = static_cast<cudaStream_t>(stream);
  read_partial_kernel<<<blocks, kThreads, 0, s>>>(x, cols, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  read_total_kernel<<<1, kReadRows * kReadCols, 0, s>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}

// The tap chain of ``mode`` (0 f32, 1 bf16_carry, 2 bf16_full, 3
// bf16_pair) on ``x`` (at least rows + 12, width) with the 13 float32
// ``taps`` (device memory) into ``out`` (rows, width). The bf16 modes need
// an even width.
extern "C" int sift_probe_taps(const float* x, int rows, int width,
                               const float* taps, int mode, float* out,
                               void* stream) {
  if (rows <= 0 || width <= 0 || mode < kF32 || mode > kBf16Pair ||
      (mode != kF32 && width % 2 != 0) || rows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int lanes = mode == kF32 ? width : width / 2;
  const dim3 grid((lanes + kThreads - 1) / kThreads, rows);
  switch (mode) {
    case kF32:
      tap_f32_kernel<<<grid, kThreads, 0, s>>>(x, width, taps, out, rows);
      break;
    case kBf16Carry:
      tap_bf16_kernel<kBf16Carry><<<grid, kThreads, 0, s>>>(x, width, taps,
                                                           out, rows);
      break;
    case kBf16Full:
      tap_bf16_kernel<kBf16Full><<<grid, kThreads, 0, s>>>(x, width, taps,
                                                          out, rows);
      break;
    default:
      tap_bf16_kernel<kBf16Pair><<<grid, kThreads, 0, s>>>(x, width, taps,
                                                          out, rows);
  }
  return (int)cudaGetLastError();
}
