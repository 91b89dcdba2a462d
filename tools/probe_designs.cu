// The other designs of the probes' streaming write and copy (K4, K5), which
// chip_smoke.py's phase 21 and tools/torch_probe_designs.py time beside the
// port's kernels (sift_scale_space_extrema_detection_tpu_torch/ops/kernels/
// csrc/probes.cu) in the same turns:
// - first_*: the port's first design, a grid-stride loop of one 16-byte
//   access a thread a trip, 64-bit indices, 32 blocks of 256 threads a
//   multiprocessor;
// - bulk_*: Hopper's bulk asynchronous copies (cp.async.bulk, sm_90), which
//   move whole chunks between device memory and shared memory without
//   registers: one block of one warp a multiprocessor, the buffer's 32 KiB
//   chunks dealt to the blocks in turn (block b of G: b, b + G, ...).
//   - copy: a ring of kStages chunks; each stage's load (global → shared)
//     completes on its own mbarrier, the stage is stored back (shared →
//     global) as one bulk group and refilled once that group has read it
//     (wait_group.read). kStages - 1 loads and up to two stores are in
//     flight a block.
//   - write: the block fills one chunk of shared memory with the value once
//     and stores it over its chunks, at most kStages bulk groups reading it.
// Every address and length of a bulk copy is a multiple of 16 bytes (the
// instruction's rule): the callers pass 16-byte aligned pointers and
// element counts that are multiples of 4, so the last, short chunk is too.
//
// Built by torch_probe_designs.py::load_designs with the port's nvcc flags
// (ops/kernels/_build.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // the first design's block
constexpr int kBulkThreads = 32;   // one warp: one thread issues, all fill
constexpr int kChunk = 32 * 1024;  // bytes a bulk copy
constexpr int kStages = 4;

int sms() {
  int device = 0, n = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n;
}

int first_blocks(long long n4) {
  const long long want = (n4 + kThreads - 1) / kThreads;
  const long long most = 32LL * sms();
  return (int)(want < most ? (want > 0 ? want : 1) : most);
}

__global__ void __launch_bounds__(kThreads)
first_write_kernel(float4* __restrict__ out, long long n4, float value) {
  const float4 v = make_float4(value, value, value, value);
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    out[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
first_copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst,
                  long long n4) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads) {
    dst[i] = src[i];
  }
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until the mbarrier at `bar` has completed the phase of `parity`.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The chunks this block is dealt of the `nbytes` in kChunk chunks, and the
// byte offset and length of its i-th.
__device__ __forceinline__ long long dealt(long long nbytes) {
  const long long chunks = (nbytes + kChunk - 1) / kChunk;
  return (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
}

__device__ __forceinline__ long long chunk_at(long long i) {
  return (blockIdx.x + i * gridDim.x) * (long long)kChunk;
}

__device__ __forceinline__ uint32_t chunk_bytes(long long nbytes,
                                                long long at) {
  const long long left = nbytes - at;
  return static_cast<uint32_t>(left < kChunk ? left : kChunk);
}

__global__ void __launch_bounds__(kBulkThreads)
bulk_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                 long long nbytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  if (threadIdx.x != 0) return;
  const long long n = dealt(nbytes);
  if (n <= 0) return;
  for (int s = 0; s < kStages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(smem(&full[s])) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const uint32_t base = smem(ring);
  auto fill = [&](long long i) {
    const int s = static_cast<int>(i % kStages);
    bulk_load(base + s * kChunk, src + chunk_at(i),
              chunk_bytes(nbytes, chunk_at(i)), smem(&full[s]));
  };
  for (long long i = 0; i < n && i < kStages; ++i) fill(i);
  for (long long i = 0; i < n; ++i) {
    const int s = static_cast<int>(i % kStages);
    wait(smem(&full[s]), static_cast<uint32_t>((i / kStages) & 1));
    bulk_store(dst + chunk_at(i), base + s * kChunk,
               chunk_bytes(nbytes, chunk_at(i)));
    // The stage of chunk i - 1 takes chunk i - 1 + kStages once its store
    // has read it: at most the one just issued may still be reading.
    if (i >= 1 && i - 1 + kStages < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      fill(i - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kBulkThreads)
bulk_write_kernel(char* __restrict__ out, long long nbytes, float value) {
  extern __shared__ __align__(128) unsigned char tile_bytes[];
  const long long n = dealt(nbytes);
  if (n <= 0) return;
  float4* tile = reinterpret_cast<float4*>(tile_bytes);
  const float4 v = make_float4(value, value, value, value);
  for (int i = threadIdx.x; i < kChunk / 16; i += kBulkThreads) tile[i] = v;
  // The tile was written through the generic proxy and is read by the
  // bulk copies' (async) proxy.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (long long i = 0; i < n; ++i) {
    bulk_store(out + chunk_at(i), smem(tile_bytes),
               chunk_bytes(nbytes, chunk_at(i)));
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kStages - 1)
                 : "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int bulk_blocks(long long nbytes) {
  const long long chunks = (nbytes + kChunk - 1) / kChunk;
  const long long most = sms();
  return (int)(chunks < most ? (chunks > 0 ? chunks : 1) : most);
}

}  // namespace

extern "C" const char* designs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each writes `value` into the n floats at `out`, or copies the n floats
// at `src` to `dst` (n a positive multiple of 4, pointers 16-byte aligned),
// on `stream`; returns a cudaError_t, 0 for success.
extern "C" int designs_first_write(float* out, long long n, float value,
                                   void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  first_write_kernel<<<first_blocks(n / 4), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(out), n / 4, value);
  return (int)cudaGetLastError();
}

extern "C" int designs_first_copy(const float* src, float* dst, long long n,
                                  void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  first_copy_kernel<<<first_blocks(n / 4), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst),
      n / 4);
  return (int)cudaGetLastError();
}

extern "C" int designs_bulk_copy(const float* src, float* dst, long long n,
                                 void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const int ring = kChunk * kStages;
  cudaError_t err = cudaFuncSetAttribute(
      bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring);
  if (err != cudaSuccess) return (int)err;
  bulk_copy_kernel<<<bulk_blocks(4 * n), kBulkThreads, ring,
                     static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char*>(src), reinterpret_cast<char*>(dst), 4 * n);
  return (int)cudaGetLastError();
}

extern "C" int designs_bulk_write(float* out, long long n, float value,
                                  void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  bulk_write_kernel<<<bulk_blocks(4 * n), kBulkThreads, kChunk,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<char*>(out), 4 * n, value);
  return (int)cudaGetLastError();
}
