// Candidate selection from the packed extrema plane, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package selects with plain array code,
// as the port did with ../../extrema.py::select_refine_candidates_reference,
// which stays as this kernel's plain version: it widens every 2-byte word of
// the plane into T int32 codes, takes a running count over each image's
// whole T*H*W volume and binary-searches it. PyTorch's scan runs one block
// a row, so its time followed the number of images and not the card.
//
// Contract. ``plane`` (batch, h, w) holds trio t's 2-bit code in bits
// [2t, 2t+2) of each word (uint16 for up to 8 trios, uint32 for up to 16,
// read unsigned): 1 a candidate, 2 a low-contrast reject. ``dog`` (batch,
// depth, h, w) float32 with depth = trios + 2. Slot j of an image holds the
// (j+1)-th code-1 pixel in (trio-major, row-major) order: y, x, scale level
// t + 1 (int32), the DoG at (t + 1, y, x) and valid; slots from min(total,
// capacity) on are parked at (scale 1, y 1, x 1) with the DoG's value there
// and valid 0. ``n_cand`` and ``n_low`` (batch, trios) count codes 1 and 2
// uncapped. All integer work and copies, so equal to the plain version bit
// for bit.
//
// What bounds it on this card: bytes. The least traffic is each image's
// plane read once (2 or 4 bytes a pixel) and the slots written once; the
// arithmetic is a few integer operations a word.
//
// What this design does about it: three kernels in the stream, parallel
// over tiles of the flattened plane (a tile: 16 KB of words), never over
// images alone, with no atomics and no host synchronise.
// 1. count_codes, a block a (tile, image): each thread loads four 16-byte
//    chunks, the warp's chunks adjacent, folds two 32-bit lanes of code-1
//    (code-2) bits into one word and counts each trio with popc; the block
//    sums them into (2, batch, trios, tiles) counts.
// 2. scan_tiles, a block an image: an exclusive scan of (code 2 << 32 |
//    code 1) over (trio, tile) in trio-major order gives each (trio, tile)
//    its first slot and each trio its two counts; it parks the slots past
//    the image's candidates.
// 3. scatter_slots, the grid of step 1: a block whose trios all start at or
//    past capacity, or hold no candidate, returns at once; else it loads the
//    tile again and, a trio at a time, ranks its code-1 pixels in plane order
//    (one block scan of four 16-bit column counts packed in 64 bits, then
//    popc within a chunk) and writes the slots below capacity.
// Offsets into the plane and the DoG are 64-bit: a batch's DoG can pass
// 2^31 elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // count and scatter blocks
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;           // 16-byte chunks a thread holds of a tile
constexpr int kScanThreads = 1024;   // the scan's block, one an image
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxTrios = 16;

template <typename Word>
struct Plane {
  static constexpr int kPerChunk = 16 / sizeof(Word);  // words in a chunk
  static constexpr int kPerLane = 4 / sizeof(Word);    // words in 32 bits
  static constexpr int kTile = kThreads * kChunks * kPerChunk;  // words
  static constexpr int kTrios = 4 * sizeof(Word);      // codes a word holds
  // Trio t's bits in a lane pair folded as ones(a) | ones(b) << 1.
  static __device__ __forceinline__ uint32_t trio_mask(int t) {
    return (sizeof(Word) == 2 ? 0x00030003u : 3u) << (2 * t);
  }
};

// Bit 2t set where trio t's code is 1 (low bit, not high), resp. 2.
__device__ __forceinline__ uint32_t ones(uint32_t v) {
  return v & ~(v >> 1) & 0x55555555u;
}
__device__ __forceinline__ uint32_t twos(uint32_t v) {
  return (v >> 1) & ~v & 0x55555555u;
}

// The 16-byte chunk of ``img`` starting at word ``at``, as four 32-bit
// lanes; words at or past ``hw`` read as 0. ``vec``: the image starts on a
// 16-byte boundary (a chunk does, as a tile is a whole number of chunks).
template <typename Word>
__device__ __forceinline__ uint4 load_chunk(const Word* __restrict__ img,
                                            long long hw, long long at,
                                            bool vec) {
  using P = Plane<Word>;
  if (vec && at + P::kPerChunk <= hw) {
    return __ldg(reinterpret_cast<const uint4*>(img + at));
  }
  uint32_t lane[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < P::kPerChunk; ++i) {
    if (at + i < hw) {
      lane[i / P::kPerLane] |= static_cast<uint32_t>(img[at + i])
                               << (8 * sizeof(Word) * (i % P::kPerLane));
    }
  }
  return make_uint4(lane[0], lane[1], lane[2], lane[3]);
}

template <typename Word>
__device__ __forceinline__ void load_tile(const Word* __restrict__ img,
                                          long long hw, int tile,
                                          uint4 (&q)[kChunks]) {
  using P = Plane<Word>;
  const bool vec = (reinterpret_cast<uintptr_t>(img) & 15) == 0;
  const long long start = static_cast<long long>(tile) * P::kTile;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    q[k] = load_chunk<Word>(
        img, hw, start + static_cast<long long>(k * kThreads + threadIdx.x) *
                             P::kPerChunk,
        vec);
  }
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
    count_codes(const Word* __restrict__ plane, long long hw, int n_trios,
                int n_tiles, int* __restrict__ counts) {
  using P = Plane<Word>;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  uint4 q[kChunks];
  load_tile<Word>(plane + b * hw, hw, tile, q);
  int n1[P::kTrios], n2[P::kTrios];
#pragma unroll
  for (int t = 0; t < P::kTrios; ++t) n1[t] = n2[t] = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const uint32_t o0 = ones(q[k].x) | (ones(q[k].y) << 1);
    const uint32_t o1 = ones(q[k].z) | (ones(q[k].w) << 1);
    const uint32_t l0 = twos(q[k].x) | (twos(q[k].y) << 1);
    const uint32_t l1 = twos(q[k].z) | (twos(q[k].w) << 1);
#pragma unroll
    for (int t = 0; t < P::kTrios; ++t) {
      if (t < n_trios) {
        const uint32_t m = P::trio_mask(t);
        n1[t] += __popc(o0 & m) + __popc(o1 & m);
        n2[t] += __popc(l0 & m) + __popc(l1 & m);
      }
    }
  }
  __shared__ int part[kWarps][2 * kMaxTrios];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < P::kTrios; ++t) {
    if (t < n_trios) {
      const int a = __reduce_add_sync(0xffffffffu, n1[t]);
      const int c = __reduce_add_sync(0xffffffffu, n2[t]);
      if (lane == 0) {
        part[warp][t] = a;
        part[warp][kMaxTrios + t] = c;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * n_trios) {
    const int code = threadIdx.x / n_trios;  // 0: code 1, 1: code 2
    const int t = threadIdx.x - code * n_trios;
    int sum = 0;
    for (int i = 0; i < kWarps; ++i) sum += part[i][code * kMaxTrios + t];
    counts[((static_cast<long long>(code) * gridDim.y + b) * n_trios + t) *
               n_tiles +
           tile] = sum;
  }
}

// Warp-inclusive scan of a 64-bit value.
__device__ __forceinline__ unsigned long long warp_scan(unsigned long long v,
                                                        int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kScanThreads)
    scan_tiles(const int* __restrict__ counts, int n_trios, int n_tiles,
               int capacity, const float* __restrict__ dog, int depth,
               long long hw, int w, int* __restrict__ first,
               int* __restrict__ y, int* __restrict__ x, int* __restrict__ s,
               float* __restrict__ value, unsigned char* __restrict__ valid,
               int* __restrict__ n_cand, int* __restrict__ n_low) {
  const int b = blockIdx.x;
  const long long entries = static_cast<long long>(n_trios) * n_tiles;
  const int* c1 = counts + b * entries;
  const int* c2 = counts + (static_cast<long long>(gridDim.x) + b) * entries;
  int* f = first + b * entries;
  __shared__ unsigned long long warp_sum[kScanWarps];
  __shared__ unsigned long long bounds[kMaxTrios + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned long long carry = 0;  // code-2 count << 32 | code-1 count
  for (long long base = 0; base < entries; base += kScanThreads) {
    const long long e = base + threadIdx.x;
    const unsigned long long v =
        e < entries ? (static_cast<unsigned long long>(
                           static_cast<uint32_t>(c2[e]))
                       << 32) |
                          static_cast<uint32_t>(c1[e])
                    : 0ull;
    const unsigned long long inc = warp_scan(v, lane);
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    unsigned long long before = 0, round = 0;
    for (int i = 0; i < kScanWarps; ++i) {
      const unsigned long long ws = warp_sum[i];
      before += i < warp ? ws : 0ull;
      round += ws;
    }
    const unsigned long long excl = carry + before + inc - v;
    if (e < entries) {
      f[e] = static_cast<int>(static_cast<uint32_t>(excl));
      if (e % n_tiles == 0) bounds[e / n_tiles] = excl;
    }
    carry += round;
    __syncthreads();
  }
  if (threadIdx.x == 0) bounds[n_trios] = carry;
  __syncthreads();
  if (threadIdx.x < n_trios) {
    const int t = threadIdx.x;
    n_cand[b * n_trios + t] = static_cast<int>(
        static_cast<uint32_t>(bounds[t + 1]) - static_cast<uint32_t>(bounds[t]));
    n_low[b * n_trios + t] =
        static_cast<int>((bounds[t + 1] >> 32) - (bounds[t] >> 32));
  }
  const uint32_t total = static_cast<uint32_t>(carry);
  const int kept = total < static_cast<uint32_t>(capacity)
                       ? static_cast<int>(total)
                       : capacity;
  const float parked = dog[(static_cast<long long>(b) * depth + 1) * hw + w + 1];
  for (int j = kept + threadIdx.x; j < capacity; j += kScanThreads) {
    const long long at = static_cast<long long>(b) * capacity + j;
    y[at] = 1;
    x[at] = 1;
    s[at] = 1;
    value[at] = parked;
    valid[at] = 0;
  }
}

// Trio t's code-1 bits of a chunk, one bit a word in word order.
template <typename Word>
__device__ __forceinline__ uint32_t chunk_bits(const uint4& q, int t) {
  using P = Plane<Word>;
  const uint32_t lanes[4] = {ones(q.x), ones(q.y), ones(q.z), ones(q.w)};
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < P::kPerChunk; ++i) {
    const int shift = 2 * t + 8 * sizeof(Word) * (i % P::kPerLane);
    bits |= ((lanes[i / P::kPerLane] >> shift) & 1u) << i;
  }
  return bits;
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
    scatter_slots(const Word* __restrict__ plane, long long hw, int w,
                  int n_trios, int n_tiles, int capacity,
                  const int* __restrict__ counts,
                  const int* __restrict__ first,
                  const float* __restrict__ dog, int depth,
                  int* __restrict__ y, int* __restrict__ x,
                  int* __restrict__ s, float* __restrict__ value,
                  unsigned char* __restrict__ valid) {
  using P = Plane<Word>;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const long long entries = static_cast<long long>(n_trios) * n_tiles;
  const int* c1 = counts + b * entries + tile;
  const int* f = first + b * entries + tile;
  // First slots grow in trio order: past the first trio at capacity, none
  // is written. Every thread reads the same entries, so the test is uniform.
  bool any = false;
  for (int t = 0; t < n_trios; ++t) {
    if (f[t * n_tiles] >= capacity) break;
    any |= c1[t * n_tiles] > 0;
  }
  if (!any) return;
  uint4 q[kChunks];
  load_tile<Word>(plane + b * hw, hw, tile, q);
  __shared__ unsigned long long warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = static_cast<long long>(tile) * P::kTile;
  const long long out = static_cast<long long>(b) * capacity;
  for (int t = 0; t < n_trios; ++t) {
    const int first_slot = f[t * n_tiles];
    if (first_slot >= capacity) break;
    if (c1[t * n_tiles] == 0) continue;
    uint32_t bits[kChunks];
    unsigned long long packed = 0;  // a 16-bit field a chunk column
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      bits[k] = chunk_bits<Word>(q[k], t);
      packed |= static_cast<unsigned long long>(__popc(bits[k])) << (16 * k);
    }
    const unsigned long long inc = warp_scan(packed, lane);
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    unsigned long long before = 0, total = 0;
    for (int i = 0; i < kWarps; ++i) {
      const unsigned long long ws = warp_sum[i];
      before += i < warp ? ws : 0ull;
      total += ws;
    }
    __syncthreads();  // warp_sum is read; the next trio may write it
    const unsigned long long excl = before + inc - packed;
    const float* plane_dog =
        dog + (static_cast<long long>(b) * depth + t + 1) * hw;
    int column = first_slot;  // the first slot of chunk column k
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      int slot = column + static_cast<int>((excl >> (16 * k)) & 0xffffu);
      uint32_t m = bits[k];
      const long long at0 =
          start + static_cast<long long>(k * kThreads + threadIdx.x) *
                      P::kPerChunk;
      while (m != 0u && slot < capacity) {
        const int i = __ffs(m) - 1;
        m &= m - 1u;
        const long long p = at0 + i;
        const int py = static_cast<int>(p / w);
        const long long o = out + slot;
        y[o] = py;
        x[o] = static_cast<int>(p - static_cast<long long>(py) * w);
        s[o] = t + 1;
        value[o] = plane_dog[p];
        valid[o] = 1;
        ++slot;
      }
      column += static_cast<int>((total >> (16 * k)) & 0xffffu);
    }
  }
}

template <typename Word>
int launch(const void* packed, const float* dog, int batch, int depth,
           long long hw, int w, int capacity, int n_tiles, int* scratch,
           int* y, int* x, int* s, float* value, unsigned char* valid,
           int* n_cand, int* n_low, cudaStream_t stream) {
  const Word* plane = static_cast<const Word*>(packed);
  const int n_trios = depth - 2;
  const long long entries = static_cast<long long>(batch) * n_trios * n_tiles;
  int* counts = scratch;
  int* first = scratch + 2 * entries;
  const dim3 grid(n_tiles, batch);
  count_codes<Word><<<grid, kThreads, 0, stream>>>(plane, hw, n_trios, n_tiles,
                                                   counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_tiles<<<batch, kScanThreads, 0, stream>>>(counts, n_trios, n_tiles,
                                                 capacity, dog, depth, hw, w,
                                                 first, y, x, s, value, valid,
                                                 n_cand, n_low);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_slots<Word><<<grid, kThreads, 0, stream>>>(
      plane, hw, w, n_trios, n_tiles, capacity, counts, first, dog, depth, y,
      x, s, value, valid);
  return (int)cudaGetLastError();
}

}  // namespace

// Select the candidates of ``batch`` images (see the contract above).
// ``word_bytes`` 2 or 4; ``n_tiles`` the wrapper's count of tiles an image
// (checked against this file's tile); ``scratch`` 3 * batch * trios *
// n_tiles ints; outputs (batch, capacity) y, x, s, value, valid and (batch,
// trios) n_cand, n_low. Returns the first launch's error, or
// cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int sift_select_candidates(const void* packed, int word_bytes,
                                      const float* dog, int batch, int depth,
                                      int h, int w, int capacity, int n_tiles,
                                      int* scratch, int* y, int* x, int* s,
                                      float* value, unsigned char* valid,
                                      int* n_cand, int* n_low, void* stream) {
  const long long hw = static_cast<long long>(h) * w;
  const int n_trios = depth - 2;
  if ((word_bytes != 2 && word_bytes != 4) || n_trios < 1 ||
      n_trios > 4 * word_bytes || h < 2 || w < 2 || batch < 0 ||
      batch > 65535 || capacity < 0 || hw * n_trios >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile = word_bytes == 2 ? Plane<uint16_t>::kTile
                                   : Plane<uint32_t>::kTile;
  if (n_tiles != (hw + tile - 1) / tile) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (word_bytes == 2) {
    return launch<uint16_t>(packed, dog, batch, depth, hw, w, capacity,
                            n_tiles, scratch, y, x, s, value, valid, n_cand,
                            n_low, st);
  }
  return launch<uint32_t>(packed, dog, batch, depth, hw, w, capacity, n_tiles,
                          scratch, y, x, s, value, valid, n_cand, n_low, st);
}
