// Construction bit scatter words[docs[i] / 32, rows[i]] |= 1 << docs[i] % 32,
// written by hand for Hopper (sm_90a).
//
// Replaces the jitted XLA scatter and pack of cobs_tpu/construct/device.py
// on one device: `_scatter_single` (:46) sets plane[rows, docs] = 1 in a
// u8 indicator plane [signature_size + 1, docs_pad], in chunks of
// UPDATE_CHUNK updates, and `_pack_plane` (:86) packs the plane into
// little-endian u32 words, bit d % 32 of word d / 32 being document d.
// Here the bits go straight into the packed words, held word-major:
//
//   words  u32 [Wc, R1]  the batch's Bloom matrix, Wc = ceil(docs / 32):
//                        strip c holds word c of every row (documents
//                        32c .. 32c + 31); updated in place. The caller
//                        transposes it to the file's [R1, Wc] rows once.
//   rows   i32 [n]       Bloom row of each update
//   docs   i32 [n]       document of each update
//
// An update outside [0, R1) x [0, 32 * Wc) is dropped, as the JAX scatter's
// mode="drop" drops ids past the end (JAX wraps negative ids first;
// construction makes none). OR is idempotent and commutes, so duplicate
// k-mers need no dedup pass and the order in which the atomics land cannot
// change a bit: the words are bit-identical run to run and equal the
// plane's pack.
// No u8 plane exists, so the matrix takes 8x less device memory.
//
// What bounds it: the bytes of the updates it reads (8 per update) and
// the words it sets; the caller counts (8 n + 8 * distinct words) bytes
// over the memory rate. Within one document the Bloom rows are random, so
// in the row-major layout [R1, Wc] of the control
// (experiments/csrc/construct_scatter_control.cu) nearly every update
// lands in its own 32-byte sector of a matrix several times the 50 MB L2,
// and each atomic costs a sector read and write-back in device memory.
//
// What the design does about it, in two steps (the step 1 kernel stays for
// small chunks and for matrices with too many row blocks to bin):
//   1. Word-major words. All updates of document d fall in strip d / 32,
//      and the device build stages documents in index order on a few
//      workers, so one launch touches one or two strips (4 R1 bytes each,
//      11 MB at 2.8 M rows), which stay in the L2: the atomic ORs resolve
//      there, and device memory sees each strip about once per run of
//      documents instead of a sector per update (`scatter_or`: four
//      updates per thread by 16-byte loads, one RED.OR each). That leaves
//      the L2's rate of atomics as the limit.
//   2. Binning by row block (`bin_place`, then `bin_or`). A strip is cut
//      into blocks of kRowBlock rows (a 64 KB tile). `bin_place` gives each
//      CTA 8,192 updates: it counts them by (strip slot, row block) in a
//      shared-memory histogram, reserves each bin's run in a scratch buffer
//      with one global atomic per bin, sorts them by bin in shared memory
//      (a counting sort) and writes each run out coalesced, 4 bytes per
//      update (row within the block, bit). Strip slots are the `slots`
//      strips from just below docs[0]'s: updates of other strips, and
//      those past a bin's capacity (a skewed chunk), take the step 1 path
//      at once. `bin_or` then gives each bin one CTA: it reads its tile of
//      the strip into shared memory in one coalesced pass, ORs the bin's
//      updates into it with shared-memory atomics (duplicates merge there),
//      and writes the tile back in one pass; a bin with few updates ORs
//      them straight into device memory instead. Device memory then moves
//      the updates once, 4 bytes per update through the scratch, and each
//      touched tile twice.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // scatter_or
constexpr int kRowBlockLog = 14;      // rows per bin: 16,384, a 64 KB tile
constexpr int kRowBlock = 1 << kRowBlockLog;
constexpr int kPlaceThreads = 512;    // bin_place
constexpr int kPerThread = 16;        // updates per bin_place thread
constexpr int kOrThreads = 512;       // bin_or
constexpr int kMaxBins = 8192;        // shared histogram of bin_place
constexpr int kCursorStride = 32;     // ints per bin cursor: one 128 B line
                                      // each, so the CTAs' atomics on them
                                      // spread over the L2's slices
constexpr int kTileLoads = kRowBlock / kOrThreads;  // tile words per thread

__device__ __forceinline__ void set_bit(uint32_t* __restrict__ words,
                                        int64_t R1, int64_t Wc, int32_t r,
                                        int32_t d) {
  if (r < 0 || r >= R1 || d < 0 || (d >> 5) >= Wc) return;
  atomicOr(words + static_cast<int64_t>(d >> 5) * R1 + r, 1u << (d & 31));
}

__global__ void __launch_bounds__(kThreads)
    scatter_or(uint32_t* __restrict__ words, int64_t R1, int64_t Wc,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ docs, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = n / 4;  // rows and docs are 16-byte aligned
  const int4* rows4 = reinterpret_cast<const int4*>(rows);
  const int4* docs4 = reinterpret_cast<const int4*>(docs);
  for (int64_t i = first; i < n4; i += stride) {
    const int4 r = __ldg(rows4 + i);
    const int4 d = __ldg(docs4 + i);
    set_bit(words, R1, Wc, r.x, d.x);
    set_bit(words, R1, Wc, r.y, d.y);
    set_bit(words, R1, Wc, r.z, d.z);
    set_bit(words, R1, Wc, r.w, d.w);
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride)
    set_bit(words, R1, Wc, __ldg(rows + i), __ldg(docs + i));
}

// First strip of the launch's `slots` strip slots: one below docs[0]'s
// (the device build's workers stage a few neighbouring documents at a
// time), kept inside [0, Wc - slots]. Every CTA of both kernels reads it.
__device__ __forceinline__ int64_t strip_base(const int32_t* docs,
                                              int64_t Wc, int slots) {
  const int64_t s0 = static_cast<int64_t>(__ldg(docs) >> 5) - 1;
  const int64_t hi = Wc - slots;
  return s0 < 0 ? 0 : s0 > hi ? hi : s0;
}

// Exclusive prefix sum of v[0 .. m) in shared memory, in place, by the
// whole block (kPlaceThreads threads); returns the total. `warp_s` holds
// kPlaceThreads / 32 ints.
__device__ int block_exclusive_scan(int* v, int m, int* warp_s) {
  const int per = (m + kPlaceThreads - 1) / kPlaceThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < m ? lo + per : m;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += v[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;  // inclusive scan of the per-thread sums within the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kPlaceThreads / 32 ? warp_s[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kPlaceThreads / 32) warp_s[lane] = w;  // inclusive
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_s[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = v[i];
    v[i] = run;
    run += c;
  }
  const int total = warp_s[kPlaceThreads / 32 - 1];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kPlaceThreads)
    bin_place(uint32_t* __restrict__ words, int64_t R1, int64_t Wc,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ docs, int64_t n, int slots,
              int nblk, int64_t cap, uint32_t* __restrict__ scratch,
              int* __restrict__ cursor) {
  // count[nbins] (then local offsets), base[nbins], the CTA's entries
  // sorted by bin with their scratch indices, and the scan's warp sums
  extern __shared__ int place_s[];
  const int nbins = slots * nblk;
  int* count = place_s;
  int* base = count + nbins;
  uint32_t* sorted = reinterpret_cast<uint32_t*>(base + nbins);
  int* sorted_at = reinterpret_cast<int*>(sorted + kPlaceThreads * kPerThread);
  int* warp_s = sorted_at + kPlaceThreads * kPerThread;
  for (int b = threadIdx.x; b < nbins; b += kPlaceThreads) count[b] = 0;
  const int64_t s0 = strip_base(docs, Wc, slots);
  __syncthreads();

  // every load first, in a loop of its own: the atomics below would
  // otherwise hold each next load back a full memory latency
  int32_t rv[kPerThread], dv[kPerThread];
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kPlaceThreads * kPerThread +
      threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = first + static_cast<int64_t>(j) * kPlaceThreads;
    rv[j] = i < n ? __ldg(rows + i) : -1;
    dv[j] = i < n ? __ldg(docs + i) : -1;
  }
  // per update: its bin << 16 | its rank in the bin (both < 2^14), or -1
  int slot_of[kPerThread];
  uint32_t entry[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    slot_of[j] = -1;
    const int32_t r = rv[j], d = dv[j];
    if (r < 0 || r >= R1 || d < 0 || (d >> 5) >= Wc) continue;  // dropped
    const int64_t slot = (d >> 5) - s0;
    if (slot < 0 || slot >= slots) {  // a strip outside the slots
      atomicOr(words + static_cast<int64_t>(d >> 5) * R1 + r,
               1u << (d & 31));
      continue;
    }
    const int bin = static_cast<int>(slot) * nblk + (r >> kRowBlockLog);
    entry[j] = static_cast<uint32_t>(r & (kRowBlock - 1)) << 5 |
               static_cast<uint32_t>(d & 31);
    slot_of[j] = bin << 16 | atomicAdd(&count[bin], 1);
  }
  __syncthreads();
  // each bin's run in the scratch: one global atomic per non-empty bin
  for (int b = threadIdx.x; b < nbins; b += kPlaceThreads) {
    const int c = count[b];
    base[b] = c ? atomicAdd(&cursor[b * kCursorStride], c) : 0;
  }
  const int m = block_exclusive_scan(count, nbins, warp_s);
  // counting sort by bin in shared memory, each entry with its index in
  // the scratch (bins * cap < 2^31), or -1 past its bin's capacity ...
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (slot_of[j] < 0) continue;
    const int bin = slot_of[j] >> 16, rank = slot_of[j] & 0xFFFF;
    const int at = count[bin] + rank;
    const int pos = base[bin] + rank;
    sorted[at] = entry[j];
    sorted_at[at] = pos < cap ? bin * static_cast<int>(cap) + pos : -1;
    if (pos >= cap) {  // straight to device memory
      const int64_t r = static_cast<int64_t>(bin % nblk) * kRowBlock +
                        (entry[j] >> 5);
      atomicOr(words + (s0 + bin / nblk) * R1 + r, 1u << (entry[j] & 31));
    }
  }
  __syncthreads();
  // ... so that neighbouring threads write neighbouring scratch words
  for (int i = threadIdx.x; i < m; i += kPlaceThreads) {
    const int at = sorted_at[i];
    if (at >= 0) scratch[at] = sorted[i];
  }
}

// Shared memory of bin_place for `nbins` bins.
size_t place_smem(int nbins) {
  return 2 * static_cast<size_t>(nbins) * sizeof(int) +
         static_cast<size_t>(kPlaceThreads) * kPerThread *
             (sizeof(uint32_t) + sizeof(int)) +
         kPlaceThreads / 32 * sizeof(int);
}

__global__ void __launch_bounds__(kOrThreads)
    bin_or(uint32_t* __restrict__ words, int64_t R1, int64_t Wc,
           const int32_t* __restrict__ docs, int slots, int nblk,
           int64_t cap, const uint32_t* __restrict__ scratch,
           const int* __restrict__ cursor) {
  extern __shared__ uint32_t tile[];  // kRowBlock words of one strip
  const int b = blockIdx.x;
  const int filled = cursor[b * kCursorStride];
  const int count = filled < cap ? filled : static_cast<int>(cap);
  if (count == 0) return;
  const int64_t strip = strip_base(docs, Wc, slots) + b / nblk;
  const int64_t r0 = static_cast<int64_t>(b % nblk) * kRowBlock;
  const int nrows = R1 - r0 < kRowBlock ? static_cast<int>(R1 - r0)
                                         : kRowBlock;
  uint32_t* dst = words + strip * R1 + r0;
  const uint32_t* e = scratch + static_cast<int64_t>(b) * cap;
  if (count < nrows / 16) {  // few updates: cheaper than moving the tile
    for (int i = threadIdx.x; i < count; i += kOrThreads) {
      const uint32_t x = __ldg(e + i);
      atomicOr(dst + (x >> 5), 1u << (x & 31));
    }
    return;
  }
  // every load of the tile in flight at once (the strip's rows start at
  // any word, so 4-byte loads), then into shared memory
  uint32_t v[kTileLoads];
#pragma unroll
  for (int k = 0; k < kTileLoads; ++k) {
    const int i = threadIdx.x + k * kOrThreads;
    v[k] = i < nrows ? dst[i] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kTileLoads; ++k)
    tile[threadIdx.x + k * kOrThreads] = v[k];
  __syncthreads();
  // the bin's entries four at a time (its run starts on 16 bytes: cap is a
  // multiple of 4), several loads in flight per thread
  // (the loads of a round first, then its atomics)
  const uint4* e4 = reinterpret_cast<const uint4*>(e);
  const int n4 = count / 4;
  constexpr int kRound = 4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += kRound * kOrThreads) {
    uint4 x[kRound];
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int i = i0 + k * kOrThreads;
      x[k] = i < n4 ? __ldg(e4 + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      if (i0 + k * kOrThreads >= n4) break;
      atomicOr(tile + (x[k].x >> 5), 1u << (x[k].x & 31));
      atomicOr(tile + (x[k].y >> 5), 1u << (x[k].y & 31));
      atomicOr(tile + (x[k].z >> 5), 1u << (x[k].z & 31));
      atomicOr(tile + (x[k].w >> 5), 1u << (x[k].w & 31));
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < count; i += kOrThreads) {
    const uint32_t x = __ldg(e + i);
    atomicOr(tile + (x >> 5), 1u << (x & 31));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows; i += kOrThreads) dst[i] = tile[i];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Step 1 alone: words int32 [Wc, R1], rows/docs int32 [n] 16-byte
// aligned, all on the current device; `grid` blocks of kThreads threads on
// `stream`. Returns the CUDA error of the launch (0 on success). n == 0
// launches nothing.
int cobs_construct_scatter(void* words, long long R1, long long Wc,
                           const void* rows, const void* docs, long long n,
                           int grid, void* stream) {
  if (n == 0) return 0;
  if (grid < 1 || !aligned16(rows) || !aligned16(docs))
    return static_cast<int>(cudaErrorInvalidValue);
  scatter_or<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), R1, Wc,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(docs),
      n);
  return static_cast<int>(cudaGetLastError());
}

// Step 2: the same update with binning by row block. `slots` strips of
// `nblk` row blocks make slots * nblk <= kMaxBins bins of `cap` entries
// (a multiple of 4) in `scratch` (u32 [slots * nblk * cap], 16-byte
// aligned); `cursor` (int32 [slots * nblk * 32], one cursor every 32
// ints) must be zero. Two launches on `stream`; returns the first CUDA
// error.
int cobs_construct_scatter_binned(void* words, long long R1, long long Wc,
                                  const void* rows, const void* docs,
                                  long long n, int slots, int nblk,
                                  long long cap, void* scratch, void* cursor,
                                  void* stream) {
  if (n == 0) return 0;
  const int nbins = slots * nblk;
  if (slots < 1 || slots > Wc || nblk < 1 || nbins > kMaxBins || cap < 4 ||
      cap % 4 || nbins * cap >= (1LL << 31) || !aligned16(scratch) ||
      static_cast<long long>(nblk) * kRowBlock < R1)
    return static_cast<int>(cudaErrorInvalidValue);
  // shared memory past 48 KB, set on the current device at every call
  cudaError_t e = cudaFuncSetAttribute(
      bin_place, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(place_smem(kMaxBins)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bin_or,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRowBlock * static_cast<int>(sizeof(uint32_t)));
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_cta = static_cast<long long>(kPlaceThreads) * kPerThread;
  const unsigned place_grid =
      static_cast<unsigned>((n + per_cta - 1) / per_cta);
  bin_place<<<place_grid, kPlaceThreads, place_smem(nbins), st>>>(
      static_cast<uint32_t*>(words), R1, Wc,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(docs),
      n, slots, nblk, cap, static_cast<uint32_t*>(scratch),
      static_cast<int*>(cursor));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bin_or<<<nbins, kOrThreads, kRowBlock * sizeof(uint32_t), st>>>(
      static_cast<uint32_t*>(words), R1, Wc,
      static_cast<const int32_t*>(docs), slots, nblk, cap,
      static_cast<const uint32_t*>(scratch),
      static_cast<const int*>(cursor));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
