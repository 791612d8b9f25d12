// Fused gather -> AND -> count for COBS queries, written by hand for
// Hopper (sm_90a).
//
// Replaces cobs_tpu/ops/query_kernel.py::gather_and_count_pallas (and its
// XLA twin, cobs_tpu/query/engine.py::_gather_count_planes) with the same
// contract:
//
//   matrix   u32 [R1, W]       bit-sliced Bloom rows; row R1-1 is all zero
//   rows_idx i32 [B, T, h, P]  row id of (query, term, hash, page);
//                              padding terms point at the zero row
//   out      i32 [B, P*W*32]   out[b, (p*W + w)*32 + bit] =
//              sum over t of bit `bit` of AND_j matrix[rows_idx[b,t,j,p], w]
//
// The output is written in document order (doc = (p*W + w)*32 + bit)
// directly; there is no [B, P, 32, W] layout and transpose as in Pallas.
// T, h >= 1, P >= 1 and W >= 1 are arbitrary (no T % 128 rule).
//
// What bounds it: device memory. Each query reads T*h*P*W*4 bytes of
// rows, scattered at row granularity over a matrix far larger than the
// 50 MB L2, and does about 20 integer ops per 4-byte word read (H100: ~9
// int ops per byte of HBM bandwidth, so the reads are the limit).
// What the design does about it:
//   - one thread owns one 32-bit word column w of page p for query b, and
//     a block of 128 threads owns 128 consecutive words: a warp reads 128
//     contiguous bytes of each row, one coalesced transaction per row;
//   - the block stages the row ids of a tile of terms in shared memory, so
//     every thread reads them by broadcast and the loads of a tile can be
//     issued ahead of the count (the loop is unrolled);
//   - the count stays in registers as a vertical bit-plane counter of 8
//     planes (ripple-carry add of each ANDed word, 16 ops per term instead
//     of 64 for 32 per-bit counters), expanded into 32 per-bit counters at
//     most every 255 terms: the role of the Pallas kernel's carry-save
//     planes, which flush every 128 terms;
//   - row addresses are (size_t)row * W: at 2^21 rows x 3136 words the
//     matrix holds 6.6e9 words, past int32 (no flat int32 view as in
//     cobs_tpu/ops/dma_gather.py).
// Occupancy: at the reference's default shape (B=64, W=384, P=1) one
// thread per word is only ~24k threads. The caller therefore splits T into
// `splits` ranges, one block per (range, word tile, page, query), sized to
// put about 8 blocks on every SM; with splits > 1 the blocks atomicAdd into
// an output the caller zeroed (integer adds commute, so the sum is exact).
// The block's 128 x 32 counts are staged in shared memory first, so the
// stores and atomics go out to consecutive addresses.
//
// Row ids outside [0, R1) read as the zero row, so a bad id cannot read
// outside the matrix.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // word columns per block
constexpr int kTileTerms = 32;   // terms whose row ids a block stages at once
constexpr int kPlanes = 8;       // vertical counter depth
constexpr int kMaxPending = (1 << kPlanes) - 1;  // counts the planes hold
constexpr int kStage = 33;       // padded stride of the output stage

__device__ __forceinline__ void flush(uint32_t (&pl)[kPlanes],
                                      int (&cnt)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kPlanes; ++k) c |= ((pl[k] >> i) & 1u) << k;
    cnt[i] += c;
  }
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) pl[k] = 0u;
}

__global__ void __launch_bounds__(kThreads)
gather_count_kernel(const uint32_t* __restrict__ matrix, int64_t R1, int W,
                    const int32_t* __restrict__ rows_idx, int T, int h,
                    int P, int splits, int terms_per_split, int word_tiles,
                    int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* rows_s = smem;                      // [kTileTerms * h]
  int32_t* stage = smem + kTileTerms * h;      // [kThreads * kStage]

  // block id = ((b * splits + s) * P + p) * word_tiles + wt
  int64_t bid = blockIdx.x;
  const int wt = static_cast<int>(bid % word_tiles);
  bid /= word_tiles;
  const int p = static_cast<int>(bid % P);
  bid /= P;
  const int s = static_cast<int>(bid % splits);
  const int64_t b = bid / splits;

  const int w0 = wt * kThreads;
  const int w = w0 + static_cast<int>(threadIdx.x);
  const bool active = w < W;
  const uint32_t* col = matrix + (active ? w : 0);
  const int64_t t_begin = static_cast<int64_t>(s) * terms_per_split;
  const int64_t t_end = t_begin + terms_per_split < T
                            ? t_begin + terms_per_split : T;
  const int32_t zero_row = static_cast<int32_t>(R1 - 1);

  uint32_t pl[kPlanes];
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) pl[k] = 0u;
  int cnt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cnt[i] = 0;
  int pending = 0;

  for (int64_t t0 = t_begin; t0 < t_end; t0 += kTileTerms) {
    const int nt = static_cast<int>(
        t_end - t0 < kTileTerms ? t_end - t0 : kTileTerms);
    __syncthreads();  // the previous tile's ids are consumed
    for (int i = threadIdx.x; i < nt * h; i += kThreads) {
      const int64_t t = t0 + i / h;
      const int j = i % h;
      int32_t r = rows_idx[((b * T + t) * h + j) * P + p];
      if (r < 0 || static_cast<int64_t>(r) >= R1) r = zero_row;
      rows_s[i] = r;
    }
    __syncthreads();
    if (pending + nt > kMaxPending) {
      flush(pl, cnt);
      pending = 0;
    }
    if (active) {
#pragma unroll 8
      for (int i = 0; i < nt; ++i) {
        const int32_t* rr = rows_s + i * h;
        uint32_t v = __ldg(col + static_cast<size_t>(rr[0]) * W);
        for (int j = 1; j < h; ++j)
          v &= __ldg(col + static_cast<size_t>(rr[j]) * W);
        uint32_t c = v;  // ripple-carry add of v into the planes
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
          const uint32_t carry = pl[k] & c;
          pl[k] ^= c;
          c = carry;
        }
      }
    }
    pending += nt;
  }
  flush(pl, cnt);

  int32_t* st = stage + threadIdx.x * kStage;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = cnt[i];
  __syncthreads();
  const int nw = W - w0 < kThreads ? W - w0 : kThreads;
  int32_t* dst = out + ((b * P + p) * static_cast<int64_t>(W) + w0) * 32;
  for (int i = threadIdx.x; i < nw * 32; i += kThreads) {
    const int32_t val = stage[(i >> 5) * kStage + (i & 31)];
    if (splits == 1)
      dst[i] = val;
    else if (val)
      atomicAdd(dst + i, val);
  }
}

}  // namespace

// Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = launched). `out` must be zeroed when splits > 1.
extern "C" int cobs_gather_count(const void* matrix, long long R1, int W,
                                 const void* rows_idx, int B, int T, int h,
                                 int P, int splits, void* out,
                                 void* stream) {
  const int word_tiles = (W + kThreads - 1) / kThreads;
  const int terms_per_split = (T + splits - 1) / splits;
  const long long blocks = static_cast<long long>(word_tiles) * P * splits * B;
  const size_t smem = (kTileTerms * h + kThreads * kStage) * sizeof(int32_t);
  gather_count_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(matrix), R1, W,
      static_cast<const int32_t*>(rows_idx), T, h, P, splits,
      terms_per_split, word_tiles, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
