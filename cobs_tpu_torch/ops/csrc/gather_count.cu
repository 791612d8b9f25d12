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
// T, h, P and W >= 1 are arbitrary (no T % 128 rule, no limit on h).
// Row ids outside [0, R1) read as the zero row, so a bad id cannot read
// outside the matrix; row addresses are (size_t)row * W.
//
// What bounds it. The bytes: each query reads T*h*P*W*4 bytes of rows,
// scattered at row granularity over a matrix far larger than the 50 MB
// L2. Before the bytes, two latencies: a barrier round trip per stage
// between the warp that copies rows in and the warps that count them, and
// the dependent chain of logic ops that adds a term to the counters. A
// CTA pays both once per term, in series, so a CTA with few terms or few
// CTAs per SM is latency-bound. At B=1024 (W=384, T=1000) the kernel reads
// rows at 80 % of the card's 3.35 TB/s. At the main path's B=64 it is 55 %
// of its byte bound: one wave of 320 CTAs, whose fill, drain and cluster
// reduction nothing hides, and a cluster must fit in one GPC, which leaves
// some SMs without a CTA. What this design does:
//   - a CTA owns (query b, page p, a slice of 128-512 words, a range of
//     terms). One producer warp keeps a ring of `stages` shared-memory
//     stages full. A stage holds G (term, hash) row slices (G a power of 2,
//     <= 8, about 8 KB): G lanes each issue one 1-D TMA bulk copy in the
//     same instruction, all completed through the stage's `full` mbarrier
//     with the expected byte count, so a barrier round trip serves G rows.
//     The warp fetches the row ids 32 at a time with one coalesced load, a
//     batch ahead, and hands them out by shuffle. W % 4 != 0 (no 16-byte
//     alignment) fills the same ring with 4-byte cp.async from all 32
//     lanes instead;
//   - four consumer warps read their words from the stages (thread c owns
//     words c, c+128, ...: conflict-free reads and flushes), AND the h
//     rows of each term, release a stage through its `empty` mbarrier once
//     read, and add 8 terms at a time into a vertical 8-plane counter in
//     registers: a Harley-Seal tree of carry-save adders, 3 ops per word
//     and term and no branch. The counter is flushed into per-bit counts
//     in shared memory every 240 terms;
//   - the term ranges of one (b, p, slice) are the CTAs of one thread-
//     block cluster (<= 8). After cluster.sync() each CTA sums its
//     1/cluster share of the counts over its peers' shared memory
//     (distributed shared memory) and stores it once, in document order.
//     There is no zeroing launch and no atomic, and the sums are the same,
//     in the same order, on every run;
//   - the wrapper (ops/query_kernel.py::plan_gather_count) sizes slices,
//     ring, cluster and grid. It narrows the slices when a batch is too
//     small to fill the card. It takes as a wave the clusters that the
//     card reports it can hold at once (cobs_gather_count_max_clusters).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;  // threads owning words
constexpr int kThreads = 32 + kConsumers;        // + the producer warp
constexpr int kPlanes = 8;  // vertical counter depth: counts up to 255
constexpr int kGroup = 8;   // terms added to the counters at once
constexpr int kFlushTerms = 240;  // whole groups the planes hold
constexpr int kStride = 33;  // padded stride of a word's 32 counts
constexpr int kMaxCluster = 8;   // portable cluster size

__host__ __device__ constexpr int64_t align128(int64_t x) {
  return (x + 127) / 128 * 128;
}

// Shared memory: 2 mbarriers per stage | counts [slice_w][kStride] |
// ring [stages][stage_rows][row_words], each part 128-byte aligned.
__host__ __device__ constexpr int64_t counts_offset(int stages) {
  return align128(16LL * stages);
}
__host__ __device__ constexpr int64_t ring_offset(int slice_w, int stages) {
  return counts_offset(stages) + align128(4LL * kStride * slice_w);
}
__host__ __device__ constexpr int row_words(int slice_w) {
  return (slice_w + 3) / 4 * 4;  // 16-byte row stride
}

template <int WPT>
__device__ __forceinline__ void flush(uint32_t (&pl)[WPT][kPlanes],
                                      int32_t* counts, int c, int nw) {
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int wl = c + kConsumers * k;
    if (wl < nw) {
      int32_t* dst = counts + wl * kStride;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        int v = 0;
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) v |= ((pl[k][q] >> i) & 1u) << q;
        dst[i] += v;
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) pl[k][q] = 0u;
  }
}

// Carry-save adder: sum + a + b = sum' + 2 * carry, bitwise (a majority
// and a 3-way xor, one LOP3 each).
__device__ __forceinline__ uint32_t csa(uint32_t& sum, uint32_t a,
                                        uint32_t b) {
  const uint32_t s = sum;
  sum = s ^ a ^ b;
  return (a & b) | (s & (a ^ b));
}

// Adds 8 terms' bit-vectors x[u][k] to the counters: a Harley-Seal tree
// of 7 carry-save adders folds them into planes 0..2 and one carry of
// weight 8, ripple-added into planes 3..7. 24 logic ops per word for 8
// terms, against 128 for a ripple add per term, and no branch.
template <int WPT>
__device__ __forceinline__ void add_group(uint32_t (&pl)[WPT][kPlanes],
                                          const uint32_t (&x)[kGroup][WPT]) {
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    uint32_t* p = pl[k];
    uint32_t a2 = csa(p[0], x[0][k], x[1][k]);
    uint32_t b2 = csa(p[0], x[2][k], x[3][k]);
    const uint32_t a4 = csa(p[1], a2, b2);
    a2 = csa(p[0], x[4][k], x[5][k]);
    b2 = csa(p[0], x[6][k], x[7][k]);
    const uint32_t b4 = csa(p[1], a2, b2);
    uint32_t carry = csa(p[2], a4, b4);
#pragma unroll
    for (int q = 3; q < kPlanes; ++q) {
      const uint32_t next = p[q] & carry;
      p[q] ^= carry;
      carry = next;
    }
  }
}

template <int WPT, bool kBulk>
__global__ void __launch_bounds__(kThreads)
gather_count_kernel(const uint32_t* __restrict__ matrix, int64_t R1, int W,
                    const int32_t* __restrict__ rows_idx, int T, int h,
                    int P, int slice_w, int n_slices, int tpc, int stages,
                    int G, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  int32_t* counts = reinterpret_cast<int32_t*>(smem + counts_offset(stages));
  uint32_t* ring =
      reinterpret_cast<uint32_t*>(smem + ring_offset(slice_w, stages));
  const int rw = row_words(slice_w);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  int64_t cid = blockIdx.x / cs;  // (b, p, slice) of the cluster
  const int slice = static_cast<int>(cid % n_slices);
  cid /= n_slices;
  const int p = static_cast<int>(cid % P);
  const int64_t b = cid / P;
  const int w0 = slice * slice_w;
  const int nw = W - w0 < slice_w ? W - w0 : slice_w;
  const int64_t t_begin = static_cast<int64_t>(rank) * tpc;
  const int64_t t_end = t_begin + tpc < T ? t_begin + tpc : T;
  const int nterms = t_end > t_begin ? static_cast<int>(t_end - t_begin) : 0;
  const int64_t nflat = static_cast<int64_t>(nterms) * h;  // row slices

  const int tid = threadIdx.x;
  for (int i = tid; i < nw * kStride; i += kThreads) counts[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], kBulk ? 1 : 32);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int lane = tid & 31;
  if (tid < 32) {
    // producer warp: stage g holds the flat (term, hash) row slices
    // [g * G, g * G + G); G divides 32
    const int64_t id0 = (b * T + t_begin) * h;  // flat (t, j) of the first
    const int32_t zero_row = static_cast<int32_t>(R1 - 1);
    auto row_id = [&](int64_t f) -> int32_t {
      if (f >= nflat) return zero_row;
      const int32_t r = rows_idx[(id0 + f) * P + p];
      return r < 0 || static_cast<int64_t>(r) >= R1 ? zero_row : r;
    };
    int32_t cur = row_id(lane), nxt = row_id(32 + lane);
    int s = 0;
    uint32_t phase = 0;
    for (int64_t f = 0; f < nflat; f += G) {
      if ((f & 31) == 0 && f > 0) {
        cur = nxt;
        nxt = row_id(f + 32 + lane);
      }
      // lane i < G: the row id of row slice f + i
      const int32_t r = __shfl_sync(0xffffffffu, cur,
                                    static_cast<int>(f & 31) + (lane & (G - 1)));
      const int rows = nflat - f < G ? static_cast<int>(nflat - f) : G;
      uint32_t* dst = ring + static_cast<int64_t>(s) * G * rw;
      if (kBulk) {
        // one copy per lane; the stage completes on lane 0's arrival
        // and the bytes of all its copies
        if (lane < rows) {
          hopper::mbar_wait(&empty[s], phase ^ 1u);
          if (lane == 0)
            hopper::mbar_arrive_expect_tx(&full[s], 4u * nw * rows);
          hopper::bulk_load(dst + lane * rw,
                            matrix + static_cast<size_t>(r) * W + w0,
                            4u * nw, &full[s]);
        }
        __syncwarp();
      } else {
        hopper::mbar_wait(&empty[s], phase ^ 1u);
        for (int i = 0; i < rows; ++i) {
          const int32_t ri = __shfl_sync(0xffffffffu, r, i);
          const uint32_t* src = matrix + static_cast<size_t>(ri) * W + w0;
          for (int w = lane; w < nw; w += 32)
            hopper::cp_async4(dst + i * rw + w, src + w);
        }
        hopper::cp_async_arrive(&full[s]);
      }
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
  } else {
    // consumer warps: AND the h row slices of each term, count 8 terms'
    // bits at a time
    const int c = tid - 32;
    uint32_t pl[WPT][kPlanes];
#pragma unroll
    for (int k = 0; k < WPT; ++k)
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) pl[k][q] = 0u;
    int added = 0;  // terms in the planes since the last flush
    int s = 0, slot = 0;  // stage and row in it of the next row slice
    uint32_t phase = 0;
    for (int t0 = 0; t0 < nterms; t0 += kGroup) {
      uint32_t x[kGroup][WPT];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const bool live = t0 + u < nterms;  // else a zero term
#pragma unroll
        for (int k = 0; k < WPT; ++k) x[u][k] = live ? 0xffffffffu : 0u;
        for (int j = 0; live && j < h; ++j) {
          if (slot == 0) hopper::mbar_wait(&full[s], phase);
          const uint32_t* row = ring + (static_cast<int64_t>(s) * G + slot) * rw;
#pragma unroll
          for (int k = 0; k < WPT; ++k) {
            const int wl = c + kConsumers * k;
            if (wl < nw) x[u][k] &= row[wl];
          }
          if (++slot == G) {  // the stage is read: release it
            slot = 0;
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(&empty[s]);
            if (++s == stages) {
              s = 0;
              phase ^= 1u;
            }
          }
        }
      }
      if (added == kFlushTerms) {
        flush<WPT>(pl, counts, c, nw);
        added = 0;
      }
      add_group<WPT>(pl, x);
      added += kGroup;
    }
    flush<WPT>(pl, counts, c, nw);
  }

  // every CTA's counts are in its shared memory: reduce across the cluster
  cluster.sync();
  const int total = nw * 32;
  const int share = (total + cs - 1) / cs;
  const int lo = rank * share;
  const int hi = lo + share < total ? lo + share : total;
  int32_t* dst = out + ((b * P + p) * static_cast<int64_t>(W) + w0) * 32;
  const int32_t* peer[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    peer[q] = cluster.map_shared_rank(counts, q < cs ? q : 0);
#pragma unroll 2
  for (int e = lo + tid; e < hi; e += kThreads) {
    const int idx = (e >> 5) * kStride + (e & 31);
    int32_t v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v[q] = q < cs ? peer[q][idx] : 0;
    int32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) sum += v[q];
    dst[e] = sum;  // summed in rank order: the same on every run
  }
  cluster.sync();  // peers read this CTA's counts until here
}

using KernelFn = void (*)(const uint32_t*, int64_t, int, const int32_t*, int,
                         int, int, int, int, int, int, int, int32_t*);

// The kernel variant for `wpt` words per consumer thread (1..4) and the
// bulk or 4-byte path, with its shared-memory limit raised to `smem`;
// nullptr for a bad wpt, an error in `*err`.
KernelFn kernel_for(int wpt, int bulk, int64_t smem, cudaError_t* err) {
  KernelFn k = nullptr;
  switch (wpt * 2 + (bulk ? 1 : 0)) {
    case 2: k = gather_count_kernel<1, false>; break;
    case 3: k = gather_count_kernel<1, true>; break;
    case 4: k = gather_count_kernel<2, false>; break;
    case 5: k = gather_count_kernel<2, true>; break;
    case 6: k = gather_count_kernel<3, false>; break;
    case 7: k = gather_count_kernel<3, true>; break;
    case 8: k = gather_count_kernel<4, false>; break;
    case 9: k = gather_count_kernel<4, true>; break;
  }
  *err = k == nullptr ? cudaErrorInvalidValue
                      : cudaFuncSetAttribute(
                            k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem));
  return k;
}

int64_t smem_bytes(int slice_w, int stages, int G) {
  return ring_offset(slice_w, stages) + 4LL * stages * G * row_words(slice_w);
}

cudaLaunchConfig_t cluster_config(long long grid, int64_t smem,
                                  cudaLaunchAttribute* attr, int cluster,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of `cluster` CTAs, each with the shared memory of this
// slice width and ring, the device holds at once (clusters are placed
// within one GPC, so this is less than the CTAs per SM times the SMs,
// divided by the cluster size). A negative value is minus a CUDA error.
extern "C" int cobs_gather_count_max_clusters(int slice_w, int stages,
                                              int G, int wpt, int bulk,
                                              int cluster) {
  const int64_t smem = smem_bytes(slice_w, stages, G);
  cudaError_t e;
  KernelFn kernel = kernel_for(wpt, bulk, smem, &e);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cluster, smem, &attr, cluster, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Launches on `stream` without synchronizing and returns the CUDA error
// (0 = launched). The grid is B * P * n_slices clusters of `cluster` CTAs;
// CTA rank r of a cluster counts terms [r * tpc, (r + 1) * tpc). wpt =
// ceil(slice_w / 128) in 1..4; G (row slices per stage) in 1, 2, 4, 8,
// 16, 32; bulk = 1 needs W % 4 == 0, slice_w % 4 == 0 and a 16-byte
// aligned matrix. `out` needs no initialisation.
extern "C" int cobs_gather_count(const void* matrix, long long R1, int W,
                                 const void* rows_idx, int B, int T, int h,
                                 int P, int slice_w, int n_slices, int wpt,
                                 int cluster, int tpc, int stages, int G,
                                 int bulk, void* out, void* stream) {
  const long long grid =
      static_cast<long long>(B) * P * n_slices * cluster;
  const int64_t smem = smem_bytes(slice_w, stages, G);
  cudaError_t e;
  KernelFn kernel = kernel_for(wpt, bulk, smem, &e);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      grid, smem, &attr, cluster, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(matrix),
                         static_cast<int64_t>(R1), W,
                         static_cast<const int32_t*>(rows_idx), T, h, P,
                         slice_w, n_slices, tpc, stages, G,
                         static_cast<int32_t*>(out));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
