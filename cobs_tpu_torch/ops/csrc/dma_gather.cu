// Row gather out = matrix[rows], written by hand for Hopper (sm_90a).
//
// Replaces cobs_tpu/ops/dma_gather.py::dma_gather_rows (the Pallas kernel
// `_kernel` that issues G row DMAs per grid step, double-buffered across
// steps) with a wider contract:
//
//   matrix  u32 [R, W]   any R >= 1, W >= 1
//   rows    i32 [N]      any N >= 1
//   out     u32 [N, W]   out[n] = matrix[rows[n]], or a zero row when
//                        rows[n] is outside [0, R): no id reads outside
//                        the matrix
//
// None of the TPU kernel's constraints carry over: N need not be a
// multiple of a group, W not a multiple of 128 lanes, and row offsets are
// 64-bit ((size_t)row * W), so R*W may pass 2^31 words.
//
// What bounds it: device memory. It moves 2*N*W*4 bytes (every gathered
// row read once and written once) and computes nothing, so the least time
// is 2*N*W*4 / 3.35 TB/s. The reads are scattered at row granularity over
// a matrix far larger than the 50 MB L2. Wide rows (W=6144, 16384) run at
// the card's copy rate, 2.8-2.9 TB/s, as index_select does: every ring
// geometry from 16 to 64 KB and 1 to 8 CTAs per SM lands there, so bytes
// in flight no longer limit it. Small rows (W=384) are bound by issue:
// one lane per CTA issues every copy, hence up to 8 CTAs per SM.
//
// What the design does (bulk path, W % 4 == 0 and 16-byte aligned
// pointers):
//   - a persistent grid of one-warp CTAs (1-8 per SM, more for smaller
//     units) walks the units (a whole row, or a <= 8 KB chunk of a wide
//     row), unit u going to CTA u % grid;
//   - one lane keeps a ring of `stages` shared-memory stages full with the
//     Tensor Memory Accelerator's 1-D bulk copies global -> shared, each
//     stage completed by its mbarrier with the expected byte count;
//   - when a stage lands, the same lane issues the bulk copy shared ->
//     global of that unit and commits it as a bulk group; a stage is
//     refilled only after `cp.async.bulk.wait_group.read` says its store
//     has read it. Half the ring (at most 16 stages) is left to stores
//     still reading, the rest holds loads in flight. No data passes
//     through registers;
//   - the warp fetches the row ids 32 units ahead with one coalesced load
//     and hands them to the lane by shuffle, so no id latency sits between
//     two copies;
//   - an out-of-range id stores a zero row from a zeroed stage;
//   - where the output fits in half the L2, the rows are read with an L2
//     evict-first policy, so rows read once do not push the output out.
// The ring's depth, the stage size, the grid and the policy come from the
// wrapper (ops/dma_gather.py::plan_gather).
// W % 4 != 0 or an unaligned view takes the 4-byte register path: one
// warp per row, eight rows per block, four loads in flight per lane.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_async.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block of the 4-byte path
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // loads in flight per lane (4-byte path)
constexpr int kMaxLag = 16;  // most stages whose store may still read

__host__ __device__ constexpr int64_t header_bytes(int stages) {
  // full barriers (8 B) and zero-row flags (4 B) per stage, 128-aligned
  return (static_cast<int64_t>(stages) * 12 + 127) / 128 * 128;
}

// Stores still reading a stage may number `lag`: the ring keeps `lag`
// stages for them and `stages - lag` loads in flight.
__host__ __device__ constexpr int lag_of(int stages) {
  return stages / 2 < kMaxLag ? stages / 2 : kMaxLag;
}

// cp.async.bulk.wait_group.read takes an immediate: dispatch on `n`.
template <int N = kMaxLag>
__device__ __forceinline__ void bulk_wait_read(int n) {
  if constexpr (N > 0) {
    if (n < N) return bulk_wait_read<N - 1>(n);
  }
  hopper::bulk_wait_read<N>();
}

// (row, chunk) of the units first, first + G, first + 2G, ... of a CTA,
// without a division per step.
struct UnitCursor {
  int64_t row, chunk, chunks, row_step, chunk_step;
  __device__ UnitCursor(int64_t first, int64_t G, int64_t chunks_)
      : row(first / chunks_), chunk(first % chunks_), chunks(chunks_),
        row_step(G / chunks_), chunk_step(G % chunks_) {}
  __device__ void next() {
    row += row_step;
    chunk += chunk_step;
    if (chunk >= chunks) {
      chunk -= chunks;
      ++row;
    }
  }
};

__global__ void __launch_bounds__(32)
gather_rows_bulk(const char* __restrict__ matrix, int64_t R,
                 int64_t row_bytes, const int32_t* __restrict__ rows,
                 int64_t N, char* __restrict__ out, int chunk_bytes,
                 int64_t chunks, int stages, int evict_first) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int32_t* zero_unit = reinterpret_cast<int32_t*>(full + stages);
  unsigned char* zero = smem + header_bytes(stages);
  unsigned char* ring = zero + chunk_bytes;
  const int lane = threadIdx.x;
  const uint64_t policy = hopper::l2_evict_first();

  for (int i = lane * 16; i < chunk_bytes; i += 32 * 16)
    *reinterpret_cast<uint4*>(zero + i) = make_uint4(0, 0, 0, 0);
  hopper::fence_proxy_async();  // the zeros are read by bulk stores
  if (lane == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncwarp();

  const int64_t G = gridDim.x;
  const int64_t first = blockIdx.x;
  const int64_t units = N * chunks;
  const int64_t count = first < units ? (units - 1 - first) / G + 1 : 0;
  const int lag = lag_of(stages);
  const int64_t depth = stages - lag;  // loads in flight
  auto row_id = [&](int64_t k) -> int32_t {
    return k < count ? rows[(first + k * G) / chunks] : 0;
  };
  int32_t cur = row_id(lane), nxt = row_id(32 + lane);
  UnitCursor load_at(first, G, chunks), store_at(first, G, chunks);
  int load_s = 0, store_s = 0;
  uint32_t store_phase = 0;

  for (int64_t t = 0; t < count + depth; ++t) {
    if ((t & 31) == 0 && t > 0 && t < count) {
      cur = nxt;
      nxt = row_id(t + 32 + lane);
    }
    const int32_t r = __shfl_sync(0xffffffffu, cur, t & 31);
    if (lane != 0) continue;
    if (t >= depth) {  // unit t - depth has landed in stage store_s
      hopper::mbar_wait(&full[store_s], store_phase);
      const int64_t off = store_at.chunk * chunk_bytes;
      const int64_t left = row_bytes - off;
      hopper::bulk_store(
          out + store_at.row * row_bytes + off,
          zero_unit[store_s]
              ? zero
              : ring + static_cast<int64_t>(store_s) * chunk_bytes,
          static_cast<uint32_t>(left < chunk_bytes ? left : chunk_bytes));
      hopper::bulk_commit();
      store_at.next();
      if (++store_s == stages) {
        store_s = 0;
        store_phase ^= 1u;
      }
    }
    if (t < count) {  // refill stage load_s with unit t
      // its last store (unit t - stages) has `lag` stores after it
      if (t >= stages) bulk_wait_read(lag);
      if (r < 0 || static_cast<int64_t>(r) >= R) {
        zero_unit[load_s] = 1;
        hopper::mbar_arrive(&full[load_s]);
      } else {
        const int64_t off = load_at.chunk * chunk_bytes;
        const int64_t left = row_bytes - off;
        const uint32_t bytes = static_cast<uint32_t>(
            left < chunk_bytes ? left : chunk_bytes);
        zero_unit[load_s] = 0;
        hopper::mbar_arrive_expect_tx(&full[load_s], bytes);
        unsigned char* dst = ring + static_cast<int64_t>(load_s) * chunk_bytes;
        const char* src = matrix + static_cast<int64_t>(r) * row_bytes + off;
        if (evict_first)
          hopper::bulk_load(dst, src, bytes, &full[load_s], policy);
        else
          hopper::bulk_load(dst, src, bytes, &full[load_s]);
      }
      load_at.next();
      if (++load_s == stages) load_s = 0;
    }
  }
  if (lane == 0) hopper::bulk_wait_all();  // stores done before smem goes
}

__global__ void __launch_bounds__(kThreads)
gather_rows_words(const uint32_t* __restrict__ matrix, int64_t R, int64_t W,
                  const int32_t* __restrict__ rows, int64_t N,
                  uint32_t* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const int lane = threadIdx.x & 31;
  const int32_t r = rows[n];
  uint32_t* dst = out + n * W;
  if (r < 0 || static_cast<int64_t>(r) >= R) {
    for (int64_t i = lane; i < W; i += 32) dst[i] = 0u;
    return;
  }
  const uint32_t* src = matrix + static_cast<size_t>(r) * W;
  int64_t i = lane;
  for (; i + 32 * (kUnroll - 1) < W; i += 32 * kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(src + i + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + 32 * u] = v[u];
  }
  for (; i < W; i += 32) dst[i] = __ldg(src + i);
}

}  // namespace

// Dynamic shared memory of the bulk path for this ring (bytes).
extern "C" long long cobs_dma_gather_smem(int chunk_bytes, int stages) {
  return header_bytes(stages) +
         static_cast<long long>(stages + 1) * chunk_bytes;
}

// Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = launched). vec = 1 takes the bulk path (needs
// W % 4 == 0, 16-byte aligned matrix and out, chunk_bytes a multiple of
// 16, stages >= 2, `grid` persistent CTAs; evict_first = 1 reads the
// rows with an L2 evict-first policy); vec = 0 the 4-byte path
// (chunk_bytes, stages, grid and evict_first unused).
extern "C" int cobs_dma_gather(const void* matrix, long long R, long long W,
                               const void* rows, long long N, void* out,
                               int vec, int chunk_bytes, int stages,
                               int grid, int evict_first, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    const long long row_bytes = W * 4;
    const long long chunks = (row_bytes + chunk_bytes - 1) / chunk_bytes;
    const long long smem = cobs_dma_gather_smem(chunk_bytes, stages);
    cudaError_t e = cudaFuncSetAttribute(
        gather_rows_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    gather_rows_bulk<<<grid, 32, smem, s>>>(
        static_cast<const char*>(matrix), R, row_bytes,
        static_cast<const int32_t*>(rows), N, static_cast<char*>(out),
        chunk_bytes, chunks, stages, evict_first);
  } else {
    const long long blocks = (N + kWarps - 1) / kWarps;
    gather_rows_words<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(matrix), R, W,
        static_cast<const int32_t*>(rows), N, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
