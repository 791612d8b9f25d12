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
// a matrix far larger than the 50 MB L2. What the design does:
//   - one warp per row and 8 rows per block; the warp reads the row id
//     itself and then moves the row with 16-byte loads and stores when
//     W % 4 == 0 and both pointers are 16-byte aligned (4-byte words
//     otherwise), so a warp instruction moves 512 contiguous bytes;
//   - each lane issues four independent loads before its four stores, so
//     every warp keeps 2 KB in flight and the SM's many resident warps
//     cover HBM latency (no cp.async/TMA staging yet: the data goes
//     straight from registers to the output).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // loads in flight per lane

template <typename V>
__device__ __forceinline__ V load(const V* p) {
  return __ldg(p);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ matrix, int64_t R, int64_t Wv,
                   const int32_t* __restrict__ rows, int64_t N,
                   V* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const int lane = threadIdx.x & 31;
  const int32_t r = rows[n];
  V* dst = out + n * Wv;
  if (r < 0 || static_cast<int64_t>(r) >= R) {
    const V zero{};
    for (int64_t i = lane; i < Wv; i += 32) dst[i] = zero;
    return;
  }
  const V* src = matrix + static_cast<size_t>(r) * Wv;
  int64_t i = lane;
  for (; i + 32 * (kUnroll - 1) < Wv; i += 32 * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load(src + i + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + 32 * u] = v[u];
  }
  for (; i < Wv; i += 32) dst[i] = load(src + i);
}

}  // namespace

// Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = launched). vec = 1 moves uint4 (needs W % 4 == 0
// and 16-byte aligned matrix and out), vec = 0 moves 4-byte words.
extern "C" int cobs_dma_gather(const void* matrix, long long R, long long W,
                               const void* rows, long long N, void* out,
                               int vec, void* stream) {
  const long long blocks = (N + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    gather_rows_kernel<uint4><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
        static_cast<const uint4*>(matrix), R, W / 4,
        static_cast<const int32_t*>(rows), N, static_cast<uint4*>(out));
  else
    gather_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), kThreads,
                                   0, s>>>(
        static_cast<const uint32_t*>(matrix), R, W,
        static_cast<const int32_t*>(rows), N, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
