// Control design for the row gather (K2), timed beside the bulk-copy
// kernel in cobs_tpu_torch/ops/csrc/dma_gather.cu by
// cobs_tpu_torch/experiments/dma_gather_bench.py --control. Not used by
// the port.
//
// The register path of the earlier K2, tuned: one warp per row, eight
// rows per block, each lane with eight 16-byte loads in flight that do
// not allocate in L1 (ld.global.nc.L1::no_allocate) before its eight
// streaming stores (st.global.cs). Same contract as dma_gather.cu's bulk
// path: W % 4 == 0, 16-byte aligned matrix and out, out-of-range ids give
// zero rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 8;

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(32 * kWarps)
gather_rows_control(const uint4* __restrict__ matrix, int64_t R, int64_t Wv,
                    const int32_t* __restrict__ rows, int64_t N,
                    uint4* __restrict__ out) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (n >= N) return;
  const int lane = threadIdx.x & 31;
  const int32_t r = rows[n];
  uint4* dst = out + n * Wv;
  if (r < 0 || static_cast<int64_t>(r) >= R) {
    for (int64_t i = lane; i < Wv; i += 32)
      store_stream(dst + i, make_uint4(0, 0, 0, 0));
    return;
  }
  const uint4* src = matrix + static_cast<size_t>(r) * Wv;
  for (int64_t i0 = lane; i0 < Wv; i0 += 32 * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + 32 * u < Wv) v[u] = load_stream(src + i0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i0 + 32 * u < Wv) store_stream(dst + i0 + 32 * u, v[u]);
  }
}

}  // namespace

extern "C" int cobs_dma_gather_control(const void* matrix, long long R,
                                       long long W, const void* rows,
                                       long long N, void* out,
                                       void* stream) {
  const long long blocks = (N + kWarps - 1) / kWarps;
  gather_rows_control<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(matrix), R, W / 4,
      static_cast<const int32_t*>(rows), N, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
