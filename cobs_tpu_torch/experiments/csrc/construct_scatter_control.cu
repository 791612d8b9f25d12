// Control design for the construction bit scatter: the one-atomic-per-
// update kernel into row-major words [R1, Wc] that the word-major kernel
// in cobs_tpu_torch/ops/csrc/construct_scatter.cu replaced, kept as it
// stood so that chip_smoke.py times the two in one call on one card.
// Not used by the port.
//
// Construction bit scatter words[rows[i], docs[i] / 32] |= 1 << docs[i] % 32,
// written by hand for Hopper (sm_90a).
//
// Replaces the jitted XLA scatter and pack of cobs_tpu/construct/device.py
// on one device: `_scatter_single` (:46) sets plane[rows, docs] = 1 in a
// u8 indicator plane [signature_size + 1, docs_pad], in chunks of
// UPDATE_CHUNK updates, and `_pack_plane` (:86) packs the plane into
// little-endian u32 words, bit d % 32 of word d / 32 being document d.
// Here the bits go straight into the packed words:
//
//   words  u32 [R1, Wc]  the batch's Bloom matrix, Wc = ceil(docs / 32);
//                        updated in place
//   rows   i32 [n]       Bloom row of each update
//   docs   i32 [n]       document of each update
//
// An update outside [0, R1) x [0, 32 * Wc) is dropped, as the JAX scatter's
// mode="drop" drops it. OR is idempotent and commutes, so duplicate k-mers
// need no dedup pass and the order in which the atomics land cannot change
// a bit: the words are bit-identical run to run and equal the plane's pack.
// No u8 plane exists, so the matrix takes 8x less device memory.
//
// What bounds it: the bytes of the updates it reads (8 per update) and the
// rate at which the L2 performs the atomic ORs. Within one document the
// updates hit Bloom rows at random, so nearly every update lands in its own
// 32-byte sector of a matrix far larger than the 50 MB L2: each costs a
// sector read and write-back in device memory besides the L2 operation.
// The least time counted by the caller is (8 n + 8 * distinct words) bytes
// over the memory rate.
//
// What the design does about it: a grid-stride loop reads the updates with
// coalesced 4-byte loads through the read-only path, and each update is
// one `atomicOr` whose result is unused, so it compiles to a reduction
// (RED.OR) that the thread issues without waiting for it: the only stall
// is the loads, and enough reductions stay in flight to keep the L2 busy.
// A simple kernel that is right comes first; sorting or binning updates by
// word to merge them before the atomics is left to a later redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    scatter_or(uint32_t* __restrict__ words, int64_t R1, int64_t Wc,
               const int32_t* __restrict__ rows,
               const int32_t* __restrict__ docs, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t r = __ldg(rows + i);
    const int32_t d = __ldg(docs + i);
    if (r < 0 || r >= R1 || d < 0 || (d >> 5) >= Wc) continue;
    atomicOr(words + static_cast<int64_t>(r) * Wc + (d >> 5),
             1u << (d & 31));
  }
}

}  // namespace

extern "C" {

// words int32 [R1, Wc], rows/docs int32 [n], all on the current device;
// grid blocks of kThreads threads on `stream`. Returns the CUDA error of
// the launch (0 on success). n == 0 launches nothing.
int cobs_construct_scatter_control(void* words, long long R1, long long Wc,
                           const void* rows, const void* docs, long long n,
                           int grid, void* stream) {
  if (n == 0) return 0;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  scatter_or<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(words), R1, Wc,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(docs),
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
