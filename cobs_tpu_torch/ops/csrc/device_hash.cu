// Query hashing on the device: window -> canonicalize -> XXH64 -> row id,
// written by hand for Hopper (sm_90a).
//
// Replaces cobs_tpu/ops/device_hash.py::rows_from_queries, which the JAX
// package runs as XLA code inside its scoring program (engine.py
// _hash_gather_count), with the same contract:
//
//   qdata    u8  [B, L]         queries padded to a common length L
//   qlens    i32 [B]            true length of each query
//   sig      i64 [P]            per-page signature size (Bloom rows)
//   off      i64 [P]            per-page global row offset
//   out      i32 [B, T, h, P]   T = L - k + 1;
//              out[b,t,j,p] = XXH64(term_t, seed=j) % sig[p] + off[p],
//              or zero_row when t >= qlens[b] - k + 1
//
// term_t is bytes [t, t+k) of query b; with canon=1 it is canonicalized
// first: the forward k-mer and its reverse complement are compared over
// the first k/2 positions only and the forward one wins ties (reference:
// cobs/util/query.cpp:143-199, the truncated compare of
// cobs_tpu/ops/device_hash.py:120-149). With canon=1 the bytes must be
// ACGT (validated on the host), so the complement is a XOR (A^21=T,
// C^4=G, G^4=C, T^21=A; bit 1 tells the pairs apart). canon=0 (text mode)
// hashes arbitrary bytes. XXH64 follows cobs_tpu_torch/core/xxh64.py for
// any k: 4-lane 32-byte stripes when k >= 32, then 8-, 4- and 1-byte
// tails (reference: cobs/util/misc.hpp:65-72).
//
// What bounds it: at the reference's default shape (B=64, L=1030, k=31,
// h=1, P=1) it reads 66 KB and writes 256 KB, far under a microsecond of
// HBM time, and does about 200 integer operations per term (64-bit
// multiplies and the per-page 64-bit modulo are emulated in 32-bit
// instructions): launch latency dominates. What the design does:
//   - one thread per (query, term), 128 terms per block, so a batch of
//     1,000-term queries is B*8 blocks;
//   - the block stages its 128 + k - 1 query bytes in shared memory once,
//     and each thread reads its window (and, for the reverse strand, the
//     same window backwards) from there; no [B, T, k] window tensor is
//     ever built, in registers or in memory;
//   - sig and off are runtime arrays (the JAX version bakes them into the
//     program as trace-time constants), so one build serves every index;
//   - a separate launch before the gather-and-count kernel: fused into it,
//     each of its ceil(W/128)*splits blocks per query would hash the same
//     terms again.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // terms per block

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ULL;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * kP2, 31) * kP1;
}

// Byte i of the (possibly reverse-complemented) term at `w`.
struct Term {
  const uint8_t* w;
  int k;
  bool rev;

  __device__ __forceinline__ uint32_t operator()(int i) const {
    if (!rev) return w[i];
    const uint32_t c = w[k - 1 - i];
    return c ^ ((c & 2u) ? 4u : 21u);
  }
};

__device__ __forceinline__ uint64_t lane64(const Term& t, int pos) {
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) v |= static_cast<uint64_t>(t(pos + i)) << (8 * i);
  return v;
}

__device__ __forceinline__ uint64_t lane32(const Term& t, int pos) {
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) v |= static_cast<uint64_t>(t(pos + i)) << (8 * i);
  return v;
}

__device__ uint64_t xxh64(const Term& t, int len, uint64_t seed) {
  int pos = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
             v4 = seed - kP1;
    for (; pos + 32 <= len; pos += 32) {
      v1 = xxh_round(v1, lane64(t, pos));
      v2 = xxh_round(v2, lane64(t, pos + 8));
      v3 = xxh_round(v3, lane64(t, pos + 16));
      v4 = xxh_round(v4, lane64(t, pos + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = (h ^ xxh_round(0, v1)) * kP1 + kP4;
    h = (h ^ xxh_round(0, v2)) * kP1 + kP4;
    h = (h ^ xxh_round(0, v3)) * kP1 + kP4;
    h = (h ^ xxh_round(0, v4)) * kP1 + kP4;
  } else {
    h = seed + kP5;
  }
  h += static_cast<uint64_t>(len);
  for (; pos + 8 <= len; pos += 8) {
    h ^= xxh_round(0, lane64(t, pos));
    h = rotl(h, 27) * kP1 + kP4;
  }
  if (pos + 4 <= len) {
    h ^= lane32(t, pos) * kP1;
    h = rotl(h, 23) * kP2 + kP3;
    pos += 4;
  }
  for (; pos < len; ++pos) {
    h ^= static_cast<uint64_t>(t(pos)) * kP5;
    h = rotl(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

__global__ void __launch_bounds__(kThreads)
device_hash_kernel(const uint8_t* __restrict__ qdata,
                   const int32_t* __restrict__ qlens, int L, int k, int h,
                   int canon, int P, const int64_t* __restrict__ sig,
                   const int64_t* __restrict__ off, int32_t zero_row,
                   int tiles, int32_t* __restrict__ out) {
  extern __shared__ uint8_t bytes_s[];  // [kThreads + k - 1]
  const int T = L - k + 1;
  const int64_t b = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * kThreads;
  const int nbytes = kThreads + k - 1 < L - t0 ? kThreads + k - 1 : L - t0;
  const uint8_t* q = qdata + b * L + t0;
  for (int i = threadIdx.x; i < nbytes; i += kThreads) bytes_s[i] = q[i];
  __syncthreads();

  const int t = t0 + static_cast<int>(threadIdx.x);
  if (t >= T) return;
  const int hp = h * P;
  int32_t* o = out + (b * T + t) * hp;
  if (t >= qlens[b] - k + 1) {  // past the query's last term
    for (int i = 0; i < hp; ++i) o[i] = zero_row;
    return;
  }
  const uint8_t* w = bytes_s + threadIdx.x;
  bool rev = false;
  if (canon) {
    for (int i = 0; i < k / 2; ++i) {
      const uint32_t f = w[i];
      const uint32_t c = w[k - 1 - i];
      const uint32_t r = c ^ ((c & 2u) ? 4u : 21u);
      if (f != r) {
        rev = f > r;
        break;
      }
    }
  }
  const Term term{w, k, rev};
  for (int j = 0; j < h; ++j) {
    const uint64_t x = xxh64(term, k, static_cast<uint64_t>(j));
    for (int p = 0; p < P; ++p)
      o[j * P + p] = static_cast<int32_t>(
          x % static_cast<uint64_t>(sig[p]) + static_cast<uint64_t>(off[p]));
  }
}

}  // namespace

// Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = launched).
extern "C" int cobs_device_hash(const void* qdata, const void* qlens, int B,
                                int L, int k, int h, int canon, int P,
                                const void* sig, const void* off,
                                int zero_row, void* out, void* stream) {
  const int T = L - k + 1;
  const int tiles = (T + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(tiles) * B;
  const size_t smem = static_cast<size_t>(kThreads + k - 1);
  device_hash_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qdata), static_cast<const int32_t*>(qlens),
      L, k, h, canon, P, static_cast<const int64_t*>(sig),
      static_cast<const int64_t*>(off), zero_row, tiles,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
