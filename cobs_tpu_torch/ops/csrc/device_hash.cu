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
//   mag      u64 [P]            per-page Barrett factor (2^64 - 1) / sig
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
// tails (reference: cobs/misc.hpp:65-72).
//
// What bounds it: at the reference's default shape (B=64, L=1030, k=31,
// h=1, P=1) it reads 66 KB and writes 256 KB, far under a microsecond of
// HBM time, and 65,536 terms are only ~16 warps per SM: the time is the
// latency of one thread's dependent chain, from the staging load to the
// store. What the design does about it (the control, the one-byte-at-a-
// time kernel it replaced, is experiments/csrc/device_hash_control.cu):
//   - one thread per (query, term), 128 terms per block; the block stages
//     its 128 + k - 1 query bytes (and, for up to kMaxStagedPages pages,
//     the page tables) in shared memory once, with the query length read
//     before the barrier so the two loads overlap;
//   - SWAR: the term is read as 32-bit words, each two aligned shared
//     loads and a funnel shift. The reverse complement of 4 bytes is one
//     __byte_perm (byte reversal) and one XOR with a mask built from
//     bit 1 of each byte. The canonical choice compares the first k/2
//     bytes as byte-swapped (big-endian), masked 32-bit words, which is
//     the lexicographic order: no per-byte loop, no per-byte branch. The
//     chosen strand is then read as words through one address and one
//     conditional transform;
//   - the XXH64 lanes are seed-independent: round(0, lane), lane32 * P1 and
//     byte * P5 are computed once and the G seeds of a group (G = h up to
//     4) run their accumulator chains side by side;
//   - the remainder by the per-page signature size is a Barrett reduction
//     with the host's factor m = floor((2^64 - 1) / sig): q = umulhi(x, m)
//     is floor(x / sig) or one less, so r = x - q * sig needs at most one
//     correction, exact for every 64-bit x and every sig >= 1 (sig = 1
//     included). It replaces the software 64-bit division routine;
//   - k = 31 (the DNA default) is a compile-time instance, so every word
//     load, compare and XXH64 step unrolls; other k take the same code
//     with a runtime k;
//   - the block's output tile is staged in shared memory and written out
//     in one coalesced pass when h * P > 1 (a term's h * P ids are
//     contiguous, so a direct store would stride by h * P words).
//   A separate launch before the gather-and-count kernel: fused into it,
//   each of its CTAs per query would hash the same terms again.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // terms per block
constexpr int kPad = 4;                 // staged bytes before the first term
constexpr int kMaxStagedPages = 512;    // page tables staged in shared memory
constexpr int kMaxStagedOut = 64;       // h * P staged for a coalesced store
constexpr size_t kSmemLimit = 48 * 1024;

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

// Complement of 4 ACGT bytes at once: byte ^ (bit 1 set ? 0x04 : 0x15).
__device__ __forceinline__ uint32_t complement4(uint32_t x) {
  return x ^ 0x15151515u ^ (((x >> 1) & 0x01010101u) * 0x11u);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// 32-bit little-endian words of a byte sequence in shared memory that
// starts at byte `start` and runs forward (step 1) or backward (step -1)
// by whole words: word j holds bytes [start + 4 step j, +4).
struct Words {
  const uint32_t* s;
  int wi;  // shared word of byte `start`
  int sh;  // its bit offset within that word
  int step;

  __device__ __forceinline__ Words(const uint32_t* s_, int start, int st)
      : s(s_), wi(start >> 2), sh((start & 3) * 8), step(st) {}

  __device__ __forceinline__ uint32_t operator[](int j) const {
    const int w = wi + step * j;
    return __funnelshift_r(s[w], s[w + 1], sh);
  }
};

// The hashed key: word j (bytes [4j, 4j + 4), little-endian) of the
// forward term, or of its reverse complement when `rev`. Reverse word j
// is the complement of the byte-reversed forward word at k - 4 - 4j.
struct Key {
  Words w;
  bool rev;

  __device__ __forceinline__ Key(const uint32_t* s, int base, int k,
                                 bool rev_)
      : w(s, rev_ ? base + k - 4 : base, rev_ ? -1 : 1), rev(rev_) {}

  __device__ __forceinline__ uint32_t word(int j) const {
    const uint32_t x = w[j];
    return rev ? complement4(bswap32(x)) : x;
  }
  __device__ __forceinline__ uint64_t lane64(int pos) const {  // pos % 4 == 0
    return static_cast<uint64_t>(word(pos >> 2)) |
           static_cast<uint64_t>(word((pos >> 2) + 1)) << 32;
  }
  __device__ __forceinline__ uint32_t byte(int pos) const {
    return (word(pos >> 2) >> (8 * (pos & 3))) & 0xFFu;
  }
};

// True when the reverse complement is smaller over the first k/2 bytes.
// Big-endian words compare as byte strings; the forward word j is
// bswap(F(4j)) and the reverse one is complement(F(k - 4 - 4j)), F(p)
// being the little-endian forward word at byte p.
__device__ __forceinline__ bool reverse_is_smaller(const uint32_t* s,
                                                   int base, int k) {
  const int half = k / 2;
  if (half == 0) return false;
  const Words fwd(s, base, 1), bwd(s, base + k - 4, -1);
  const int nw = (half + 3) / 4;
  const int rem = half - 4 * (nw - 1);  // bytes of the last word, 1..4
  const uint32_t last = rem == 4 ? ~0u : ~(~0u >> (8 * rem));
  bool rev = false, done = false;
#pragma unroll
  for (int j = 0; j < nw; ++j) {
    const uint32_t m = j == nw - 1 ? last : ~0u;
    const uint32_t f = bswap32(fwd[j]) & m;
    const uint32_t r = complement4(bwd[j]) & m;
    if (!done && f != r) {
      rev = f > r;
      done = true;
    }
  }
  return rev;
}

// XXH64 of the key for seeds seed0 .. seed0 + G - 1. The lane terms
// round(0, lane), lane32 * P1 and byte * P5 do not depend on the seed.
template <int G>
__device__ __forceinline__ void xxh64(const Key& key, int len,
                                      uint64_t seed0, uint64_t (&h)[G]) {
  int pos = 0;
  if (len >= 32) {
    uint64_t v1[G], v2[G], v3[G], v4[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint64_t seed = seed0 + g;
      v1[g] = seed + kP1 + kP2;
      v2[g] = seed + kP2;
      v3[g] = seed;
      v4[g] = seed - kP1;
    }
    for (; pos + 32 <= len; pos += 32) {
      const uint64_t l1 = key.lane64(pos) * kP2, l2 = key.lane64(pos + 8) * kP2,
                     l3 = key.lane64(pos + 16) * kP2,
                     l4 = key.lane64(pos + 24) * kP2;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        v1[g] = rotl(v1[g] + l1, 31) * kP1;
        v2[g] = rotl(v2[g] + l2, 31) * kP1;
        v3[g] = rotl(v3[g] + l3, 31) * kP1;
        v4[g] = rotl(v4[g] + l4, 31) * kP1;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint64_t x = rotl(v1[g], 1) + rotl(v2[g], 7) + rotl(v3[g], 12) +
                   rotl(v4[g], 18);
      x = (x ^ xxh_round(0, v1[g])) * kP1 + kP4;
      x = (x ^ xxh_round(0, v2[g])) * kP1 + kP4;
      x = (x ^ xxh_round(0, v3[g])) * kP1 + kP4;
      x = (x ^ xxh_round(0, v4[g])) * kP1 + kP4;
      h[g] = x;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) h[g] = seed0 + g + kP5;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) h[g] += static_cast<uint64_t>(len);
  for (; pos + 8 <= len; pos += 8) {
    const uint64_t r = xxh_round(0, key.lane64(pos));
#pragma unroll
    for (int g = 0; g < G; ++g) h[g] = rotl(h[g] ^ r, 27) * kP1 + kP4;
  }
  if (pos + 4 <= len) {
    const uint64_t r = static_cast<uint64_t>(key.word(pos >> 2)) * kP1;
#pragma unroll
    for (int g = 0; g < G; ++g) h[g] = rotl(h[g] ^ r, 23) * kP2 + kP3;
    pos += 4;
  }
  for (; pos < len; ++pos) {
    const uint64_t r = static_cast<uint64_t>(key.byte(pos)) * kP5;
#pragma unroll
    for (int g = 0; g < G; ++g) h[g] = rotl(h[g] ^ r, 11) * kP1;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint64_t x = h[g];
    x ^= x >> 33;
    x *= kP2;
    x ^= x >> 29;
    x *= kP3;
    x ^= x >> 32;
    h[g] = x;
  }
}

// x % s for the Barrett factor m = floor((2^64 - 1) / s): q = umulhi(x, m)
// is floor(x / s) or one less, so r < 2 s and one correction is exact.
__device__ __forceinline__ uint64_t mod_barrett(uint64_t x, uint64_t s,
                                                uint64_t m) {
  const uint64_t r = x - __umul64hi(x, m) * s;
  return r >= s ? r - s : r;
}

struct Smem {
  int pages;  // page tables staged (0 = read from global memory)
  int out;    // h * P ids staged per term (0 = direct stores)
  int bytes;  // staged query bytes, whole words
};

// Shared-memory plan of a launch; the sizes below are in bytes.
__host__ __device__ inline Smem smem_plan(int k, int h, int P) {
  Smem p;
  p.bytes = (kPad + kThreads + k - 1 + 8 + 3) & ~3;
  p.pages = P <= kMaxStagedPages ? P : 0;
  p.out = h * P > 1 && h * P <= kMaxStagedOut ? h * P : 0;
  return p;
}

__host__ __device__ inline size_t smem_bytes(const Smem& p) {
  return static_cast<size_t>(p.pages) * 24 +
         static_cast<size_t>(p.out) * kThreads * 4 + p.bytes;
}

template <int KC, int G>
__global__ void __launch_bounds__(kThreads)
device_hash_kernel(const uint8_t* __restrict__ qdata,
                   const int32_t* __restrict__ qlens, int L, int k_arg,
                   int h, int canon, int P, const int64_t* __restrict__ sig,
                   const int64_t* __restrict__ off,
                   const uint64_t* __restrict__ mag, int32_t zero_row,
                   int tiles, Smem plan, int32_t* __restrict__ out) {
  extern __shared__ uint64_t smem[];
  const int k = KC ? KC : k_arg;
  // [sig, off, mag] x plan.pages u64, then the output tile, then bytes
  uint64_t* sig_s = smem;
  uint64_t* off_s = sig_s + plan.pages;
  uint64_t* mag_s = off_s + plan.pages;
  int32_t* out_s = reinterpret_cast<int32_t*>(mag_s + plan.pages);
  uint8_t* bytes_s =
      reinterpret_cast<uint8_t*>(out_s + plan.out * kThreads);

  const int T = L - k + 1;
  const int64_t b = blockIdx.x / tiles;
  const int t0 = static_cast<int>(blockIdx.x % tiles) * kThreads;
  const int avail = min(kThreads + k - 1, L - t0);
  const uint8_t* q = qdata + b * L + t0;
  const int qlen = qlens[b];
  for (int i = threadIdx.x; i < plan.bytes; i += kThreads) {
    const int src = i - kPad;
    bytes_s[i] = src >= 0 && src < avail ? q[src] : 0;
  }
  for (int i = threadIdx.x; i < plan.pages; i += kThreads) {
    sig_s[i] = static_cast<uint64_t>(sig[i]);
    off_s[i] = static_cast<uint64_t>(off[i]);
    mag_s[i] = mag[i];
  }
  __syncthreads();
  const uint64_t* sig_p =
      plan.pages ? sig_s : reinterpret_cast<const uint64_t*>(sig);
  const uint64_t* off_p =
      plan.pages ? off_s : reinterpret_cast<const uint64_t*>(off);
  const uint64_t* mag_p = plan.pages ? mag_s : mag;

  const int t = t0 + static_cast<int>(threadIdx.x);
  const int hp = h * P;
  const int tile_terms = min(kThreads, T - t0);
  // this term's ids: the staged tile or straight into `out`
  int32_t* o = plan.out ? out_s + threadIdx.x * hp : out + (b * T + t) * hp;
  if (t < T) {
    if (t >= qlen - k + 1) {  // past the query's last term
      for (int i = 0; i < hp; ++i) o[i] = zero_row;
    } else {
      const uint32_t* s = reinterpret_cast<const uint32_t*>(bytes_s);
      const int base = kPad + static_cast<int>(threadIdx.x);
      const bool rev = canon && reverse_is_smaller(s, base, k);
      const Key key(s, base, k, rev);
      for (int j0 = 0; j0 < h; j0 += G) {
        uint64_t x[G];
        xxh64<G>(key, k, static_cast<uint64_t>(j0), x);
        for (int p = 0; p < P; ++p) {
          const uint64_t sp = sig_p[p], op = off_p[p], mp = mag_p[p];
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (j0 + g < h)
              o[(j0 + g) * P + p] =
                  static_cast<int32_t>(mod_barrett(x[g], sp, mp) + op);
        }
      }
    }
  }
  if (plan.out) {  // one coalesced pass over the tile's ids
    __syncthreads();
    int32_t* dst = out + (b * T + t0) * hp;
    for (int i = threadIdx.x; i < tile_terms * hp; i += kThreads)
      dst[i] = out_s[i];
  }
}

template <int KC, int G>
cudaError_t launch(const void* qdata, const void* qlens, int B, int L, int k,
                   int h, int canon, int P, const void* sig, const void* off,
                   const void* mag, int zero_row, void* out,
                   cudaStream_t stream) {
  const int T = L - k + 1;
  const int tiles = (T + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(tiles) * B;
  Smem plan = smem_plan(k, h, P);
  if (smem_bytes(plan) > kSmemLimit) plan.out = 0;
  if (smem_bytes(plan) > kSmemLimit) plan.pages = 0;
  if (smem_bytes(plan) > kSmemLimit) return cudaErrorInvalidValue;
  device_hash_kernel<KC, G>
      <<<static_cast<unsigned>(blocks), kThreads, smem_bytes(plan), stream>>>(
          static_cast<const uint8_t*>(qdata),
          static_cast<const int32_t*>(qlens), L, k, h, canon, P,
          static_cast<const int64_t*>(sig), static_cast<const int64_t*>(off),
          static_cast<const uint64_t*>(mag), zero_row, tiles, plan,
          static_cast<int32_t*>(out));
  return cudaGetLastError();
}

template <int KC>
cudaError_t launch_g(const void* qdata, const void* qlens, int B, int L,
                     int k, int h, int canon, int P, const void* sig,
                     const void* off, const void* mag, int zero_row,
                     void* out, cudaStream_t stream) {
  switch (h < 4 ? h : 4) {
    case 1:
      return launch<KC, 1>(qdata, qlens, B, L, k, h, canon, P, sig, off, mag,
                           zero_row, out, stream);
    case 2:
      return launch<KC, 2>(qdata, qlens, B, L, k, h, canon, P, sig, off, mag,
                           zero_row, out, stream);
    case 3:
      return launch<KC, 3>(qdata, qlens, B, L, k, h, canon, P, sig, off, mag,
                           zero_row, out, stream);
    default:
      return launch<KC, 4>(qdata, qlens, B, L, k, h, canon, P, sig, off, mag,
                           zero_row, out, stream);
  }
}

}  // namespace

// Launches on `stream` without synchronizing and returns
// cudaGetLastError() (0 = launched). sig, off and mag are [P] on the
// device; mag[p] = (2^64 - 1) / sig[p] (device_hash.py: barrett_factors).
extern "C" int cobs_device_hash(const void* qdata, const void* qlens, int B,
                                int L, int k, int h, int canon, int P,
                                const void* sig, const void* off,
                                const void* mag, int zero_row, void* out,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      k == 31 ? launch_g<31>(qdata, qlens, B, L, k, h, canon, P, sig, off,
                             mag, zero_row, out, st)
              : launch_g<0>(qdata, qlens, B, L, k, h, canon, P, sig, off, mag,
                            zero_row, out, st);
  return static_cast<int>(rc);
}
