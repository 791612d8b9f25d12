// Host runtime of cobs_tpu_torch: the construction and hashing hot path
// (canonicalization -> XXH64 -> Bloom row ids, the host bit scatter, the
// random-document generator), and the streamed (host-mmap) backend's
// threaded scattered row gather, host gather/AND/expand-add scorer and
// io_uring row gather of cold-cache serving.
//
// A copy of those parts of cobs_tpu/native/native.cpp (the port never
// imports cobs_tpu, whose package imports jax), so both packages hash,
// scatter and score bit for bit alike. Exposed as a flat C ABI bound with
// ctypes, which releases the GIL for the length of every call.
//
// Build: cobs_tpu_torch/native/__init__.py compiles this with g++ at
// first use into cobs_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512BW__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;  // little-endian hosts only (x86-64 / aarch64)
}

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
    return rotl(acc + lane * P2, 31) * P1;
}

inline uint64_t merge_round(uint64_t h, uint64_t acc) {
    h ^= xxh_round(0, acc);
    return h * P1 + P4;
}

uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2;
        uint64_t v2 = seed + P2;
        uint64_t v3 = seed;
        uint64_t v4 = seed - P1;
        do {
            v1 = xxh_round(v1, read64(p)); p += 8;
            v2 = xxh_round(v2, read64(p)); p += 8;
            v3 = xxh_round(v3, read64(p)); p += 8;
            v4 = xxh_round(v4, read64(p)); p += 8;
        } while (p + 32 <= end);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge_round(h, v1);
        h = merge_round(h, v2);
        h = merge_round(h, v3);
        h = merge_round(h, v4);
    } else {
        h = seed + P5;
    }
    h += static_cast<uint64_t>(len);
    while (p + 8 <= end) {
        h ^= xxh_round(0, read64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= static_cast<uint64_t>(read32(p)) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= static_cast<uint64_t>(*p) * P5;
        h = rotl(h, 11) * P1;
        ++p;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

struct Maps {
    uint8_t fwd[256];
    uint8_t rev[256];
    Maps() {
        std::memset(fwd, 0, sizeof(fwd));
        std::memset(rev, 0, sizeof(rev));
        fwd['A'] = 'A'; fwd['C'] = 'C'; fwd['G'] = 'G'; fwd['T'] = 'T';
        rev['A'] = 'T'; rev['C'] = 'G'; rev['G'] = 'C'; rev['T'] = 'A';
    }
};
const Maps kMaps;

// Canonicalize one k-mer into `out` (k bytes). Mirrors
// core/canonical.py: compare forward vs reverse complement over the
// first floor(k/2) positions only; forward wins ties. Returns 1 iff all
// letters were ACGT.
inline int canonicalize(const uint8_t* kmer, int64_t k, uint8_t* out) {
    int good = 1;
    int use_reverse = 0;
    const int64_t half = k / 2;
    for (int64_t i = 0; i < half; ++i) {
        uint8_t f = kMaps.fwd[kmer[i]];
        uint8_t r = kMaps.rev[kmer[k - 1 - i]];
        if (f != r) {
            use_reverse = f > r;
            break;
        }
    }
    if (use_reverse) {
        for (int64_t i = 0; i < k; ++i) {
            uint8_t r = kMaps.rev[kmer[k - 1 - i]];
            out[i] = r;
            good &= (kMaps.fwd[kmer[k - 1 - i]] != 0);
        }
    } else {
        for (int64_t i = 0; i < k; ++i) {
            uint8_t f = kMaps.fwd[kmer[i]];
            out[i] = f;
            good &= (f != 0);
        }
    }
    return good;
}

// Vectorized canonicalization for k <= 64 (AVX-512BW + VBMI): the
// scalar table-lookup loops above cost ~4x the XXH64 hash per term
// (measured 56 vs 14 ns at k=31), so the whole operation — validate,
// reverse (vpermb), complement (low-nibble pshufb: A/C/G/T have
// distinct low nibbles), truncated-half compare — runs as ~15 vector
// ops with bit-exact scalar semantics (invalid letters map to 0 and
// participate in the comparison as 0, matching kMaps.fwd/rev).
#if defined(__AVX512BW__) && defined(__AVX512VBMI__)
#define COBS_CANON_SIMD 1
struct CanonCtx {
    __m512i rev_idx;
    __m512i comp_tab;
    __mmask64 kmask;
    __mmask64 halfmask;
    int64_t k;
    explicit CanonCtx(int64_t k_) : k(k_) {
        alignas(64) uint8_t idx[64] = {0};
        for (int64_t i = 0; i < k_ && i < 64; ++i)
            idx[i] = static_cast<uint8_t>(k_ - 1 - i);
        rev_idx = _mm512_load_si512(idx);
        // complement by low nibble: 'A'&15=1 -> 'T', 'C'&15=3 -> 'G',
        // 'G'&15=7 -> 'C', 'T'&15=4 -> 'A'; other slots are zeroed by
        // the validity mask regardless
        alignas(16) static const uint8_t tab16[16] = {
            0, 'T', 0, 'G', 'A', 0, 0, 'C', 0, 0, 0, 0, 0, 0, 0, 0};
        comp_tab = _mm512_broadcast_i32x4(
            _mm_load_si128(reinterpret_cast<const __m128i*>(tab16)));
        kmask = k_ >= 64 ? ~0ULL : ((1ULL << k_) - 1);
        halfmask = (k_ / 2) ? ((1ULL << (k_ / 2)) - 1) : 0;
    }
};

inline __mmask64 valid_acgt(__m512i v) {
    return _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('A')) |
           _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('C')) |
           _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('G')) |
           _mm512_cmpeq_epi8_mask(v, _mm512_set1_epi8('T'));
}

inline int canonicalize_simd(const CanonCtx& c, const uint8_t* kmer,
                             uint8_t* out) {
    __m512i v = _mm512_maskz_loadu_epi8(c.kmask, kmer);
    __mmask64 valid = valid_acgt(v) & c.kmask;
    __m512i f = _mm512_maskz_mov_epi8(valid, v);
    __m512i rv = _mm512_permutexvar_epi8(c.rev_idx, v);
    __mmask64 valid_r = valid_acgt(rv) & c.kmask;
    __m512i r = _mm512_maskz_mov_epi8(
        valid_r, _mm512_shuffle_epi8(
                     c.comp_tab,
                     _mm512_and_si512(rv, _mm512_set1_epi8(0x0F))));
    __mmask64 ne = _mm512_cmpneq_epi8_mask(f, r) & c.halfmask;
    int use_reverse = 0;
    if (ne) {
        int i = __builtin_ctzll(ne);
        use_reverse = kMaps.fwd[kmer[i]] > kMaps.rev[kmer[c.k - 1 - i]];
    }
    _mm512_mask_storeu_epi8(out, c.kmask, use_reverse ? r : f);
    return valid == c.kmask;
}
#else
#define COBS_CANON_SIMD 0
struct CanonCtx {
    explicit CanonCtx(int64_t) {}
};
#endif

// Canonicalize through the SIMD path when compiled in and k fits one
// vector; scalar otherwise. `ctx` must have been built for this k.
inline int canonicalize_ctx(const CanonCtx& ctx, const uint8_t* kmer,
                            int64_t k, uint8_t* out) {
#if COBS_CANON_SIMD
    if (k <= 64) return canonicalize_simd(ctx, kmer, out);
#else
    (void)ctx;
#endif
    return canonicalize(kmer, k, out);
}

}  // namespace

extern "C" {

// Batched XXH64 of n equal-length byte strings for one seed.
void cobs_xxh64_batch(const uint8_t* data, int64_t n, int64_t len,
                      uint64_t seed, uint64_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = xxh64(data + i * len, static_cast<size_t>(len), seed);
}

// The fused construction/query hot path over one sequence: slide a
// k-window, canonicalize (optional), hash num_hashes seeds, mod by
// sig_size. out_rows: [n_terms * num_hashes] u64 (term-major). Returns
// 0 if any term contained a non-ACGT letter, else 1. n_terms =
// seq_len - k + 1 (caller guarantees >= 1).
int32_t cobs_sequence_rows(const uint8_t* seq, int64_t seq_len, int64_t k,
                           int64_t num_hashes, uint64_t sig_size,
                           int32_t canonical, uint64_t* out_rows) {
    int all_good = 1;
    const int64_t n = seq_len - k + 1;
    if (!canonical) {
        for (int64_t t = 0; t < n; ++t)
            for (int64_t j = 0; j < num_hashes; ++j)
                out_rows[t * num_hashes + j] =
                    xxh64(seq + t, static_cast<size_t>(k),
                          static_cast<uint64_t>(j)) % sig_size;
        return all_good;
    }
    // Sliding windows are substrings, so every window's canonical form
    // is a contiguous slice of one of two precomputed buffers: the
    // forward-mapped sequence cs (identity on ACGT, 0 on invalid —
    // the same invalid-as-0 semantics as kMaps) and the
    // reverse-complement-mapped sequence rcc (window t's reverse
    // complement = rcc + (seq_len - t - k)). The per-window work drops
    // to the truncated-half compare + in-place hash: no per-window
    // canonicalize copy at all.
    std::vector<uint8_t> cs(static_cast<size_t>(seq_len));
    std::vector<uint8_t> rcc(static_cast<size_t>(seq_len));
    for (int64_t i = 0; i < seq_len; ++i) {
        cs[static_cast<size_t>(i)] = kMaps.fwd[seq[i]];
        rcc[static_cast<size_t>(i)] = kMaps.rev[seq[seq_len - 1 - i]];
    }
    // sliding invalid-letter counter for the per-window `good` check
    int64_t zeros = 0;
    for (int64_t i = 0; i < k; ++i)
        zeros += (cs[static_cast<size_t>(i)] == 0);
    const int64_t half = k / 2;
#if COBS_CANON_SIMD
    const __mmask64 halfmask =
        half >= 64 ? ~0ULL : (half > 0 ? ((1ULL << half) - 1) : 0ULL);
#endif
    for (int64_t t = 0; t < n; ++t) {
        const uint8_t* f = cs.data() + t;
        const uint8_t* r = rcc.data() + (seq_len - t - k);
        int use_reverse = 0;
#if COBS_CANON_SIMD
        if (half <= 64) {
            __mmask64 ne = _mm512_cmpneq_epi8_mask(
                               _mm512_maskz_loadu_epi8(halfmask, f),
                               _mm512_maskz_loadu_epi8(halfmask, r)) &
                           halfmask;
            if (ne) {
                int i = __builtin_ctzll(ne);
                use_reverse = f[i] > r[i];
            }
        } else
#endif
        {
            for (int64_t i = 0; i < half; ++i) {
                if (f[i] != r[i]) {
                    use_reverse = f[i] > r[i];
                    break;
                }
            }
        }
        const uint8_t* term = use_reverse ? r : f;
        all_good &= (zeros == 0);
        for (int64_t j = 0; j < num_hashes; ++j)
            out_rows[t * num_hashes + j] =
                xxh64(term, static_cast<size_t>(k),
                      static_cast<uint64_t>(j)) % sig_size;
        if (t + 1 < n)
            zeros += (cs[static_cast<size_t>(t + k)] == 0) -
                     (cs[static_cast<size_t>(t)] == 0);
    }
    return all_good;
}

// Multithreaded variant over one large sequence: thread t handles the
// window range [lo, hi) directly on the shared sequence bytes (windows
// overlap, reads only). Used by the streaming ingest path, where a
// chunk is one contiguous sequence slice — no [n, k] window
// materialization needed at all.
int32_t cobs_sequence_rows_mt(const uint8_t* seq, int64_t seq_len,
                              int64_t k, int64_t num_hashes,
                              uint64_t sig_size, int32_t canonical,
                              uint64_t* out_rows, int32_t num_threads) {
    const int64_t n = seq_len - k + 1;
    if (num_threads < 2 || n < 1 << 16)
        return cobs_sequence_rows(seq, seq_len, k, num_hashes, sig_size,
                                  canonical, out_rows);
    std::vector<std::thread> pool;
    std::vector<int> goods(num_threads, 1);
    int64_t per = (n + num_threads - 1) / num_threads;
    for (int32_t t = 0; t < num_threads; ++t) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        if (lo >= hi) break;
        pool.emplace_back([=, &goods] {
            goods[t] = cobs_sequence_rows(
                seq + lo, (hi - lo) + k - 1, k, num_hashes, sig_size,
                canonical, out_rows + lo * num_hashes);
        });
    }
    int all_good = 1;
    for (auto& th : pool) th.join();
    for (int g : goods) all_good &= g;
    return all_good;
}

namespace {

int window_rows_range(const uint8_t* windows, int64_t lo, int64_t hi,
                      int64_t k, int64_t num_hashes, uint64_t sig_size,
                      int32_t canonical, uint64_t* out_rows) {
    int all_good = 1;
    std::vector<uint8_t> buf(canonical ? static_cast<size_t>(k) : 0);
    const CanonCtx ctx(k);
    for (int64_t t = lo; t < hi; ++t) {
        const uint8_t* term = windows + t * k;
        if (canonical) {
            all_good &= canonicalize_ctx(ctx, term, k, buf.data());
            term = buf.data();
        }
        for (int64_t j = 0; j < num_hashes; ++j)
            out_rows[t * num_hashes + j] =
                xxh64(term, static_cast<size_t>(k),
                      static_cast<uint64_t>(j)) % sig_size;
    }
    return all_good;
}

}  // namespace

// Same hot path over pre-extracted windows [n, k] (row-major) — the
// drop-in native replacement for canonicalize_batch + xxh64_multi_seed.
int32_t cobs_window_rows(const uint8_t* windows, int64_t n, int64_t k,
                         int64_t num_hashes, uint64_t sig_size,
                         int32_t canonical, uint64_t* out_rows) {
    return window_rows_range(windows, 0, n, k, num_hashes, sig_size,
                             canonical, out_rows);
}

// Multithreaded variant for very large window batches (single huge
// documents; the Python layer parallelizes across documents, this
// parallelizes within one).
int32_t cobs_window_rows_mt(const uint8_t* windows, int64_t n, int64_t k,
                            int64_t num_hashes, uint64_t sig_size,
                            int32_t canonical, uint64_t* out_rows,
                            int32_t num_threads) {
    if (num_threads < 2 || n < 1 << 16)
        return window_rows_range(windows, 0, n, k, num_hashes, sig_size,
                                 canonical, out_rows);
    std::vector<std::thread> pool;
    std::vector<int> goods(num_threads, 1);
    int64_t per = (n + num_threads - 1) / num_threads;
    for (int32_t t = 0; t < num_threads; ++t) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        if (lo >= hi) break;
        pool.emplace_back([=, &goods] {
            goods[t] = window_rows_range(windows, lo, hi, k, num_hashes,
                                         sig_size, canonical, out_rows);
        });
    }
    int all_good = 1;
    for (auto& th : pool) th.join();
    for (int g : goods) all_good &= g;
    return all_good;
}

// Fused synthetic-document hot path for classic_construct_random
// (reference analog: cobs/construction/classic_index random driver,
// src/cobs.cpp:243-291): generate n random k-mers, canonicalize, hash
// num_hashes seeds, mod by sig_size — no Python-side k-mer decode or
// window materialization. PRNG: splitmix64 over (seed + term index),
// 2 bits per letter, so one 64-bit draw covers k <= 32 and the stream
// is reproducible from the seed alone (documented deviation from the
// reference's std::mt19937: statistically, not bitwise, equivalent).
int32_t cobs_random_rows(uint64_t seed, int64_t n, int64_t k,
                         int64_t num_hashes, uint64_t sig_size,
                         uint64_t* out_rows) {
    if (k < 1 || k > 32) return 0;  // one draw per term; plenty for DNA
    static const uint8_t kLetters[4] = {'A', 'C', 'G', 'T'};
    std::vector<uint8_t> kmer(static_cast<size_t>(k));
    std::vector<uint8_t> canon(static_cast<size_t>(k));
    const CanonCtx ctx(k);
    for (int64_t t = 0; t < n; ++t) {
        // splitmix64 finalizer (public domain algorithm)
        uint64_t z = seed + static_cast<uint64_t>(t) *
                     0x9E3779B97F4A7C15ULL + 0x9E3779B97F4A7C15ULL;
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
        z ^= z >> 31;
        for (int64_t i = 0; i < k; ++i)
            kmer[static_cast<size_t>(i)] = kLetters[(z >> (2 * i)) & 3];
        canonicalize_ctx(ctx, kmer.data(), k, canon.data());
        for (int64_t j = 0; j < num_hashes; ++j)
            out_rows[t * num_hashes + j] =
                xxh64(canon.data(), static_cast<size_t>(k),
                      static_cast<uint64_t>(j)) % sig_size;
    }
    return 1;
}

// Raw (un-modded) hashes for the query path (hashes are modded per page
// for compact indices): out [n * num_hashes] u64, term-major.
int32_t cobs_window_hashes(const uint8_t* windows, int64_t n, int64_t k,
                           int64_t num_hashes, int32_t canonical,
                           uint64_t* out) {
    int all_good = 1;
    std::vector<uint8_t> buf(canonical ? static_cast<size_t>(k) : 0);
    const CanonCtx ctx(k);
    for (int64_t t = 0; t < n; ++t) {
        const uint8_t* term = windows + t * k;
        if (canonical) {
            all_good &= canonicalize_ctx(ctx, term, k, buf.data());
            term = buf.data();
        }
        for (int64_t j = 0; j < num_hashes; ++j)
            out[t * num_hashes + j] =
                xxh64(term, static_cast<size_t>(k),
                      static_cast<uint64_t>(j));
    }
    return all_good;
}

// OR document doc's bit into the byte matrix rows (LSB-first bit
// layout, reference: cobs/construction/classic_index.cpp:40-43).
void cobs_set_bits(uint8_t* data, int64_t row_size, const uint64_t* rows,
                   int64_t n, int64_t doc) {
    const uint8_t bit = static_cast<uint8_t>(1u << (doc & 7));
    uint8_t* col = data + (doc >> 3);
    for (int64_t i = 0; i < n; ++i)
        col[rows[i] * row_size] |= bit;
}

}  // extern "C"

extern "C" {

// Parallel scattered row gather from a memory-mapped index payload —
// the analog of the reference's AIO batch reads
// (reference: cobs/query/compact_index/aio_search_file.cpp:23-97).
// rows: n global row indices into a [num_rows, row_bytes] payload at
// `base`; each row is copied to out + i*out_stride. Page faults on the
// mmap'd file happen concurrently across threads.
void cobs_gather_rows(const uint8_t* base, int64_t row_bytes,
                      const int64_t* rows, int64_t n, uint8_t* out,
                      int64_t out_stride, int32_t num_threads) {
    if (num_threads < 1) num_threads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i)
            std::memcpy(out + i * out_stride,
                        base + rows[i] * row_bytes,
                        static_cast<size_t>(row_bytes));
    };
    if (num_threads == 1 || n < 1024) {
        work(0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t per = (n + num_threads - 1) / num_threads;
    for (int32_t t = 0; t < num_threads; ++t) {
        int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
        if (lo >= hi) break;
        pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
}

// Host-side batched scoring for the streamed (mmap) backend — the
// equivalent of the reference's expansion-add hot loop
// (reference: cobs/query/classic_search.cpp:279-401; SSE2 expand
// tables there, set-bit iteration here). The host scoring mode of the
// streamed backend (settings.streamed_host_score = "host").
//
// rows: [B, T, h, P] global row ids into the payload at `base`
// ([total_rows, row_bytes] contiguous, pages back to back). Row id ==
// zero_id marks a padding term (virtual all-zero row: its AND
// contributes nothing, so the term is skipped). out: i32
// [B, P * 8 * row_bytes] zero-initialized by this kernel; page-major,
// in-page document id = byte * 8 + bit (LSB-first bit layout).
// One term's AND-mask accumulated into byte-lane counters.  acc holds
// one uint8 slot per document bit (64 slots per row word, LSB-first:
// slot = 8*byte + bit, matching the index bit layout).  The reference
// expands bits through SSE2 half-byte lookup tables
// (reference: cobs/query/classic_search.cpp:150-298); on modern x86 a
// 64-bit mask expands to 64 byte lanes in one instruction
// (AVX-512BW vpmovm2b), so a term costs 2 vector ops per 64 documents
// instead of a data-dependent ctz chain per set bit.
static inline void score_term_u8(uint8_t* acc, const uint8_t* const* rp,
                                 int64_t h, int64_t row_bytes) {
    int64_t words = row_bytes / 8;
    int64_t i = 0;
    for (; i < words; ++i) {
        uint64_t w;
        std::memcpy(&w, rp[0] + i * 8, 8);
        for (int64_t j = 1; j < h; ++j) {
            uint64_t w2;
            std::memcpy(&w2, rp[j] + i * 8, 8);
            w &= w2;
        }
        uint8_t* a = acc + i * 64;
#if defined(__AVX512BW__)
        __m512i v = _mm512_loadu_si512(a);
        v = _mm512_sub_epi8(v, _mm512_movm_epi8(w));
        _mm512_storeu_si512(a, v);
#elif defined(__AVX2__)
        // 32 bits per lane group: broadcast the word, pick each lane's
        // source byte with pshufb, test its bit -> 0/FF, subtract.
        const __m256i lane_byte = _mm256_setr_epi8(
            0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
            2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3);
        const __m256i bit_sel = _mm256_setr_epi8(
            1, 2, 4, 8, 16, 32, 64, -128, 1, 2, 4, 8, 16, 32, 64, -128,
            1, 2, 4, 8, 16, 32, 64, -128, 1, 2, 4, 8, 16, 32, 64, -128);
        for (int half = 0; half < 2; ++half) {
            uint32_t w32 = static_cast<uint32_t>(w >> (32 * half));
            __m256i v = _mm256_shuffle_epi8(
                _mm256_set1_epi32(static_cast<int32_t>(w32)), lane_byte);
            v = _mm256_cmpeq_epi8(_mm256_and_si256(v, bit_sel), bit_sel);
            __m256i a32 = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(a + 32 * half));
            _mm256_storeu_si256(reinterpret_cast<__m256i*>(a + 32 * half),
                                _mm256_sub_epi8(a32, v));
        }
#else
        uint8_t* s8 = a;
        while (w) {
            s8[__builtin_ctzll(w)]++;
            w &= w - 1;
        }
#endif
    }
    // tail bytes (row_bytes % 8): zero-extend into one word; mask bits
    // past the row end are zero so the extra acc slots never increment
    if (int64_t rem = row_bytes - words * 8) {
        uint64_t w = 0;
        std::memcpy(&w, rp[0] + words * 8, rem);
        for (int64_t j = 1; j < h; ++j) {
            uint64_t w2 = 0;
            std::memcpy(&w2, rp[j] + words * 8, rem);
            w &= w2;
        }
        uint8_t* s8 = acc + words * 64;
        while (w) {
            s8[__builtin_ctzll(w)]++;
            w &= w - 1;
        }
    }
}

void cobs_score_batch(const uint8_t* base, int64_t row_bytes,
                      const int64_t* rows, int64_t B, int64_t T,
                      int64_t h, int64_t P, int64_t zero_id,
                      int32_t* out, int32_t num_threads) {
    const int64_t page_slots = 8 * row_bytes;
    // byte-lane counters cap at 255 term hits, so terms stream in
    // <=255-term chunks widened into the int32 scores between chunks
    // (the reference's u8/u16/u32 score-width tiering, applied to the
    // accumulator instead of the output)
    const int64_t CHUNK = 255;
    const int64_t PF = 8;  // term prefetch distance (rows ahead)
    const int64_t acc_len = ((row_bytes + 7) / 8) * 64;  // 64B/word slack
    auto work = [&](int64_t b_lo, int64_t b_hi) {
        std::vector<const uint8_t*> rp(static_cast<size_t>(h));
        std::vector<uint8_t> acc(static_cast<size_t>(acc_len));
        for (int64_t b = b_lo; b < b_hi; ++b) {
            int32_t* out_b = out + b * P * page_slots;
            std::memset(out_b, 0,
                        static_cast<size_t>(P * page_slots) * 4);
            const int64_t* rb = rows + b * T * h * P;
            for (int64_t p = 0; p < P; ++p) {
                int32_t* sc = out_b + p * page_slots;
                for (int64_t t0 = 0; t0 < T; t0 += CHUNK) {
                    int64_t t1 = t0 + CHUNK < T ? t0 + CHUNK : T;
                    std::memset(acc.data(), 0,
                                static_cast<size_t>(acc_len));
                    for (int64_t t = t0; t < t1; ++t) {
                        // prefetch term t+PF's rows: the payload is a
                        // file-backed mmap in streamed serving (4 KiB
                        // pages), where demand-loading a scattered row
                        // stalls on TLB walks — measured 2.8x over the
                        // same kernel on hugepage-backed memory
                        if (t + PF < t1) {
                            for (int64_t j = 0; j < h; ++j) {
                                int64_t r = rb[((t + PF) * h + j) * P
                                               + p];
                                if (r == zero_id) continue;
                                const uint8_t* q = base + r * row_bytes;
                                for (int64_t c = 0; c < row_bytes;
                                     c += 64)
                                    __builtin_prefetch(q + c, 0, 3);
                            }
                        }
                        bool pad = false;
                        for (int64_t j = 0; j < h; ++j) {
                            int64_t r = rb[(t * h + j) * P + p];
                            if (r == zero_id) { pad = true; break; }
                            rp[static_cast<size_t>(j)] =
                                base + r * row_bytes;
                        }
                        if (pad) continue;
                        score_term_u8(acc.data(), rp.data(), h,
                                      row_bytes);
                    }
                    const uint8_t* a = acc.data();
                    for (int64_t i = 0; i < page_slots; ++i)
                        sc[i] += a[i];
                }
            }
        }
    };
    if (num_threads < 1) num_threads = 1;
    if (num_threads == 1 || B == 1) {
        work(0, B);
        return;
    }
    std::vector<std::thread> pool;
    int64_t per = (B + num_threads - 1) / num_threads;
    for (int32_t t = 0; t < num_threads; ++t) {
        int64_t lo = t * per, hi = lo + per < B ? lo + per : B;
        if (lo >= hi) break;
        pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched asynchronous file reads via io_uring: the equivalent of the
// reference's O_DIRECT AIO batch (reference:
// cobs/query/compact_index/aio_search_file.cpp:23-97, util/aio.cpp:25-39).
// Cold-cache streamed serving gathers the touched Bloom rows with a deep
// async queue instead of one synchronous page fault at a time per thread.
// Raw syscalls (no liburing dependency); callers MUST handle rc == -1
// (kernel/seccomp without io_uring) by falling back to the threaded
// mmap gather above.

#if defined(__linux__) && __has_include(<linux/io_uring.h>)

#include <errno.h>
#include <linux/io_uring.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <atomic>

namespace {

struct Uring {
    int ring_fd = -1;
    io_uring_params p{};
    unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
    unsigned* sq_array = nullptr;
    io_uring_sqe* sqes = nullptr;
    unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
    io_uring_cqe* cqes = nullptr;
    void *sq_ptr = MAP_FAILED, *cq_ptr = MAP_FAILED,
         *sqe_ptr = MAP_FAILED;
    size_t sq_len = 0, cq_len = 0, sqe_len = 0;
    bool ok = false;

    explicit Uring(unsigned depth) {
        ring_fd = static_cast<int>(
            syscall(__NR_io_uring_setup, depth, &p));
        if (ring_fd < 0) return;
        sq_len = p.sq_off.array + p.sq_entries * sizeof(unsigned);
        cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
        if (p.features & IORING_FEAT_SINGLE_MMAP) {
            size_t len = sq_len > cq_len ? sq_len : cq_len;
            sq_len = cq_len = len;
        }
        sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_POPULATE, ring_fd,
                      IORING_OFF_SQ_RING);
        if (sq_ptr == MAP_FAILED) return;
        cq_ptr = (p.features & IORING_FEAT_SINGLE_MMAP)
                     ? sq_ptr
                     : mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                            MAP_SHARED | MAP_POPULATE, ring_fd,
                            IORING_OFF_CQ_RING);
        if (cq_ptr == MAP_FAILED) return;
        sqe_len = p.sq_entries * sizeof(io_uring_sqe);
        sqe_ptr = mmap(nullptr, sqe_len, PROT_READ | PROT_WRITE,
                       MAP_SHARED | MAP_POPULATE, ring_fd,
                       IORING_OFF_SQES);
        if (sqe_ptr == MAP_FAILED) return;
        auto* sqb = static_cast<uint8_t*>(sq_ptr);
        sq_head = reinterpret_cast<unsigned*>(sqb + p.sq_off.head);
        sq_tail = reinterpret_cast<unsigned*>(sqb + p.sq_off.tail);
        sq_mask = reinterpret_cast<unsigned*>(sqb + p.sq_off.ring_mask);
        sq_array = reinterpret_cast<unsigned*>(sqb + p.sq_off.array);
        auto* cqb = static_cast<uint8_t*>(cq_ptr);
        cq_head = reinterpret_cast<unsigned*>(cqb + p.cq_off.head);
        cq_tail = reinterpret_cast<unsigned*>(cqb + p.cq_off.tail);
        cq_mask = reinterpret_cast<unsigned*>(cqb + p.cq_off.ring_mask);
        cqes = reinterpret_cast<io_uring_cqe*>(cqb + p.cq_off.cqes);
        sqes = static_cast<io_uring_sqe*>(sqe_ptr);
        ok = true;
    }
    ~Uring() {
        if (sqe_ptr != MAP_FAILED) munmap(sqe_ptr, sqe_len);
        if (cq_ptr != MAP_FAILED && cq_ptr != sq_ptr)
            munmap(cq_ptr, cq_len);
        if (sq_ptr != MAP_FAILED) munmap(sq_ptr, sq_len);
        if (ring_fd >= 0) close(ring_fd);
    }
};

inline unsigned load_acquire(const unsigned* p) {
    return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
inline void store_release(unsigned* p, unsigned v) {
    __atomic_store_n(p, v, __ATOMIC_RELEASE);
}

// synchronous completion for error/short-read cases
bool pread_full(int fd, uint8_t* dst, int64_t len, int64_t off) {
    int64_t done = 0;
    while (done < len) {
        ssize_t r = pread(fd, dst + done,
                          static_cast<size_t>(len - done), off + done);
        if (r <= 0) return false;
        done += r;
    }
    return true;
}

}  // namespace

extern "C" {

// Per-read page-cache bypass: the read's pages are dropped from the
// cache once the IO completes (buffered O_DIRECT analog without the
// alignment rules; kernel >= 6.14). The reference's AIO backend opens
// the index O_DIRECT for the same reason — cold queries must not warm
// the cache they are measured against (reference:
// cobs/query/compact_index/aio_search_file.cpp:23-41, util/aio.cpp:
// 25-39).
#ifndef RWF_DONTCACHE
#define RWF_DONTCACHE 0x00000080
#endif

// Gather n rows of row_bytes each from an open file: row i is read from
// file offset base_off + rows[i]*row_bytes into out + i*out_stride.
// dontcache != 0 requests RWF_DONTCACHE reads (see above). Returns 0 on
// success, 1 on success with dontcache requested but unsupported by the
// kernel/filesystem (reads went through the cache), -1 when io_uring is
// unavailable (caller falls back), -2 on hard IO error.
int32_t cobs_gather_rows_file(int32_t fd, int64_t base_off,
                              int64_t row_bytes, const int64_t* rows,
                              int64_t n, uint8_t* out,
                              int64_t out_stride, int32_t depth_arg,
                              int32_t dontcache) {
    if (n <= 0) return 0;
    unsigned depth = 256;
    if (depth_arg > 0 && depth_arg <= 4096)
        depth = static_cast<unsigned>(depth_arg);
    Uring r(depth);
    if (!r.ok) return -1;
    int64_t submitted = 0, completed = 0;
    unsigned inflight_cap = r.p.sq_entries;
    bool want_dontcache = dontcache != 0, flag_unsupported = false;
    int rc = 0;
    while (completed < n) {
        unsigned to_submit = 0;
        unsigned tail = load_acquire(r.sq_tail);
        while (submitted < n &&
               static_cast<unsigned>(submitted - completed) <
                   inflight_cap) {
            unsigned idx = tail & *r.sq_mask;
            io_uring_sqe* sqe = &r.sqes[idx];
            std::memset(sqe, 0, sizeof(*sqe));
            sqe->opcode = IORING_OP_READ;
            sqe->fd = fd;
            sqe->addr = reinterpret_cast<uint64_t>(
                out + submitted * out_stride);
            sqe->len = static_cast<unsigned>(row_bytes);
            sqe->off = static_cast<uint64_t>(
                base_off + rows[submitted] * row_bytes);
            if (want_dontcache && !flag_unsupported)
                sqe->rw_flags = RWF_DONTCACHE;
            sqe->user_data = static_cast<uint64_t>(submitted);
            r.sq_array[idx] = idx;
            ++tail;
            ++to_submit;
            ++submitted;
        }
        store_release(r.sq_tail, tail);
        long ret = syscall(__NR_io_uring_enter, r.ring_fd, to_submit,
                           1U, IORING_ENTER_GETEVENTS, nullptr, 0);
        if (ret < 0) return completed == 0 ? -1 : -2;
        unsigned head = load_acquire(r.cq_head);
        while (head != load_acquire(r.cq_tail)) {
            io_uring_cqe* c = &r.cqes[head & *r.cq_mask];
            int64_t i = static_cast<int64_t>(c->user_data);
            if (c->res != static_cast<int32_t>(row_bytes)) {
                if (want_dontcache && !flag_unsupported &&
                    (c->res == -EOPNOTSUPP || c->res == -EINVAL)) {
                    // kernel or filesystem without RWF_DONTCACHE:
                    // drop the flag for the rest of the batch and
                    // report plain buffered completion to the caller
                    flag_unsupported = true;
                }
                // short read / error / unsupported-flag retry: finish
                // this row synchronously
                if (!pread_full(fd, out + i * out_stride, row_bytes,
                                base_off + rows[i] * row_bytes))
                    rc = -2;
            }
            ++head;
            ++completed;
        }
        store_release(r.cq_head, head);
    }
    if (rc == 0 && want_dontcache && flag_unsupported) return 1;
    return rc;
}

}  // extern "C"

#else  // no io_uring header

extern "C" {
int32_t cobs_gather_rows_file(int32_t, int64_t, int64_t, const int64_t*,
                              int64_t, uint8_t*, int64_t, int32_t,
                              int32_t) {
    return -1;
}
}

#endif
