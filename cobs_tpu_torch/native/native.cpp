// Host runtime of the streamed (host-mmap) backend of cobs_tpu_torch:
// the threaded scattered row gather, the host gather/AND/expand-add
// scorer, and the io_uring row gather of cold-cache serving.
//
// A copy of those three parts of cobs_tpu/native/native.cpp (the port
// never imports cobs_tpu, whose package imports jax); the hashing and
// construction entry points there are not part of the query path this
// library serves. Exposed as a flat C ABI bound with ctypes, which
// releases the GIL for the length of every call.
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
