#!/usr/bin/env python3
"""Smoke test of the cobs_tpu_torch query and construction paths on one
CUDA card.

    python3 chip_smoke.py

Builds the four CUDA kernels from the sources in this checkout and the two
control kernels of cobs_tpu_torch/experiments/csrc (one nvcc per source,
all started together), then runs these phases, each ending in
torch.cuda.synchronize():

1. the gather-and-count kernel (K1) against its plain PyTorch version at
   mixed shapes (T, h, P, W), exact; then at the edges of its design,
   exact and bit-equal on a second launch: T*h below, at and one past
   the ring's row slices, every cluster size 1-8, the 4-byte path (W in
   1, 3, 5), W above one slice (1100, 3136), h in 1, 3, 8, more than 240
   terms in one CTA, ids out of range;
2. `Search` on the committed golden indexes (tests/data/golden) on the
   card: the reference's result lines, with the hash kernel and K1
   launched;
3. the reference's default scale (`cobs classic-construct-random`
   defaults, reference src/cobs.cpp:243-291): 10,000 documents, 2^21
   Bloom rows, one hash, k=31; a random matrix made on the card from a
   seed; 64 random 1,030 bp queries through
   `Search.search_batch(threshold=0, num_results=100)`, hashed on the
   card (the default). It launches the hash kernel and K1 (and
   `search_stream` launches each once per batch); its ranked results
   equal host hashing's, search_stream's and a numpy ranking of the plain
   scores;
   the hash kernel's row ids equal the host pipeline's; K1's full score
   tensors and top-k pairs equal the plain version's. Then `search_batch`
   and `search_stream` over 16 batches of 64 queries are timed (q/s and
   `Timer` phases), and a profiler window gives the card's busy share;
4. wide rows: 2^21 rows x 3,136 words (100,352 documents, a 26.3 GB
   matrix, past int32 word offsets): K1 against its plain version, and K2
   against its plain version on the same matrix, exact;
5. the hash kernel against its plain version, exact, at k in {7, 15, 31,
   32, 33, 64}, h in {1, 3}, P in {1, 3} with unequal signature sizes,
   canonicalize in {0 (random bytes), 1}, with variable query lengths;
   at k in {31, 32, 33} with rows of 1,030-1,037 bytes (windows at every
   byte offset mod 8, lengths not multiples of 4) at h=1, P=1 and h=3,
   P=8; then timed at phase 3's shape and at the compact shape (h=3,
   P=8 pages of unequal sizes) beside its control, the earlier
   one-byte-at-a-time kernel (experiments/csrc/device_hash_control.cu),
   with its bound;
6. K2 (`dma_gather_rows`) against its plain version, exact and bit-equal
   on a second launch, at W in {1, 3, 384, 3136, 4100, 16384} (rows of
   up to eight 8 KB chunks on the bulk path) and N in {1, 17, 16384},
   with out-of-range ids, at the default plan and two forced ones, and
   on an unaligned view (the 4-byte path);
7. K2's own path, the row-gather bandwidth sweep of
   cobs_tpu_torch/experiments/dma_gather_bench.py, beside index_select;
8. K1's batch sweep, cobs_tpu_torch/experiments/gather_count_bench.py:
   B in {1, 8, 64, 256, 1024} at the reference shape and phase 4's wide
   rows, each checked against the plain version first;
9. the streamed (host-mmap) backend: the golden indexes as
   `StreamedIndex` in device and host scoring, warm and cold, give the
   reference's lines; then phase 3's shape as a classic index file on
   local disk (2^21 rows x 1,250 B, random bytes from a seed, deleted at
   the end): 1,024 random 1,030 bp queries in batches of 64 through
   `Search(path, streamed=True)` in device and host scoring and through
   `Search(path)` (held on the card), `search_batch` and `search_stream`,
   `num_results` 100 and 0: every ranking equal; one batch's score
   vectors equal across the three; `Search(path)` streams above
   `max_device_index_bytes`; K1 and the hash kernel launch on the
   streamed path and equal their plain versions at its shapes. Prints
   q/s, `Timer` phases, unique rows and bytes uploaded per batch, the
   pinned H2D rate, a cold run (io_uring with RWF_DONTCACHE where the
   machine allows it, said either way) and the card's busy share;
10. construction: the bit scatter kernel against its plain version on
   word-major words [Wc, R1], bit for bit and again on a second launch,
   at its edges (n = 0, D in {1, 7, 8, 31, 33, 63, 1000, 1023}, every
   update to one row, rows 0 and R1 - 1, duplicates, updates outside the
   matrix, n not a multiple of the block, a chunk spanning two strips,
   views off a 16-byte boundary, R1 = 2^24 + 1) and the device build in
   many upload chunks against its CPU build; the
   CLI's classic-construct and compact-construct on a copy of
   tests/data/fasta == the golden files; then 1,000 FASTA documents of
   random ACGT from a seed, 250 kbp-1 Mbp (k=31, h=1, fpr 0.3,
   canonical), under bench_data/ and deleted afterwards: the classic and
   the compact index built on the card (the kernel launched, count at 0
   just before each) and through the host scatter (not launched), files
   identical; the kernel alone at a full upload chunk against its plain
   version and its bound, warm and with the L2 flushed before each
   launch, and at R1 = 2^24 + 1, each beside its control (the earlier
   row-major one-atomic-per-update kernel,
   experiments/csrc/construct_scatter_control.cu); the
   kernel's device time inside one more classic device build from a
   profiler window; stage times and updates/s; 64 queries of 1,030
   bp cut from known documents on the device-built classic index: each
   source document scores all 1,000 terms, and the top 100 equal streamed
   host scoring's.

Prints the card's name and power limit, the build times, the times, then
a JSON line of the kernels and, last, the device JSON line. Any failure
raises and exits non-zero; so does a machine without a CUDA card.
"""

import concurrent.futures
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "data" / "golden"
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
GOLDEN_LINES = [("sample1", 20), ("sample7", 3), ("sample2", 1),
                ("sample4", 1), ("sample6", 1), ("sample3", 0),
                ("sample5", 0)]
KERNELS = {  # name -> (source, the TPU or XLA code it replaces)
    "gather_and_count": ("cobs_tpu_torch/ops/csrc/gather_count.cu",
                         "cobs_tpu/ops/query_kernel.py:171"),
    "rows_from_queries": ("cobs_tpu_torch/ops/csrc/device_hash.cu",
                          "cobs_tpu/ops/device_hash.py:190"),
    "dma_gather_rows": ("cobs_tpu_torch/ops/csrc/dma_gather.cu",
                        "cobs_tpu/ops/dma_gather.py:79"),
    "construct_scatter": ("cobs_tpu_torch/ops/csrc/construct_scatter.cu",
                          "cobs_tpu/construct/device.py:46"),
}
DEVICE = "cuda"
#: H100 SXM peaks (NVIDIA's data sheet): device memory bytes/s, and the
#: float32 rate outside the tensor cores, the nearest listed rate for the
#: scalar integer work of these kernels
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_matrix(torch, rows: int, words: int, seed: int):
    """int32 [rows + 1, words] of uniform random bits made on the card,
    with the all-zero last row."""
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        random_matrix as bits,
    )

    m = bits(torch, rows + 1, words, seed, DEVICE)
    m[rows] = 0
    return m


def max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item())


def acgt_queries(rng, n: int, length: int) -> list[str]:
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [acgt[rng.integers(0, 4, length)].tobytes().decode()
            for _ in range(n)]


def pairs(results) -> list:
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def phase_mixed_shapes(torch, qk, rng) -> int:
    R, B = 4099, 3
    worst = 0
    for W in (4, 316, 384):
        host = rng.integers(0, 1 << 32, size=(R + 1, W),
                            dtype=np.uint64).astype(np.uint32)
        host[-1] = 0
        m = torch.from_numpy(host.view(np.int32)).to(DEVICE)
        for T in (1, 17, 128, 1000):
            for h in (1, 3):
                for P in (1, 3):
                    rows = rng.integers(0, R, size=(B, T, h, P)) \
                        .astype(np.int32)
                    rows[:, T - T // 8:] = R   # zero-row padding terms
                    rows[0, 0, 0, 0] = -3      # out of range: zero row
                    rows[-1, -1, -1, -1] = R + 5
                    r = torch.from_numpy(rows).to(DEVICE)
                    err = max_err(qk.gather_and_count(m, r, h),
                                  qk.gather_and_count_reference(m, r, h))
                    torch.cuda.synchronize()
                    require(err == 0, f"kernel != plain at B={B} T={T} "
                                      f"h={h} P={P} W={W}: {err}")
                    worst = max(worst, err)
    print("phase 1 K1 mixed shapes: kernel == plain at 48 shapes")
    return max(worst, phase_k1_edges(torch, qk, rng))


def forced_plan(plan, T: int, cluster: int):
    """`plan` with its term ranges cut into `cluster` CTAs per cluster."""
    return plan._replace(cluster=cluster, tpc=-(-T // cluster),
                         grid=plan.grid // plan.cluster * cluster)


def phase_k1_edges(torch, qk, rng) -> int:
    """K1 at the edges of its design, each exact against the plain version
    and bit-equal on a second launch: T*h below, at and one past the ring
    depth (one CTA per cluster); every cluster size 1-8, with empty CTAs;
    more than 255 terms in one CTA (a flush of the counters mid-loop); the
    4-byte path (W in 1, 3, 5); W above one slice (1100, 3136); h in 1, 3,
    8; ids out of range."""
    R, B, P = 4099, 2, 2
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = 0

    def check(m, rows, h, plan, what):
        nonlocal cases
        r = torch.from_numpy(rows).to(DEVICE)
        got = qk.gather_and_count(m, r, h, plan)
        again = qk.gather_and_count(m, r, h, plan)
        want = qk.gather_and_count_reference(m, r, h)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K1 != plain at {what}, plan "
                                        f"{plan}: {max_err(got, want)}")
        require(torch.equal(got, again), f"K1 not bit-equal twice at {what}")
        cases += 1

    def ids(T, h):
        rows = rng.integers(0, R, size=(B, T, h, P)).astype(np.int32)
        rows[0, 0, 0, 0] = -3
        rows[-1, -1, -1, -1] = R + 5
        return rows

    for W in (1, 3, 5, 384, 1100, 3136):
        host = rng.integers(0, 1 << 32, size=(R + 1, W),
                            dtype=np.uint64).astype(np.uint32)
        host[-1] = 0
        m = torch.from_numpy(host.view(np.int32)).to(DEVICE)
        for h in (1, 3, 8):
            plan = qk.plan_gather_count(B, 1, h, P, W, sm)
            depth = plan.stages * plan.stage_rows  # row slices in the ring
            for T in sorted({max(1, depth // h - 1), -(-depth // h),
                             -(-depth // h) + 1}):
                plan = forced_plan(qk.plan_gather_count(B, T, h, P, W, sm),
                                   T, 1)
                check(m, ids(T, h), h, plan,
                      f"W={W} h={h} T={T} (ring {depth})")
        if W == 384:
            T = 100
            for cluster in range(1, 9):
                plan = forced_plan(qk.plan_gather_count(B, T, 1, P, W, sm),
                                   T, cluster)
                check(m, ids(T, 1), 1, plan, f"W={W} cluster={cluster}")
            for T in (9, 1000):  # empty CTAs; 1000 terms in one CTA
                cluster = 8 if T == 9 else 1
                plan = forced_plan(qk.plan_gather_count(B, T, 1, P, W, sm),
                                   T, cluster)
                check(m, ids(T, 1), 1, plan,
                      f"W={W} T={T} cluster={cluster}")
    print(f"phase 1 K1 edges: kernel == plain, and bit-equal on a second "
          f"launch, at {cases} cases")
    return 0


def phase_golden(torch, qk, dh, Search) -> None:
    for name in ("fasta7.cobs_classic", "fasta7.cobs_compact"):
        before = (qk.LAUNCHES, dh.LAUNCHES)
        s = Search(str(GOLDEN_DIR / name), device=DEVICE)
        got = [(r.doc_name, r.score)
               for r in s.search(GOLDEN_QUERY, threshold=0.0)]
        top = [(r.doc_name, r.score)
               for r in s.search(GOLDEN_QUERY, 0.0, num_results=3)]
        torch.cuda.synchronize()
        require(got == GOLDEN_LINES, f"{name}: {got}")
        require(top == GOLDEN_LINES[:3], f"{name} top 3: {top}")
        require(qk.LAUNCHES >= before[0] + 2, f"{name}: K1 not launched")
        require(dh.LAUNCHES >= before[1] + 2,
                f"{name}: hash kernel not launched")
        print(f"phase 2 golden {name}: {got}")


def timer_line(timer, n: int) -> str:
    return " ".join(f"{p}={timer.get(p) / n * 1e3:.3f}ms"
                    for p in ("hashes", "io", "add rows", "sort results"))


def device_busy_us(torch, fn) -> tuple[float, list]:
    """Device time (us) of fn() from a torch.profiler window: the sum of
    the device-side events (kernels and copies; the host-side ops that
    launch them are left out, so nothing counts twice), and the five
    largest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = [(e.self_device_time_total, e.key) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    per.sort(reverse=True)
    return sum(us for us, _ in per), per[:5]


def phase_reference_scale(torch, qk, dh, engine, Search, settings,
                          card: str, rows: int = 1 << 21, B: int = 64,
                          n_batches: int = 16) -> dict:
    W, docs, L, k = 384, 10_000, 1030, 100
    ix = engine.DeviceIndex.from_arrays(
        random_matrix(torch, rows, W, seed=1), [0], [rows], W,
        term_size=31, canonicalize=1, num_hashes=1, page_size=docs // 8,
        file_names=[f"doc{i:05d}" for i in range(docs)], device=DEVICE)
    rng = np.random.default_rng(2)
    stream_q = acgt_queries(rng, B * n_batches, L)
    queries = stream_q[:B]
    s = Search(ix)
    require(settings.device_hash == "auto", "device hashing is not the "
                                            "default")
    torch.cuda.synchronize()

    # the main path, with every count at 0 just before it
    qk.LAUNCHES = dh.LAUNCHES = 0
    results = s.search_batch(queries, threshold=0.0, num_results=k)
    torch.cuda.synchronize()
    launches = {"gather_and_count": qk.LAUNCHES,
                "rows_from_queries": dh.LAUNCHES}
    require(min(launches.values()) > 0,
            f"Search.search_batch did not launch both kernels: {launches}")

    settings.device_hash = "host"
    try:
        host_results = s.search_batch(queries, threshold=0.0,
                                      num_results=k)
    finally:
        settings.device_hash = "auto"
    require(pairs(results) == pairs(host_results),
            "reference scale: device hashing ranks differently from host "
            "hashing")
    qk.LAUNCHES = dh.LAUNCHES = 0
    streamed = list(s.search_stream(queries, 0.0, k, batch_size=B // 2))
    require(qk.LAUNCHES == dh.LAUNCHES == 2,
            f"search_stream over 2 batches launched K1 {qk.LAUNCHES} and "
            f"the hash kernel {dh.LAUNCHES} times")
    require(pairs(streamed) == pairs(results),
            "reference scale: search_stream ranks differently")

    # the hash kernel against the host pipeline (create_hashes +
    # row_indices) and its plain version
    hashes = engine.create_hashes([q.encode() for q in queries], 31, 1, 1)
    r = engine._rows_tensor(ix, hashes)
    qb = engine.QueryBytes([q.encode() for q in queries])
    qdata, qlens = engine._device_hash_args(ix, qb)
    sig, off, mag = ix.page_tables
    hash_args = (qdata, qlens, 31, 1, 1, sig, off, ix.zero_row, mag)
    dev_rows = dh.rows_from_queries(*hash_args)
    plain_rows = dh.rows_from_queries_reference(*hash_args)
    torch.cuda.synchronize()
    require(torch.equal(dev_rows, r), "hash kernel != host pipeline")
    require(torch.equal(dev_rows, plain_rows), "hash kernel != plain")

    got = qk.gather_and_count(ix.matrix, r, 1)
    want = qk.gather_and_count_reference(ix.matrix, r, 1)
    err = max_err(got, want)
    kv, ks = engine.topk_slots(got, ix.valid_mask, k)
    tv, ts = engine.topk_slots(want, ix.valid_mask, k)
    torch.cuda.synchronize()
    require(err == 0, f"reference scale: kernel != plain, {err}")
    require(torch.equal(kv, tv) and torch.equal(ks, ts),
            "reference scale: top-k pairs differ")
    plain = engine._strip_word_padding(want.cpu().numpy(), B,
                                       ix.doc_layout)
    for b in range(B):
        sc = plain[b, :docs]
        order = np.lexsort((np.arange(docs), -sc))[:k]
        expect = [(f"doc{i:05d}", int(sc[i])) for i in order]
        require([(x.doc_name, x.score) for x in results[b]] == expect,
                f"reference scale: query {b} ranking differs")

    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )

    k1 = {"ms": median_device_ms(
              torch, lambda i: qk.gather_and_count(ix.matrix, r, 1)),
          "plain_ms": median_device_ms(
              torch, lambda i: qk.gather_and_count_reference(ix.matrix, r,
                                                             1), reps=5)}
    T = L - 30
    rows_read = B * T * W * 4
    k1["bound_ms"], k1["bound_by"] = bound(
        rows_read + B * W * 32 * 4 + B * T * 4, B * T * W * 32)
    hk = {"ms": median_device_ms(
              torch, lambda i: dh.rows_from_queries(*hash_args)),
          "plain_ms": median_device_ms(
              torch, lambda i: dh.rows_from_queries_reference(*hash_args),
              reps=5)}
    # per term: 3 integer ops per key byte (load, shift, or), ~40 for the
    # XXH64 rounds and finalizer, k/2 canonical compares, 2 per page
    hk["bound_ms"], hk["bound_by"] = bound(
        B * L + B * 4 + B * T * 4 + 16, B * T * (3 * 31 + 40 + 15 + 2))

    # search_batch and search_stream over the same 16 batches, three
    # runs each in turns (host times spread by tens of percent)
    batches = [stream_q[i:i + B] for i in range(0, len(stream_q), B)]
    walls = {"batch": [], "stream": []}
    phases, ranked = {}, {}
    for path in ("batch", "stream", "stream", "batch", "batch", "stream"):
        s.timer_.reset()
        t0 = time.perf_counter()
        if path == "batch":
            ranked[path] = [rl for bq in batches
                            for rl in s.search_batch(bq, 0.0, k)]
        else:
            ranked[path] = list(s.search_stream(stream_q, 0.0, k,
                                                batch_size=B))
        walls[path].append(time.perf_counter() - t0)
        phases[path] = timer_line(s.timer_, n_batches)
    require(pairs(ranked["stream"]) == pairs(ranked["batch"]),
            "search_stream != search_batch")
    batch_s = statistics.median(walls["batch"])
    stream_s = statistics.median(walls["stream"])
    n_q = len(stream_q)
    busy_us, top = device_busy_us(
        torch, lambda: [s.search_batch(bq, 0.0, k) for bq in batches[:4]])
    busy_ms = busy_us / 4 / 1e3
    wall_ms = batch_s / n_batches * 1e3

    print(f"phase 3 reference scale (B={B} T={T} h=1 P=1 W={W}, {rows}+1 "
          f"rows, {card}): launches in one search_batch {launches}")
    print(f"phase 3 K1: kernel {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']}); {rows_read / k1['ms'] / 1e6:.1f} GB/s of "
          "rows")
    print(f"phase 3 hash kernel: kernel {hk['ms']:.4f} ms, plain (host "
          f"numpy) {hk['plain_ms']:.4f} ms, bound {hk['bound_ms']:.6f} ms "
          f"({hk['bound_by']})")
    for path, wall in (("batch", batch_s), ("stream", stream_s)):
        print(f"phase 3 Search.search_{path}: {n_q} queries in batches of "
              f"{B}, median of 3 runs {wall * 1e3:.3f} ms "
              f"({n_q / wall:.0f} q/s; runs "
              f"{min(walls[path]) * 1e3:.3f}-{max(walls[path]) * 1e3:.3f} "
              f"ms), per batch in the last run: {phases[path]}")
    print(f"phase 3 profiler over 4 search_batch calls: {busy_ms:.4f} ms "
          f"of device time per batch against {wall_ms:.3f} ms of wall "
          f"({100 * busy_ms / wall_ms:.1f} % busy); largest: "
          + "; ".join(f"{name[:60]} {us / 4:.1f} us" for us, name in top))
    return {"launches": launches, "err": err, "k1": k1, "hash": hk}


def phase_hash_kernel(torch, dh, rng, card: str) -> dict:
    """Phase 5: the hash kernel against its plain version, exact; then
    its two timed shapes beside the control (the earlier one-byte-at-a-
    time kernel, experiments/csrc/device_hash_control.cu)."""
    from cobs_tpu_torch.experiments import redesign_bench as rb

    acgt = np.frombuffer(b"ACGT", np.uint8)
    cases = 0

    def check(q, lens, k, h, canon, sigs, what):
        nonlocal cases
        qdata = torch.from_numpy(q).to(DEVICE)
        qlens = torch.from_numpy(lens).to(DEVICE)
        offs = tuple(int(x) for x in np.cumsum((0,) + sigs[:-1]))
        args = (qdata, qlens, k, h, canon, sigs, offs, int(sum(sigs)))
        got = dh.rows_from_queries(*args)
        want = dh.rows_from_queries_reference(*args)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"hash kernel != plain at k={k} h={h} P={len(sigs)} "
                f"canonicalize={canon} {what}: {max_err(got, want)}")
        cases += 1

    def batch(canon, B, L):
        return (acgt[rng.integers(0, 4, size=(B, L))] if canon
                else rng.integers(0, 256, size=(B, L)).astype(np.uint8))

    for k in (7, 15, 31, 32, 33, 64):
        lens = np.array([k, k + 1, 2 * k + 5, 300, 129 + k, 1030],
                        dtype=np.int32)   # lens[0] is a one-term query
        L = int(lens.max()) + 3
        for canon in (0, 1):
            q = batch(canon, len(lens), L)
            for h in (1, 3):
                for sigs in ((1 << 21,), (1009, 65537, 3)):
                    check(q, lens, k, h, canon, sigs, "")
    # rows of L = 1030..1037 bytes, so the queries' windows start at
    # every byte offset mod 8 of device memory, with true lengths that
    # are not multiples of 4; eight pages at h = 3 (the compact shape)
    for k in (31, 32, 33):
        for L in range(1030, 1038):
            lens = np.array([L, L - 1, L - 2, L - 3, k, k + 5, 4 * k + 1],
                            dtype=np.int32)
            for canon in (0, 1):
                q = batch(canon, len(lens), L)
                for h, sigs in ((1, (1 << 21,)), (3, rb.COMPACT_SIGS)):
                    check(q, lens, k, h, canon, sigs, f"L={L}")
    print(f"phase 5 hash kernel: kernel == plain at {cases} cases")

    out = {}
    for name, h, sigs in (("phase 3", 1, (1 << 21,)),
                          ("compact", 3, rb.COMPACT_SIGS)):
        B, L, k = 64, 1030, 31
        T = L - k + 1
        r = rb.time_hash(torch, dh, rb.hash_args(torch, dh, B, L, k, h,
                                                 sigs, seed=51))
        P = len(sigs)
        # phase 3's count per term (3k + 40 + 15 + 2, chip_smoke phase
        # 3), with 40 per further hash and 2 per further (hash, page)
        ops = B * T * (3 * k + 40 * h + 15 + 2 * h * P)
        r["bound_ms"], r["bound_by"] = bound(
            B * L + B * 4 + B * T * h * P * 4 + 24 * P, ops)
        out[name] = r
        print(f"phase 5 hash kernel, {name} shape (B={B} L={L} k={k} h={h} "
              f"P={P}, {card}): kernel {r['ms']:.4f} ms, control "
              f"{r['control_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}, {ops // (B * T)} operations per term; "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it)")
    return out


def phase_gather_small(torch, dg, rng) -> int:
    R = 4099
    cases = 0
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for W in (1, 3, 384, 3136, 4100, 16384):
        m = torch.from_numpy(
            rng.integers(0, 1 << 32, size=(R, W), dtype=np.uint64)
            .astype(np.uint32).view(np.int32)).to(DEVICE)
        for N in (1, 17, 16384):
            ids = rng.integers(0, R, size=N).astype(np.int32)
            if N > 1:
                ids[0], ids[-1] = -1, R      # out of range: zero rows
                ids[N // 2] = np.iinfo(np.int32).min
            r = torch.from_numpy(ids).to(DEVICE)
            want = dg.dma_gather_rows_reference(m, r)
            # the default plan, then (bulk path) rings of 3 stages, chunks
            # of 1 KB, and one CTA walking every unit
            plans = [None] + ([] if W % 4 else [
                dg.plan_gather(N, W, sm, 1024, 3 * 1024, 1),
                dg.plan_gather(N, W, 1, 4096, 64 << 10, 1)])
            for plan in plans:
                got = dg.dma_gather_rows(m, r, plan)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"K2 != plain at W={W} N={N} plan={plan}: "
                        f"{max_err(got, want)}")
                require(torch.equal(dg.dma_gather_rows(m, r, plan), got),
                        f"K2 not bit-equal twice at W={W} N={N}")
                cases += 1
    # an unaligned view: the kernel must take its 4-byte path
    m = torch.from_numpy(rng.integers(0, 1 << 31, size=(R * 8 + 1,))
                         .astype(np.int32)).to(DEVICE)[1:].view(R, 8)
    r = torch.from_numpy(rng.integers(-3, R + 3, size=100)
                         .astype(np.int32)).to(DEVICE)
    require(torch.equal(dg.dma_gather_rows(m, r),
                        dg.dma_gather_rows_reference(m, r)),
            "K2 != plain on an unaligned matrix")
    print(f"phase 6 K2: kernel == plain, and bit-equal on a second launch, "
          f"at {cases + 1} cases")
    return 0


def phase_wide_rows(torch, qk, dg, card: str, rows: int = 1 << 21,
                    T: int = 1024) -> int:
    W, B = 3136, 8
    m = random_matrix(torch, rows, W, seed=3)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, rows, size=(B, T, 1, 1)).astype(np.int32)
    require(rows < 1 << 20 or int(idx.max()) * W >= 1 << 31,
            "no row past int32 offsets")
    r = torch.from_numpy(idx).to(DEVICE)
    err = max_err(qk.gather_and_count(m, r, 1),
                  qk.gather_and_count_reference(m, r, 1))
    torch.cuda.synchronize()
    require(err == 0, f"wide rows: kernel != plain, {err}")

    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )

    ms = median_device_ms(torch, lambda i: qk.gather_and_count(m, r, 1),
                          reps=10)
    plain_ms = median_device_ms(
        torch, lambda i: qk.gather_and_count_reference(m, r, 1), reps=3)
    bound_ms, bound_by = bound(B * T * W * 4 + B * W * 32 * 4 + B * T * 4,
                               B * T * W * 32)
    print(f"phase 4 wide rows K1 (B={B} T={T} h=1 P=1 W={W}, {rows}+1 "
          f"rows, {card}): kernel {ms:.4f} ms ({B / ms * 1e3:.0f} q/s), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    ids = rng.integers(0, rows + 1, size=4096).astype(np.int32)
    ids[:8] = [rows, rows - 1, 0, -1, rows + 1, 1 << 30, 685_000, 700_000]
    require(int(ids.max()) * W >= 1 << 31, "no K2 row past int32 offsets")
    g = torch.from_numpy(ids).to(DEVICE)
    got = dg.dma_gather_rows(m, g)
    want = dg.dma_gather_rows_reference(m, g)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "wide rows: K2 != plain")
    print(f"phase 4 wide rows K2: kernel == plain at N=4096 past int32 "
          "word offsets")
    return err


def phase_streamed_golden(torch, native, Search, StreamedIndex,
                          settings) -> None:
    """The golden indexes served from host mmap on the card: device and
    host scoring, warm and cold."""
    for name in ("fasta7.cobs_classic", "fasta7.cobs_compact"):
        for mode in ("device", "host"):
            for cold in (False, True):
                settings.streamed_host_score = mode
                st = StreamedIndex(GOLDEN_DIR / name, device=DEVICE,
                                   drop_cache=cold)
                s = Search(st)
                got = [(r.doc_name, r.score)
                       for r in s.search(GOLDEN_QUERY, threshold=0.0)]
                top = [(r.doc_name, r.score)
                       for r in s.search(GOLDEN_QUERY, 0.0, num_results=3)]
                torch.cuda.synchronize()
                what = f"{name} streamed {mode}{' cold' if cold else ''}"
                require(got == GOLDEN_LINES, f"{what}: {got}")
                require(top == GOLDEN_LINES[:3], f"{what} top 3: {top}")
                require(st.uploaded_batches == (2 if mode == "device"
                                                else 0),
                        f"{what}: {st.uploaded_batches} uploads")
    settings.streamed_host_score = "auto"
    print("phase 9 golden streamed: classic and compact, device and host "
          "scoring, warm and cold, give the reference's lines; io_uring "
          f"{'works' if native.uring_supported() else 'unavailable'}, "
          f"RWF_DONTCACHE {native.dontcache_supported()}")


def write_classic_index(path: Path, rows: int, docs: int, seed: int) -> int:
    """A classic index file of `rows` Bloom rows over `docs` documents of
    uniform random bits from `seed` (k=31, one hash, canonical), synced to
    disk. Returns its size in bytes."""
    from cobs_tpu_torch.fmt.classic import ClassicIndexHeader

    header = ClassicIndexHeader(
        term_size=31, canonicalize=1, signature_size=rows, num_hashes=1,
        file_names=[f"doc{i:05d}" for i in range(docs)])
    rng = np.random.default_rng(seed)
    stripe = (64 << 20) // header.row_size
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        header.serialize(f)
        for r in range(0, rows, stripe):
            f.write(rng.bytes(min(stripe, rows - r) * header.row_size))
        f.flush()
        os.fsync(f.fileno())
    return path.stat().st_size


def read_through(path: Path) -> None:
    """Read a file once, so its pages are in the OS page cache."""
    with open(path, "rb") as f:
        while f.read(64 << 20):
            pass


def same_ranking(a, b) -> bool:
    """Ranked result lists equal, documents and scores, in order."""
    return len(a) == len(b) and all(
        np.array_equal(x._gidx, y._gidx) and np.array_equal(x._scores,
                                                             y._scores)
        for x, y in zip(a, b))


def streamed_timer_line(timer, n: int) -> str:
    return " ".join(f"{p}={timer.get(p) / n * 1e3:.3f}ms"
                    for p in ("hashes", "io", "and rows", "add rows",
                              "sort results"))


def phase_streamed(torch, qk, dh, engine, native, Search, settings,
                   card: str, rows: int = 1 << 21, B: int = 64,
                   n_batches: int = 16, cold_batches: int = 2) -> dict:
    """Phase 9: the streamed backend at the reference's default scale, a
    classic index file of 2^21 rows x 1,250 B on local disk."""
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )

    docs, L, k = 10_000, 1030, 100
    path = ROOT / "bench_data" / "phase9_reference.cobs_classic"
    free = shutil.disk_usage(ROOT).free
    require(free > 2 * rows * docs // 8, f"{free} bytes free on disk: too "
                                         "few for the phase 9 index file")
    t0 = time.perf_counter()
    size = write_classic_index(path, rows, docs, seed=9)
    print(f"phase 9 wrote {path.name}: {size} bytes in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        return _phase_streamed(torch, qk, dh, engine, native, Search,
                               settings, card, path, size, B, n_batches,
                               cold_batches, docs, L, k, median_device_ms)
    finally:
        path.unlink(missing_ok=True)


def _phase_streamed(torch, qk, dh, engine, native, Search, settings, card,
                    path, size, B, n_batches, cold_batches, docs, L, k,
                    median_device_ms) -> dict:
    rng = np.random.default_rng(10)
    queries = acgt_queries(rng, B * n_batches, L)
    batches = [queries[i:i + B] for i in range(0, len(queries), B)]
    read_through(path)
    require(settings.streamed_host_score == "auto",
            "auto is not the default streamed score mode")
    s_dev = Search(str(path), streamed=True)
    st = s_dev.index_files[0]
    require(isinstance(st, engine.StreamedIndex) and not st.scores_on_host(),
            "Search(streamed=True) on the card is not a device-scored "
            "StreamedIndex")
    torch.cuda.synchronize()

    # the streamed main path, with every count at 0 just before it
    qk.LAUNCHES = dh.LAUNCHES = 0
    first = s_dev.search_batch(batches[0], threshold=0.0, num_results=k)
    torch.cuda.synchronize()
    launches = {"gather_and_count": qk.LAUNCHES,
                "rows_from_queries": dh.LAUNCHES}
    require(min(launches.values()) > 0, f"the streamed search_batch did "
                                        f"not launch both kernels: "
                                        f"{launches}")

    s_held = Search(str(path))
    held = s_held.index_files[0]
    require(isinstance(held, engine.DeviceIndex), "the reference index was "
                                                  "not held on the card")
    old = settings.max_device_index_bytes
    settings.max_device_index_bytes = size - 1
    try:
        auto = Search(str(path)).index_files[0]
    finally:
        settings.max_device_index_bytes = old
    require(isinstance(auto, engine.StreamedIndex),
            "Search(path) above max_device_index_bytes did not stream")
    del auto

    # one batch's score vectors: streamed device (device and host
    # hashing), streamed host and the device-held index
    qbytes = [q.encode() for q in batches[0]]
    hashes = engine.create_hashes(qbytes, 31, 1, 1)
    want = engine.score_batch(held, engine.QueryBytes(qbytes))
    got = {"device": st.score_batch(engine.QueryBytes(qbytes)),
           "device, host hashing": st.score_batch(hashes)}
    settings.streamed_host_score = "host"
    try:
        got["host"] = st.score_batch(hashes)
    finally:
        settings.streamed_host_score = "auto"
    for mode, sc in got.items():
        require(np.array_equal(sc, want), f"streamed {mode} scores != the "
                                          "device-held index's")
    # the two score modes alone on one batch of host hashes (median of 5)
    score_ms = {}
    for mode in ("device", "host"):
        settings.streamed_host_score = mode
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            st.score_batch(hashes)
            walls.append((time.perf_counter() - t0) * 1e3)
        score_ms[mode] = statistics.median(walls)
    settings.streamed_host_score = "auto"

    # the kernels against their plain versions at the streamed path's
    # shapes: K1 on a batch's staged rows, the hash kernel with the
    # streamed zero row
    gmat, inv = st.stage(engine.QueryBytes(qbytes))
    k1_err = max_err(qk.gather_and_count(gmat, inv, 1),
                     qk.gather_and_count_reference(gmat, inv, 1))
    qdata, qlens = engine._device_hash_args(st, engine.QueryBytes(qbytes))
    sig, off, mag = st.page_tables
    hash_args = (qdata, qlens, 31, 1, 1, sig, off, st.zero_row, mag)
    hash_ok = torch.equal(dh.rows_from_queries(*hash_args),
                          dh.rows_from_queries_reference(*hash_args))
    torch.cuda.synchronize()
    require(k1_err == 0, f"streamed K1 != plain: {k1_err}")
    require(hash_ok, "streamed hash kernel != plain")
    # the host gather of one batch's unique rows alone (median of 5)
    real = np.unique(np.concatenate([st.row_indices(h).ravel()
                                     for h in hashes]))
    into = np.zeros((real.size, st.word_width * 4), dtype=np.uint8)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.gather_rows(st._payload, st.page_size, real, into,
                           settings.threads)
        walls.append((time.perf_counter() - t0) * 1e3)
    gather_ms = statistics.median(walls)
    require(np.array_equal(into[:, :st.page_size],
                           np.asarray(st._payload[real])),
            "the host gather != the payload rows")
    del into

    # q/s: the device-held index, streamed device and streamed host
    # scoring, search_batch and search_stream, top-k and full ranking
    s_host = Search(engine.StreamedIndex(str(path), device=DEVICE))
    runs = {"held": s_held, "device": s_dev, "host": s_host}
    qps, phases, ranked = {}, {}, {}
    for nr in (k, 0):
        for mode, s in runs.items():
            settings.streamed_host_score = "host" if mode == "host" \
                else "auto"
            for how in ("batch", "stream"):
                s.timer_.reset()
                up0 = st.uploaded_batches, st.uploaded_rows, st.uploaded_bytes
                t0 = time.perf_counter()
                if how == "batch":
                    out = [rl for bq in batches
                           for rl in s.search_batch(bq, 0.0, nr)]
                else:
                    out = list(s.search_stream(queries, 0.0, nr,
                                               batch_size=B))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                qps[mode, how, nr] = len(queries) / wall
                phases[mode, how, nr] = streamed_timer_line(s.timer_,
                                                            n_batches)
                ranked[mode, how, nr] = out
                if mode == "device" and how == "batch" and nr == k:
                    ups = [a - b for a, b in zip(
                        (st.uploaded_batches, st.uploaded_rows,
                         st.uploaded_bytes), up0)]
    settings.streamed_host_score = "auto"
    for nr in (k, 0):
        base = ranked["held", "batch", nr]
        for key, out in ranked.items():
            if key[2] == nr:
                require(same_ranking(out, base), f"ranking of {key} != the "
                                                 "device-held search_batch")
    require(pairs(first) == pairs(ranked["device", "batch", k][:B]),
            "the first streamed batch ranks differently")

    # the upload: bytes per batch and the pinned H2D rate
    up_batches, up_rows, up_bytes = ups
    per_rows = up_rows // up_batches
    pinned = torch.empty((per_rows + 1, st.word_width), dtype=torch.int32,
                         pin_memory=True)
    dst = torch.empty(pinned.shape, dtype=torch.int32, device=DEVICE)
    h2d_ms = median_device_ms(
        torch, lambda i: dst.copy_(pinned, non_blocking=True), reps=10)
    h2d_gbs = pinned.numel() * 4 / h2d_ms / 1e6
    del pinned, dst

    busy_us, top = device_busy_us(
        torch, lambda: [s_dev.search_batch(bq, 0.0, k) for bq in batches[:4]])
    busy_ms = busy_us / 4 / 1e3
    wall_ms = 1e3 / qps["device", "batch", k] * B

    # cold: io_uring with RWF_DONTCACHE, or eviction after every batch
    cold = engine.StreamedIndex(str(path), device=DEVICE, drop_cache=True)
    s_cold = Search(cold)
    cold.drop_cache()
    cold_q = queries[:B * cold_batches]
    cold_qps = {}
    for how in ("batch", "stream"):
        s_cold.timer_.reset()
        t0 = time.perf_counter()
        if how == "batch":
            out = [rl for bq in batches[:cold_batches]
                   for rl in s_cold.search_batch(bq, 0.0, k)]
        else:
            out = list(s_cold.search_stream(cold_q, 0.0, k, batch_size=B))
        torch.cuda.synchronize()
        cold_qps[how] = len(cold_q) / (time.perf_counter() - t0)
        require(same_ranking(out, ranked["held", "batch", k][:len(cold_q)]),
                f"cold search_{how} ranks differently")
    cold_phases = streamed_timer_line(s_cold.timer_, cold_batches)

    print(f"phase 9 streamed reference scale (B={B} T={L - 30} h=1 P=1 "
          f"W={st.word_width}, {st.total_rows} rows x {st.page_size} B "
          f"on disk, {card}): launches in one streamed search_batch "
          f"{launches}; auto-selection streams above "
          "max_device_index_bytes; one batch's scores equal across "
          "streamed device (device and host hashing), streamed host and "
          "the device-held index; K1 and the hash kernel == plain at the "
          "streamed shapes; rankings equal across modes and paths")
    print(f"phase 9 scoring one batch of host hashes, median of 5: device "
          f"mode {score_ms['device']:.3f} ms, host mode "
          f"{score_ms['host']:.3f} ms (settings.threads="
          f"{settings.threads})")
    print(f"phase 9 host gather of one batch's {real.size} unique rows "
          f"alone, median of 5: {gather_ms:.3f} ms "
          f"({real.size * st.page_size / gather_ms / 1e6:.2f} GB/s)")
    print(f"phase 9 upload: {per_rows} unique rows per batch "
          f"({up_rows / up_batches:.1f} on average), "
          f"{up_bytes / up_batches / 1e6:.2f} MB uploaded per batch; pinned "
          f"H2D of one batch {h2d_ms:.3f} ms ({h2d_gbs:.2f} GB/s)")
    for nr in (k, 0):
        for mode in runs:
            for how in ("batch", "stream"):
                print(f"phase 9 {mode:6s} search_{how} num_results={nr}: "
                      f"{qps[mode, how, nr]:.0f} q/s; per batch: "
                      f"{phases[mode, how, nr]}")
    print(f"phase 9 cold (device scoring, {cold_batches} batches, io_uring "
          f"{'works' if native.uring_supported() else 'unavailable'}, "
          f"RWF_DONTCACHE {native.dontcache_supported()}): search_batch "
          f"{cold_qps['batch']:.0f} q/s, search_stream "
          f"{cold_qps['stream']:.0f} q/s; per batch in the last run: "
          f"{cold_phases}")
    print(f"phase 9 profiler over 4 streamed search_batch calls: "
          f"{busy_ms:.4f} ms of device time per batch against "
          f"{wall_ms:.3f} ms of wall ({100 * busy_ms / wall_ms:.1f} % busy); "
          "largest: "
          + "; ".join(f"{name[:60]} {us / 4:.1f} us" for us, name in top))
    return {"launches": launches, "err": k1_err}


#: the construction phase's corpus: 1,000 FASTA documents of random ACGT,
#: lengths spread evenly over 250 kbp-1 Mbp (a bacterial collection's
#: shape; real assemblies run to ~5 Mbp each)
CONSTRUCT_DOCS = 1000
CONSTRUCT_LENGTHS = (250_000, 1_000_000)
CONSTRUCT_QUERIES, CONSTRUCT_QUERY_LEN = 64, 1030


def write_fasta_corpus(root: Path, n_docs: int, lo: int, hi: int,
                       seed: int) -> list[int]:
    """n_docs FASTA files of random ACGT from `seed` under root, 80
    letters a line, lengths spread evenly over [lo, hi] in a shuffled
    order. Returns the lengths by document number."""
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n_docs).astype(np.int64)
    rng.shuffle(lengths)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    root.mkdir(parents=True, exist_ok=True)
    for i, n in enumerate(lengths.tolist()):
        seq = acgt[rng.integers(0, 4, n, dtype=np.uint8)]
        full = n // 80 * 80
        lines = np.empty((n // 80, 81), dtype=np.uint8)
        lines[:, :80] = seq[:full].reshape(-1, 80)
        lines[:, 80] = ord("\n")
        with open(root / f"doc{i:04d}.fasta", "wb") as f:
            f.write(b">doc%d\n" % i)
            f.write(lines.tobytes())
            if n > full:
                f.write(seq[full:].tobytes() + b"\n")
    return lengths.tolist()


def read_fasta_sequence(path: Path) -> bytes:
    return b"".join(path.read_bytes().split(b"\n")[1:])


def phase_construct_edges(torch, cs, device_build) -> None:
    """The bit scatter kernel against its plain version on the card, bit
    for bit and again on a second launch, on word-major words [Wc, R1]:
    n = 0; D in {1, 7, 8, 31, 33, 63, 1000, 1023} (63 and 1023 are
    32 Wc - 1); every update to one row; rows 0 and R1 - 1; duplicates;
    updates outside the matrix; n not a multiple of the block; a chunk
    whose documents span two strips; R1 = 2^24 + 1 (a 64 MB strip); a
    view that does not start on 16 bytes. Then the device build of a few
    documents in chunks of 1,000 updates (many chunks through the ring)
    against its CPU build."""
    cases = 0

    def check(R1, Wc, rows, docs, what):
        """Each launch plan: the default, the one-pass kernel, and
        binning with bins of 64 entries (most updates overflow them)."""
        nonlocal cases
        start = torch.randint(-2**31, 2**31 - 1, (Wc, R1),
                              dtype=torch.int32, device=DEVICE)
        want = cs.construct_scatter_reference(start.clone(), rows, docs)
        n = rows.shape[0]
        plans = [None, cs.ScatterPlan(False)]
        if n:
            slots, nblk = min(cs.MAX_SLOTS, Wc), -(-R1 // cs.ROW_BLOCK)
            plans.append(cs.ScatterPlan(True, slots, nblk, 64))
        for plan in plans:
            for _ in range(2):
                got = cs.construct_scatter(start.clone(), rows, docs, plan)
                torch.cuda.synchronize()
                require(torch.equal(got, want),
                        f"construct_scatter {what} plan {plan}: kernel != "
                        "plain")
            cases += 1

    for D in (1, 7, 8, 31, 33, 63, 1000, 1023):
        Wc = -(-D // 32)
        for case in ("random", "one_row", "edges", "empty", "dropped",
                     "odd", "two_strips", "unaligned"):
            if case == "two_strips" and Wc < 2:
                continue
            R1 = 4099
            n = {"empty": 0, "odd": 1_000_003}.get(case, 70_000)
            rows = torch.randint(0, R1, (n,), dtype=torch.int32,
                                 device=DEVICE)
            docs = torch.randint(0, D, (n,), dtype=torch.int32,
                                 device=DEVICE)
            if case == "one_row":
                rows.fill_(R1 // 2)
            elif case == "edges":
                rows = torch.where(rows % 2 == 0, 0, R1 - 1).int()
                rows[1::2], docs[1::2] = rows[::2], docs[::2]
            elif case == "dropped":
                rows[::7] = R1 + 3
                rows[1::7] = -1
                docs[2::7] = 32 * Wc
                docs[3::7] = -5
            elif case == "two_strips":  # documents 28..35 in one chunk
                docs = torch.randint(28, min(36, D), (n,),
                                     dtype=torch.int32, device=DEVICE)
            elif case == "unaligned":   # views 4 bytes past a boundary
                rows = torch.cat([rows[:1], rows])[1:]
                docs = torch.cat([docs[:1], docs])[1:]
                require(rows.data_ptr() % 16 and docs.data_ptr() % 16,
                        "the unaligned case is aligned")
            check(R1, Wc, rows, docs, f"D={D} {case}")
    R1 = (1 << 24) + 1
    for D in (63, 64):
        rows = torch.randint(0, R1, (1_000_003,), dtype=torch.int32,
                             device=DEVICE)
        rows[:4] = torch.tensor([0, R1 - 1, R1, -1])
        docs = torch.randint(0, D, rows.shape, dtype=torch.int32,
                             device=DEVICE)
        check(R1, -(-D // 32), rows, docs, f"R1={R1} D={D}")
    # the device build through many upload chunks against the CPU build
    docs_dir = ROOT / "bench_data" / "construct_edges"
    write_fasta_corpus(docs_dir, 37, 200, 3000, seed=21)
    from cobs_tpu_torch.ingest.document_list import DocumentList

    entries = DocumentList(docs_dir).list()
    sig, row_size = 10_007, -(-len(entries) // 8)
    want = device_build(entries, sig, row_size, 31, 2, 1, print,
                        device="cpu")
    for chunk in (1000, 7777, 1 << 22):
        got = device_build(entries, sig, row_size, 31, 2, 1, print,
                           device=DEVICE, chunk=chunk)
        require(np.array_equal(got, want), f"device build in chunks of "
                                           f"{chunk} != CPU build")
    shutil.rmtree(docs_dir)
    print(f"phase 10 construct_scatter: kernel == plain, and bit-equal on "
          f"a second launch, at {cases} edge shapes and plans; the device "
          f"build of "
          f"37 documents in chunks of 1,000 / 7,777 / 2^22 updates == its "
          f"CPU build")


def phase_construct_golden(torch, cs, cli_main) -> None:
    """`classic-construct` and `compact-construct` of the port's CLI on a
    copy of tests/data/fasta (no cache files), on the card: the golden
    files byte for byte."""
    src = ROOT / "bench_data" / "golden_fasta"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "tests" / "data" / "fasta", src,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    before = cs.LAUNCHES
    try:
        for kind in ("classic", "compact"):
            out = src.parent / f"golden.cobs_{kind}"
            rc = cli_main([f"{kind}-construct", str(src), str(out),
                           "--clobber"])
            require(rc == 0, f"{kind}-construct exited {rc}")
            require(out.read_bytes() == (GOLDEN_DIR / f"fasta7.cobs_{kind}")
                    .read_bytes(), f"{kind}-construct != the golden file")
            out.unlink()
    finally:
        shutil.rmtree(src)
    require(cs.LAUNCHES > before, "the golden builds did not launch the "
                                  "bit scatter kernel")
    print("phase 10 golden: classic-construct and compact-construct on the "
          "card == tests/data/golden/fasta7.cobs_{classic,compact}")


def same_file(a: Path, b: Path) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(64 << 20), fb.read(64 << 20)
            if x != y:
                return False
            if not x:
                return True


def construct_stages(text: str) -> dict:
    """Seconds per construction stage, summed over the TIMER records in
    `text` (every batch and page; records of several threads may share a
    line with other log text): the batch builds' phases, and "combine"
    from the classic combine and the compact assembly."""
    import re

    out: dict = {}
    for m in re.finditer(r"TIMER info=(\S+)((?: [^\s=]+=[-+.e\d]+)+)",
                         text):
        info = m.group(1)
        for part in m.group(2).split():
            name, _, val = part.partition("=")
            if name == "total":
                continue
            if info != "classic_construct_from_documents":
                name = "combine"
            out[name] = out.get(name, 0.0) + float(val)
    return out


def construct_timed(build, docs, out: Path, params) -> tuple[float, dict]:
    """Wall seconds of one construction and its TIMER phases (its log on
    standard error is captured)."""
    import contextlib
    import io

    from cobs_tpu_torch import DocumentList

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        build(DocumentList(docs), out, index_params=params)
    return time.perf_counter() - t0, construct_stages(err.getvalue())


def phase_construct(torch, cs, card: str, n_docs: int = CONSTRUCT_DOCS,
                    lengths=CONSTRUCT_LENGTHS) -> dict:
    """Phase 10: construction at a bacterial collection's shape; see the
    module docstring."""
    root = ROOT / "bench_data" / "construct"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    lens = write_fasta_corpus(root / "docs", n_docs, *lengths, seed=10)
    print(f"phase 10 wrote {n_docs} FASTA documents, {sum(lens)} bp, in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        return _phase_construct(torch, cs, card, root, lens)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _phase_construct(torch, cs, card, root: Path, lens) -> dict:
    import cobs_tpu_torch as ct
    from cobs_tpu_torch.construct.device import UPDATE_CHUNK
    from cobs_tpu_torch.core.params import calc_signature_size
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )
    from cobs_tpu_torch.fmt.classic import read_classic_header

    docs = root / "docs"
    k, h = 31, 1
    updates = sum(n - k + 1 for n in lens) * h
    builds = {"classic": (ct.classic_construct, ct.ClassicIndexParameters),
              "compact": (ct.compact_construct, ct.CompactIndexParameters)}
    walls, phases, launches = {}, {}, {}
    # the main path, device builds, with the count at 0 just before each
    for kind, (build, P) in builds.items():
        cs.LAUNCHES = 0
        walls[kind, "device"], phases[kind, "device"] = construct_timed(
            build, docs, root / f"device.cobs_{kind}",
            P(term_size=k, num_hashes=h, false_positive_rate=0.3))
        torch.cuda.synchronize()
        launches[kind] = cs.LAUNCHES
        require(launches[kind] > 0, f"the {kind} device build did not "
                                    "launch the bit scatter kernel")
    for kind, (build, P) in builds.items():
        before = cs.LAUNCHES
        walls[kind, "host"], phases[kind, "host"] = construct_timed(
            build, docs, root / f"host.cobs_{kind}",
            P(term_size=k, num_hashes=h, false_positive_rate=0.3,
              device_construct=False))
        require(cs.LAUNCHES == before, f"the {kind} host build launched "
                                       "the kernel")
        require(same_file(root / f"device.cobs_{kind}",
                          root / f"host.cobs_{kind}"),
                f"{kind}: the device-built file != the host-built file")
    hdr = read_classic_header(root / "device.cobs_classic")
    sig = calc_signature_size(max(lens) - k + 1, h, 0.3)
    require(hdr.signature_size == sig, f"classic signature size "
                                       f"{hdr.signature_size} != {sig}")

    # the kernel alone at the main path's shape: four full upload chunks
    # of real updates (the first documents' rows, in order, as the device
    # build stages them) into the classic batch's words
    from cobs_tpu_torch.construct.bitmatrix import doc_row_indices
    from cobs_tpu_torch.experiments import redesign_bench as rb
    from cobs_tpu_torch.ingest.document_list import DocumentList

    R1, Wc = sig + 1, -(-hdr.row_size // 4)
    rows, docs_of = [], []
    for d, entry in enumerate(DocumentList(docs).list()):
        for w in entry.term_windows(k):
            r = doc_row_indices(w, sig, h, 1)[0]
            rows.append(r.astype(np.int32))
            docs_of.append(np.full(r.size, d, dtype=np.int32))
        if sum(r.size for r in rows) >= 4 * UPDATE_CHUNK:
            break
    rows, docs_of = np.concatenate(rows), np.concatenate(docs_of)
    n = min(UPDATE_CHUNK, rows.size // 4)
    chunks = [(torch.from_numpy(rows[i * n:(i + 1) * n]).to(DEVICE),
               torch.from_numpy(docs_of[i * n:(i + 1) * n]).to(DEVICE))
              for i in range(4)]
    del rows, docs_of
    words = torch.zeros((Wc, R1), dtype=torch.int32, device=DEVICE)
    got = cs.construct_scatter(words.clone(), *chunks[0])
    want = cs.construct_scatter_reference(words.clone(), *chunks[0])
    torch.cuda.synchronize()
    require(torch.equal(got, want), "construct_scatter at the main path's "
                                    "shape: kernel != plain")
    del got, want, words
    # warm (successive launches on the same strips, as a build finds
    # them) and with the L2 flushed before each launch, each beside the
    # control (the earlier row-major kernel) in this call; its words
    # equal the kernel's transposed after both have run
    timing = rb.time_scatter(torch, cs, R1, Wc, chunks, plain=True)
    r, d = chunks[0]
    distinct = torch.unique(r.long() * Wc + (d.long() >> 5)).numel()
    nbytes = 8 * n + 2 * 4 * distinct
    bound_ms, bound_by = bound(nbytes, n)
    # R1 = 2^24 + 1 (a 64 MB strip, 2 GB of words at Wc = 32): the same
    # documents with uniform random rows from a seed, the rows a Bloom
    # filter of that size would give them
    big_R1 = (1 << 24) + 1
    g = torch.Generator(device=DEVICE)
    g.manual_seed(12)
    big = [(torch.randint(0, big_R1 - 1, (n,), generator=g,
                          dtype=torch.int32, device=DEVICE), d)
           for _, d in chunks]
    big_timing = rb.time_scatter(torch, cs, big_R1, 32, big)
    r, d = big[0]
    big_distinct = torch.unique(r.long() * 32 + (d.long() >> 5)).numel()
    big_bound_ms, _ = bound(8 * n + 8 * big_distinct, n)
    del chunks, big, r, d
    torch.cuda.empty_cache()

    # the kernel's device time inside one more classic device build, from
    # a profiler window (the ring's events also hold the host's launch
    # gaps), beside that build's event interval
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        prof_wall, prof_phases = construct_timed(
            ct.classic_construct, docs, root / "profiled.cobs_classic",
            ct.ClassicIndexParameters(term_size=k, num_hashes=h,
                                      false_positive_rate=0.3))
        torch.cuda.synchronize()
    require(same_file(root / "profiled.cobs_classic",
                      root / "device.cobs_classic"),
            "the profiled classic build != the first one")
    (root / "profiled.cobs_classic").unlink()
    # one launch of the wrapper runs scatter_or, or bin_place then bin_or
    in_build = {name: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                for name in ("scatter_or", "bin_place", "bin_or")
                if f"{name}(" in e.key}
    require(in_build, "no scatter kernel in the profiled build")
    prof_kernel_us = sum(us for us, _ in in_build.values())
    prof_count = sum(in_build.get(name, (0, 0))[1]
                     for name in ("scatter_or", "bin_place"))

    # query what was built: 64 queries of 1,030 bp cut from known
    # documents; each source document scores all 1,000 terms, and the
    # top 100 equal host scoring's on the same file
    rng = np.random.default_rng(11)
    picks = rng.choice(len(lens), CONSTRUCT_QUERIES,
                       replace=len(lens) < CONSTRUCT_QUERIES)
    queries, sources = [], []
    for i in picks.tolist():
        seq = read_fasta_sequence(docs / f"doc{i:04d}.fasta")
        o = int(rng.integers(0, len(seq) - CONSTRUCT_QUERY_LEN))
        queries.append(seq[o:o + CONSTRUCT_QUERY_LEN].decode())
        sources.append(f"doc{i:04d}")
    path = str(root / "device.cobs_classic")
    held = ct.Search(path)
    require(isinstance(held.index_files[0], ct.DeviceIndex),
            "the built classic index was not held on the card")
    got = held.search_batch(queries, 0.0, 100)
    terms = CONSTRUCT_QUERY_LEN - k + 1
    for res, src in zip(got, sources):
        hit = [r.score for r in res if r.doc_name == src]
        require(hit == [terms], f"query from {src}: source scores {hit}, "
                                f"not {terms}")
    old = ct.settings.streamed_host_score
    ct.settings.streamed_host_score = "host"
    try:
        host = ct.Search(path, streamed=True).search_batch(queries, 0.0, 100)
    finally:
        ct.settings.streamed_host_score = old
    require(pairs(got) == pairs(host), "top 100 of the device-held index "
                                       "!= streamed host scoring's")
    torch.cuda.synchronize()

    gb = hdr.signature_size * hdr.row_size / 1e9
    print(f"phase 10 construction ({card}): {len(lens)} documents, "
          f"{updates} updates (k={k}, h={h}, fpr 0.3, canonical); classic "
          f"{hdr.signature_size} rows x {hdr.row_size} B ({gb:.3f} GB), "
          f"words on the card {R1 * Wc * 4 / 1e9:.3f} GB; device and host "
          f"builds give identical classic and compact files; kernel "
          f"launches {launches}; every query scores its source document "
          f"{terms}; top 100 == streamed host scoring")
    for (kind, how), wall in walls.items():
        line = " ".join(f"{name}={sec:.3f}s"
                        for name, sec in phases[kind, how].items())
        print(f"phase 10 {kind} {how} build: {wall:.3f} s wall, "
              f"{updates / wall / 1e6:.1f} M updates/s end to end; stages "
              f"(summed over batches and pages): {line}")
    dev_kernel = phases["classic", "device"].get("device_kernel", 0.0)
    kernel_ms = timing["ms"]
    print(f"phase 10 construct_scatter at the main path's shape (Wc={Wc}, "
          f"R1={R1}, {n} updates per launch, {card}): "
          + rb.format_scatter(timing)
          + f" (control = the row-major one-atomic kernel); bound "
          f"{bound_ms:.4f} ms "
          f"({bound_by}: {nbytes} B, {distinct} distinct words), kernel "
          f"at {100 * bound_ms / kernel_ms:.1f} % of it warm and "
          f"{100 * bound_ms / timing['flushed_ms']:.1f} % flushed "
          f"({n / kernel_ms / 1e6:.2f} G updates/s warm); plain "
          f"{timing['plain_ms']:.3f} ms")
    print(f"phase 10 construct_scatter at R1={big_R1} (Wc=32, random rows, "
          f"{card}): " + rb.format_scatter(big_timing)
          + f"; bound {big_bound_ms:.4f} ms ({big_distinct} distinct "
          "words)")
    print(f"phase 10 classic build: {launches['classic']} launches, "
          f"{dev_kernel * 1e3:.1f} ms of kernel interval (CUDA events "
          f"around upload and launch; "
          f"{updates / max(dev_kernel, 1e-9) / 1e9:.2f} G updates/s); a "
          f"profiled classic build ({prof_wall:.3f} s wall): {prof_count} "
          f"kernel launches, {prof_kernel_us / 1e3:.1f} ms of kernel device "
          f"time ({prof_kernel_us / 1e3 / max(prof_count, 1):.4f} ms per "
          f"launch) against an event interval of "
          f"{prof_phases.get('device_kernel', 0.0) * 1e3:.1f} ms")
    return {"launches": launches["classic"] + launches["compact"],
            "ms": kernel_ms, "plain_ms": timing["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "control_ms": timing["control_ms"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from cobs_tpu_torch import native
    from cobs_tpu_torch.cli.main import main as cli_main
    from cobs_tpu_torch.construct.device import build_batch_matrix_device
    from cobs_tpu_torch.experiments import dma_gather_bench as bench
    from cobs_tpu_torch.experiments import gather_count_bench as gc_bench
    from cobs_tpu_torch.experiments import redesign_bench
    from cobs_tpu_torch.ops import _build
    from cobs_tpu_torch.ops import construct_scatter as cs
    from cobs_tpu_torch.ops import device_hash as dh
    from cobs_tpu_torch.ops import dma_gather as dg
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.query import engine
    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.settings import settings

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        controls = pool.submit(redesign_bench.build_controls)
        secs = _build.build()
        secs.update(controls.result())
    print(f"build of {len(secs)} sources in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name, sec in secs.items():
        print(f"build {name}.cu: {sec:.2f} s")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas: " + line.strip())
        if name not in redesign_bench.CONTROLS:
            _build.load(name)

    err = phase_mixed_shapes(torch, qk, np.random.default_rng(0))
    phase_golden(torch, qk, dh, Search)
    ref = phase_reference_scale(torch, qk, dh, engine, Search, settings,
                                card)
    torch.cuda.empty_cache()
    err = max(err, ref["err"], phase_wide_rows(torch, qk, dg, card))
    torch.cuda.empty_cache()
    hash5 = phase_hash_kernel(torch, dh, np.random.default_rng(5), card)
    phase_gather_small(torch, dg, np.random.default_rng(6))

    # K2's path, with its count at 0 just before it
    dg.LAUNCHES = 0
    sweep = bench.sweep(torch, plain=dg.dma_gather_rows_reference)
    torch.cuda.synchronize()
    k2_launches = dg.LAUNCHES
    require(k2_launches > 0, "the bandwidth sweep did not launch K2")
    for row in sweep:
        print(f"phase 7 K2 bandwidth ({card}): " + bench.format_row(row))
    k2 = sweep[0]  # W=384: the row width of phase 3

    # K1's batch sweep, with its count at 0 just before it
    qk.LAUNCHES = 0
    k1_sweep = gc_bench.sweep(torch)
    torch.cuda.synchronize()
    require(qk.LAUNCHES > 0, "the batch sweep did not launch K1")
    for row in k1_sweep:
        print(f"phase 8 K1 batch sweep ({card}): " + gc_bench.format_row(row))
    torch.cuda.empty_cache()

    phase_streamed_golden(torch, native, Search, engine.StreamedIndex,
                          settings)
    streamed = phase_streamed(torch, qk, dh, engine, native, Search,
                              settings, card)
    err = max(err, streamed["err"])
    torch.cuda.empty_cache()

    phase_construct_edges(torch, cs, build_batch_matrix_device)
    phase_construct_golden(torch, cs, cli_main)
    con = phase_construct(torch, cs, card)

    entries = {
        "gather_and_count": dict(
            launches=ref["launches"]["gather_and_count"], max_abs_err=err,
            library_ms=None,
            streamed_launches=streamed["launches"]["gather_and_count"],
            **ref["k1"]),
        "rows_from_queries": dict(
            launches=ref["launches"]["rows_from_queries"], max_abs_err=0,
            library_ms=None,
            streamed_launches=streamed["launches"]["rows_from_queries"],
            control_ms=hash5["phase 3"]["control_ms"], **ref["hash"]),
        "dma_gather_rows": dict(
            launches=k2_launches, max_abs_err=0, ms=k2["ms"],
            plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
            bound_by="bytes", library_ms=k2["library_ms"]),
        "construct_scatter": dict(max_abs_err=0, library_ms=None, **con),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **entries[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
