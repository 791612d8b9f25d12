#!/usr/bin/env python3
"""Smoke test of the cobs_tpu_torch query, construction and multi-device
paths on one CUDA card, phase 12's shards on four cards when four are
visible.

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
   `search_stream` launches each once for its two batches as one
   multi-batch group, and once per batch with `mega_batches` 1); its
   ranked results equal host hashing's, search_stream's and a numpy
   ranking of the plain scores;
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
   host scoring's;
11. serving: `python -m cobs_tpu_torch.cli.main serve` in subprocesses
   on the golden classic and compact files, held and `--streamed`
   (started together): `QueryClient` gets the reference's lines at -t 0.8
   and 0, and SIGTERM exits 0 and removes the socket. Then phase 9's
   file (written again from its seed) held on the card and served by an
   in-process `QueryServer` (top 100, floor 0, B=64, linger 2 ms,
   `warmup(1030)`): 8 client threads each pipeline 512 random 1,030 bp
   queries through `QueryClient.search_batch`, every response equal to
   `Search.search_batch`'s, with multi-batch groups dispatched and fewer
   K1 and hash launches than batches; again with `mega_batches` 1
   (identical responses, one launch per batch); at full ranking with
   floor 0.8 (half the clients at 0.52, the sub-floor path); streamed
   (device scoring, 1,024 queries, equal to the held responses); and a
   `reload` at full width, after which the responses are unchanged.
   The hash kernel and K1 equal their plain versions on the payloads
   multi-batch dispatch builds: a group of K batches for every K from 2
   to 16 (B up to 1,024 rows), one of mixed query lengths with flagged
   queries, and host-hashed rows of a group of 16.
   Prints served q/s beside `search_stream`'s on the same queries,
   latency p50/p99, batches, groups, `Timer` phases, launches per batch,
   the card's busy share while serving and the reload's seconds;
12. the document-sharded index (parallel/sharded.py) as four shards, one
   a card when four cards are visible (`make_mesh(..., [cuda:0, cuda:1,
   cuda:2, cuda:3])`), else four shards of the one card (`[cuda:0] * 4`);
   the phase prints which (`phase 12 mesh: 4 distinct cards` or `1 card x
   4 shards`), and every check below holds on either. (a) Phase 3's matrix and
   queries on a (1, 4) mesh (word_width 512, four 128-word shards) and
   on a (2, 2) one: all 1,024 queries in batches of 64 through
   `search_batch` and `search_stream` (one group), top 100 and full
   ranking, each ranking equal to the single-device `Search`'s, with one
   launch of K1 and of the hash kernel per cell per batch or group, on
   every card of the mesh (the wrappers' `LAUNCHES_ON`); on
   (2, 2), 4 queries of 70,000 bp through the sequence split (K1 per
   cell, no hash launch), full ranking and top 100. (b) K1 and the hash
   kernel against their plain versions at one cell's shapes (W=128), and
   the host merge of one batch's candidates, timed; then, exact, at every
   other shape the main path gives them: the last cell's share of a
   batch and of a search_stream group on each mesh (B=64 and 1,024 at
   W=128; B=32 and 512 at W=256), and K1 on the sequence split's term
   slice of a (2, 2) cell (B=4, about 35,000 terms, W=256), these on
   the last cell's card (cuda:3 on four cards). (c) Phase 9's file
   written again from its seed and streamed into the 4 shards from its
   mmap: rankings equal the held index's. (d) In phase 10, before its
   corpus is deleted: the classic build over 4 docs shards
   (settings.construct_mesh), byte-identical to phase 10's file, with
   the scatter launched on every card of the mesh, and the scatter on
   shards 0 and 1's words, each on its shard's card, with foreign
   updates below and past its documents through the binned plan, equal
   to its plain version; with more than one card visible, also `cobs
   classic-construct` with no mesh set (launched on every card) and the
   build on cuda:0 alone, both byte-identical to phase 10's file. (e)
   Two processes (gloo, file store), 2 shards each (cards 2r and 2r + 1
   when four are visible, else cuda:0 twice): each
   streams only its own shards of phase 9's file and scores 256 queries
   (one exchange per batch), equal to the single-device rankings; then
   `parallel.distributed.construct` and `open_federated` over a
   20-document corpus, one device and the global mesh, equal to one
   build; a failing child fails the phase. (f) `query --mesh N` and
   `serve --mesh N` (N the distinct cards: 4 or 1) give the reference's
   lines; --mesh beyond the cards exits non-zero. (g)
   `benchmark_scaling` over 1, 2 and 4 shards of the mesh's devices at
   cobs_tpu's defaults but 1,000 batches per shard count, run twice,
   with the spread of the two runs. (h) First of all, the quick-check
   entry points: `parallel.dryrun.entry()`'s step against K1's plain
   version, and `dryrun_multichip(4, devices)` (the scatter and K1 on
   8-word shards after the transpose, checked against numpy, and the
   serving surface over a (2, 2) mesh). The kernels line gives, for K1,
   the hash kernel and the scatter, `sharded_cards`: the distinct cards
   their sharded launches ran on;
13. the rest of the CLI and the cobs_index_torch shim, inside phase 10
   before its corpus is deleted, on its 1,000 documents and the classic
   and compact indexes built there on the card; the CLI runs as
   `python -m cobs_tpu_torch.cli.main` subprocesses. (a) `doctor`, (b)
   `info --scan` on both indexes and on a copy of the classic one cut
   short by 50 B, and two `generate-queries` runs, all started together:
   doctor exits 0 with DEVICE OK naming the card, NATIVE OK and all 4
   kernel sources built; info's documents, signature size and row size
   lines match the file's header and the ones ratio max is at most 0.31
   (fpr 0.3); the short copy exits 1 with `corrupt`. (c) 512 positives of
   31 bp (`-p 512 -s 31 -S 1`) through `query -f -t 1.0`: each finds the
   document named in its header, and the stdout equals, line for line,
   the same file ranked by streamed host scoring; the hash kernel and K1
   at that shape (B=512, one term, the index's 128 words) on the index
   held in this process equal their plain versions. (d) 512 positives
   padded to 1,030 bp and 512 random negatives (`-p 512 -n 512 -s 1030
   -S 2`) through `query -f -t 0 -l 100 --profile DIR`: its stdout equals,
   line for line, the same file ranked by streamed host scoring (the
   native host scorer, no kernel), and the trace in DIR holds
   gather_count_kernel and device_hash_kernel events. (e) The reference's
   Python API test through cobs_index_torch on the card, its kernel counts
   at 0 just before: DocumentList, classic_construct and
   compact_construct on a copy of tests/data/fasta give the golden files,
   and Search gives the reference's lines. Prints each step's seconds.
14. the reference paper's scale, through the port of cobs_tpu's harness
   (cobs_tpu_torch/experiments/paper_scale.py, at cobs_tpu's defaults):
   (a) `gen`: 100,000 FASTA documents of 20,000 bp (2.0 GB under
   bench_data/, deleted at the end); (b) `build`: the CLI's
   `compact-construct --memory 256MiB --clobber` on the card (the
   scatter's count at 0 just before; k=31, h=1, fpr 0.3, canonical; 98
   pages of 1,024 documents, 128 B each) and `repack` (one page of
   12,544 B), in a fresh process; prints each step's seconds,
   updates/s, the scatter launches, the page sub-indices written and
   combined, and that process's RSS as the pages are written (sampled
   every 0.2 s): from its fixed buffers in place (a quarter of the
   pages written, or one page a worker where that is later; build_rss)
   to the end of the construction its peak must grow by less than half
   the matrix bytes of the remaining pages (out of core); then
   the first subdirectory (1,000 documents, one page) at a --memory that
   cuts the page into four classic sub-indices, combined, and at 256MiB
   (one), byte-identical files; (c) `verify`:
   PLANT_SEQ at threshold 0.9 gives exactly the 11 planted documents at
   70 of 70, every other score below 0.9 x 70, on paper.cobs_compact
   held (coalesced at load: one page), held with
   COBS_TPU_COALESCE_PAGES=0 (98 pages) and streamed with host scoring
   (98 pages), and on paper_wide.cobs_compact held, all four rankings
   equal; (d) the hash kernel and K1 at this path's shapes, B=512 random
   queries of 1,000 terms, on the 98-page and the one-page index: the
   hash kernel equal to its plain version and to native host hashing, K1
   equal to its plain version, exactly, each timed beside its plain
   version and its bound; the scatter on one upload chunk of this build
   (2^22 updates of page 0's first documents) equal to its plain
   version, timed; (e) `serve`: `search_stream` held on the card, B=512,
   mega 8, threshold 0.8, top 100, 16,384 random 1,030 bp queries, two
   timed rounds after a warm-up group, K1 and hash launches counted (one
   per group of 8 batches), the card's busy share over one group from a
   profiler window, that group's rankings equal to one batch at a time,
   the hash kernel and K1 equal to their plain versions at that group's
   launch shape (rows [4,096, 1,000, 1, 1], K1 timed), the first 1,024
   responses equal to streamed host
   scoring's (hashed natively), COBS_TPU_DEVICE_HASH=host equal to device
   hashing, the host `hashes` time per batch of both, and native against
   numpy hashing at phase 3's shape (64 x 1,030 bp), hashes equal; (f)
   `serve --streamed` (device scoring) over 2,048 queries;
15. the serving soak (cobs_tpu_torch/experiments/server_soak.py, in
   process): a QueryServer on the card over the golden corpus's classic
   index for 30 s with 4 pipelining clients checking every response, a
   reload every second and a chaos client; the harness's exit rule (zero
   wrong responses, zero batch failures, zero connections left open)
   and at least 20 reloads; then 10 s more with COBS_TPU_SERVER_DEBUG=1,
   printing the scorer's six phase timers per batch;
16. the ports of cobs_tpu's remaining harnesses (cobs_tpu_torch/
   experiments/ and bench_torch.py), each printing its RESULT lines:
   (a) runcap_serve_bench: its skewed corpus (20,480 FASTA documents in
   4 size tiers, under bench_data/, deleted at the end) compact-built on
   the card (the scatter launched), then loaded capped (run-coalesced:
   page_docs set, at least two values), uncapped (another page count)
   and plain, and 4,096 random queries of 1,000 terms served by each
   (B=1,024, three rounds, -t 0.8 -l 100, K1 and hash launches counted):
   the three rank them alike at -t 0 (top 100 of each), and 256 document
   queries (64 a tier, each finding its document at all its terms, -t
   0.8) and 4 full rankings of every document alike; the first 256
   random queries, the document queries and the full rankings equal
   streamed host scoring's (native hashing, COBS_TPU_DEVICE_HASH=host);
   the hash kernel and K1 equal their plain versions on each layout's
   first served group (as many batches of 1,024 as its top-k budget
   packs: rows [4,096, 1,000, 1, P] for capped and uncapped, [3,072, ...,
   40] for plain), K1 timed there beside its bound; (b) bench_torch.py's
   measurement on the reference-default matrix, after one batch's totals
   equal plain K1's; (c) width_sweep, one round at W in {384, 1,536,
   6,144, 24,576} (2^21 x 384 words of bytes each), then K1 equal to its
   plain version on 8 queries and on the 64 it is then timed on at each
   width, beside its bound; (d)
   mega_serve_bench, one round of 64:1, 64:16 and 1024:16 over 4,096
   queries on phase 9's file written again from its seed (-t 0 -l 100),
   each config's rankings equal to search_batch's, fewer K1 launches
   than batches; (e) serve_bench on that file: 2,048 queries direct and
   from 4 client processes (B=1,024, -t 0 -l 100), every served response
   equal to search_batch's; (f) score_batch_bench at its defaults.

Prints each card's name and power limit, the build times, the times, the
wall seconds of each phase (`phase_seconds`), then a JSON line of the
kernels and, last, the device JSON line. Any failure
raises and exits non-zero; so does a machine without a CUDA card, and a
child process still running before those two lines (one left by a
failure is killed before the script exits).
"""

import concurrent.futures
import contextlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from cobs_tpu_torch.experiments.common import (
    acgt_queries,
    pairs,
    read_fasta_sequence,
    same_ranking,
    sync_all,
    write_fasta_corpus,
)

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


def live_children() -> list[int]:
    """The pids of this process's child processes that have not exited
    (/proc; a zombie has exited)."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the state and the parent's pid follow the name's ")"
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if int(ppid) == me and state != "Z":
            out.append(int(d))
    return out


def stop_children() -> list[int]:
    """Kill and reap every child process still running; their pids."""
    pids = live_children()
    for pid in pids:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    for pid in pids:
        with contextlib.suppress(OSError):
            os.waitpid(pid, 0)
    return pids


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


#: wall seconds per phase ("build" = the kernels' build), printed on the
#: phase_seconds line
PHASE_SECONDS: dict = {}
_PHASE_STACK: list = []


@contextlib.contextmanager
def phase_clock(phase):
    """Adds the block's wall seconds to PHASE_SECONDS[phase], less the
    seconds of phases timed inside it (phases 12 (d) and 13 run inside
    phase 10)."""
    t0 = time.perf_counter()
    _PHASE_STACK.append(0.0)
    try:
        yield
    finally:
        inner = _PHASE_STACK.pop()
        dt = time.perf_counter() - t0
        PHASE_SECONDS[phase] = PHASE_SECONDS.get(phase, 0.0) + dt - inner
        if _PHASE_STACK:
            _PHASE_STACK[-1] += dt


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


def device_busy_us(torch, fn, want: dict | None = None) -> tuple:
    """Device time (us) of fn() from a CUDA-only torch.profiler window:
    the sum of the device-side events (kernels and copies), and the five
    largest by name. With `want`, each kernel named there must appear
    exactly that many times, in two tries (a long-lived process's later
    windows have come back without the ctypes-launched kernels); else
    (None, the kernel counts seen)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(1 if want is None else 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        seen = want and {name: sum(e.count for e in events if name in e.key)
                         for name in want}
        if seen == want:
            per = sorted(((e.self_device_time_total, e.key)
                          for e in events), reverse=True)
            return sum(us for us, _ in per), per[:5]
    return None, seen


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
    # search_stream over 2 batches: one multi-batch group by default
    # (settings.mega_batches), one dispatch per batch with it at 1
    mega = settings.mega_batches
    for groups, want_launches in ((mega, 1), (1, 2)):
        settings.mega_batches = groups
        try:
            qk.LAUNCHES = dh.LAUNCHES = 0
            streamed = list(s.search_stream(queries, 0.0, k,
                                            batch_size=B // 2))
        finally:
            settings.mega_batches = mega
        require(qk.LAUNCHES == dh.LAUNCHES == want_launches,
                f"search_stream over 2 batches, mega_batches={groups}, "
                f"launched K1 {qk.LAUNCHES} and the hash kernel "
                f"{dh.LAUNCHES} times")
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
    from cobs_tpu_torch.ingest.document_list import DocumentList

    docs_dir = ROOT / "bench_data" / "construct_edges"
    write_fasta_corpus(docs_dir, 37, 200, 3000, seed=21)

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


def phase_construct(torch, cs, qk, dh, card: str,
                    n_docs: int = CONSTRUCT_DOCS,
                    lengths=CONSTRUCT_LENGTHS) -> dict:
    """Phase 10: construction at a bacterial collection's shape, then
    phase 13 on its corpus and indexes; see the module docstring."""
    root = ROOT / "bench_data" / "construct"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    lens = write_fasta_corpus(root / "docs", n_docs, *lengths, seed=10)
    print(f"phase 10 wrote {n_docs} FASTA documents, {sum(lens)} bp, in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        con = _phase_construct(torch, cs, card, root, lens)
        with phase_clock(13):
            con["cli"] = phase_cli(torch, qk, dh, cs, card, root)
        return con
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
    with phase_clock(12):
        sharded = phase_construct_sharded(torch, cs, card, root, k, h,
                                          walls["classic", "device"])
    return {"launches": launches["classic"] + launches["compact"],
            "ms": kernel_ms, "plain_ms": timing["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "control_ms": timing["control_ms"], "sharded": sharded}


#: phase 13's generated queries: (c) CLI_QUERIES positives of one term;
#: (d) as many positives padded to CLI_QUERY_LEN with random bases and as
#: many random negatives
CLI_QUERIES, CLI_QUERY_LEN = 512, 1030


def run_cli(args) -> tuple:
    """(process, wall seconds) of `python -m cobs_tpu_torch.cli.main
    ARGS` run from the checkout's root, output captured."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cobs_tpu_torch.cli.main", *map(str, args)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    return proc, time.perf_counter() - t0


def cli_ok(proc, what: str) -> str:
    require(proc.returncode == 0, f"phase 13 {what}: exit {proc.returncode}"
                                  f"\n{proc.stdout[-2000:]}"
                                  f"\n{proc.stderr[-2000:]}")
    return proc.stdout


def cli_blocks(lines: list) -> list:
    """[(comment, [(doc, score), ...]), ...] of `query -f` output lines."""
    out, i = [], 0
    while i < len(lines):
        comment, count = lines[i].rsplit("\t", 1)
        res = [tuple(x.split("\t")) for x in lines[i + 1:i + 1 + int(count)]]
        out.append((comment, [(d, int(s)) for d, s in res]))
        i += 1 + int(count)
    return out


def host_lines(ct, path: Path, comments: list, queries: list,
               threshold: float, limit: int) -> list:
    """The lines `query -f` prints for these queries, ranked by the
    native host scorer (`Search(path, streamed=True)` under
    streamed_host_score "host"), which launches neither kernel."""
    old = ct.settings.streamed_host_score
    ct.settings.streamed_host_score = "host"
    try:
        results = ct.Search(str(path), streamed=True).search_batch(
            queries, threshold, limit)
    finally:
        ct.settings.streamed_host_score = old
    lines = []
    for comment, res in zip(comments, results):
        lines.append(f"{comment}\t{len(res)}")
        lines.extend(f"{r.doc_name}\t{r.score}" for r in res)
    return lines


def phase_cli(torch, qk, dh, cs, card: str, root: Path) -> dict:
    """Phase 13, on phase 10's corpus and indexes before they are deleted:
    the CLI in subprocesses and the cobs_index_torch shim in this process;
    see the module docstring."""
    import json

    import cobs_index_torch as cobs
    import cobs_tpu_torch as ct
    from cobs_tpu_torch.cli.main import PROFILE_TRACE, _read_fasta_queries
    from cobs_tpu_torch.fmt.classic import read_classic_header
    from cobs_tpu_torch.ops import _build
    from cobs_tpu_torch.query import engine

    t_phase = time.perf_counter()
    docs, work = root / "docs", root / "cli"
    work.mkdir()
    classic = root / "device.cobs_classic"
    compact = root / "device.cobs_compact"
    trunc = work / "trunc.cobs_classic"
    shutil.copyfile(classic, trunc)
    os.truncate(trunc, trunc.stat().st_size - 50)
    q1, q2, trace_dir = work / "q1.fa", work / "q2.fa", work / "profile"
    # (a), (b) and the two generate-queries runs, all started together
    jobs = {
        "doctor": ["doctor", "--timeout", "300"],
        "info classic": ["info", classic, "--scan"],
        "info compact": ["info", compact, "--scan"],
        "info truncated": ["info", trunc, "--scan"],
        "generate-queries q1": ["generate-queries", docs, "-p", CLI_QUERIES,
                                "-s", 31, "-S", 1, "-o", q1],
        "generate-queries q2": ["generate-queries", docs, "-p", CLI_QUERIES,
                                "-n", CLI_QUERIES, "-s", CLI_QUERY_LEN,
                                "-S", 2, "-o", q2],
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(run_cli, args)
                   for name, args in jobs.items()}
        done = {name: f.result() for name, f in futures.items()}
    secs = {name: wall for name, (_, wall) in done.items()}

    out = cli_ok(done["doctor"][0], "doctor").splitlines()
    name = torch.cuda.get_device_name(0)
    n_src = len(_build.SOURCES)
    require(any(x.startswith("DEVICE OK: ") and f"x {name} (cuda)" in x
                for x in out), f"phase 13 doctor: no DEVICE OK for {name}")
    require(any(x.startswith("NATIVE OK") for x in out),
            "phase 13 doctor: no NATIVE OK")
    kernels = [x for x in out if x.startswith("KERNELS: ")]
    require(len(kernels) == 1 and f"; {n_src} of {n_src} sources built"
            in kernels[0], f"phase 13 doctor: {kernels}")
    doctor_lines = [x for x in out if x.startswith(("DEVICE", "IO_URING"))]

    hdr = read_classic_header(classic)
    info = cli_ok(done["info classic"][0], "info classic").splitlines()
    for want in (f"documents       {len(hdr.file_names)}",
                 f"signature size  {hdr.signature_size} bits",
                 f"row size        {hdr.row_size} B "):
        require(any(x.startswith(want) for x in info),
                f"phase 13 info classic: no line {want!r}")
    ratio = [x for x in info if x.startswith("ones ratio")]
    classic_max = float(ratio[0].split()[-1])
    info = cli_ok(done["info compact"][0], "info compact").splitlines()
    compact_max = float([x for x in info
                         if x.startswith("ones ratio")][0].split()[-1])
    require(0 < classic_max <= 0.31 and 0 < compact_max <= 0.31,
            f"phase 13 info: ones ratio max {classic_max}, {compact_max} "
            "over fpr 0.3")
    bad = done["info truncated"][0]
    require(bad.returncode == 1 and "corrupt classic index" in bad.stderr,
            f"phase 13 info on a truncated file: exit {bad.returncode}, "
            f"{bad.stderr[-500:]}")
    trunc.unlink()
    for q in ("q1", "q2"):
        cli_ok(done[f"generate-queries {q}"][0], f"generate-queries {q}")

    # (c) every positive finds its source document at -t 1.0 (K1 at T=1),
    # and stdout == the native host scorer's ranking of the same file
    proc, secs["query q1"] = run_cli(["query", "-i", classic, "-f", q1,
                                      "-t", "1.0"])
    out = cli_ok(proc, "query q1").splitlines()
    got = cli_blocks(out)
    require(len(got) == CLI_QUERIES, f"phase 13 query q1: {len(got)} "
                                     "results")
    for comment, res in got:
        # comment: *doc:<doc id>:term:<pos>:<document name>
        src = comment.split(":")[-1]
        require(comment.startswith("*doc:") and (src, 1) in res,
                f"phase 13 query q1: {comment} did not find {src}")
    q1_comments, q1_queries = _read_fasta_queries(q1)
    t0 = time.perf_counter()
    require(out == host_lines(ct, classic, q1_comments, q1_queries, 1.0, 0),
            "phase 13 query q1: stdout != host scoring's ranking")
    secs["host scoring of q1"] = time.perf_counter() - t0
    # ... and K1 and the hash kernel at q1's shape on the held index,
    # against their plain versions
    t0 = time.perf_counter()
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    ix = ct.Search(str(classic)).index_files[0]
    require(isinstance(ix, engine.DeviceIndex),
            "phase 13: the classic index was not held on the card")
    qdata, qlens = engine._device_hash_args(
        ix, engine.QueryBytes([q.encode() for q in q1_queries]))
    hash_args = (qdata, qlens, ix.term_size, ix.num_hashes, ix.canonicalize,
                 *ix.page_tables[:2], ix.zero_row, ix.page_tables[2])
    rows = dh.rows_from_queries(*hash_args)
    require(torch.equal(rows, dh.rows_from_queries_reference(*hash_args)),
            "phase 13 q1: hash kernel != plain")
    got_k1 = qk.gather_and_count(ix.matrix, rows, ix.num_hashes)
    want_k1 = qk.gather_and_count_reference(ix.matrix, rows, ix.num_hashes)
    q1_shape = (f"B={rows.shape[0]}, T={rows.shape[1]}, "
                f"W={ix.matrix.shape[1]}, "
                f"{qk.plan_gather_count(*rows.shape, ix.matrix.shape[1], sm)}")
    require(torch.equal(got_k1, want_k1), f"phase 13 q1: K1 != plain "
                                          f"({q1_shape}), "
                                          f"{max_err(got_k1, want_k1)}")
    torch.cuda.synchronize()
    del ix, qdata, qlens, rows, got_k1, want_k1
    torch.cuda.empty_cache()
    secs["q1 kernels against plain"] = time.perf_counter() - t0

    # (d) the full-width query file under the profiler: stdout == the
    # native host scorer's ranking (streamed, no kernel) on the same file
    proc, secs["query q2 --profile"] = run_cli(
        ["query", "-i", classic, "-f", q2, "-t", "0", "-l", 100,
         "--profile", trace_dir])
    got = cli_ok(proc, "query q2 --profile").splitlines()
    comments, queries = _read_fasta_queries(q2)
    require(len(queries) == 2 * CLI_QUERIES and all(
        len(q) == CLI_QUERY_LEN for q in queries),
        "phase 13 generate-queries q2: wrong queries")
    t0 = time.perf_counter()
    require(got == host_lines(ct, classic, comments, queries, 0.0, 100),
            "phase 13 query q2: stdout != host scoring's ranking")
    secs["host scoring of q2"] = time.perf_counter() - t0
    pos = sum(c.startswith("*doc:") for c in comments)
    trace = json.loads((trace_dir / PROFILE_TRACE).read_text())
    in_trace = {k: sum(1 for e in trace["traceEvents"]
                       if e.get("cat") == "kernel" and k in e.get("name", ""))
                for k in ("gather_count_kernel", "device_hash_kernel")}
    require(all(in_trace.values()), f"phase 13 trace: kernels {in_trace}")

    # (e) the reference's Python API test through cobs_index_torch on the
    # card, its kernels counted from 0
    t0 = time.perf_counter()
    fasta = work / "fasta"
    shutil.copytree(ROOT / "tests" / "data" / "fasta", fasta,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    old = ct.settings.disable_cache
    qk.LAUNCHES = dh.LAUNCHES = cs.LAUNCHES = 0
    try:
        cobs.disable_cache()
        require(cobs.DocumentList(fasta).size() == 7, "phase 13 shim: "
                                                      "DocumentList")
        for kind in ("classic", "compact"):
            p = getattr(cobs, f"{kind.capitalize()}IndexParameters")()
            p.clobber = True
            out_file = work / f"python_test.cobs_{kind}"
            getattr(cobs, f"{kind}_construct")(
                input=str(fasta), out_file=out_file, index_params=p)
            r = cobs.Search(str(out_file)).search(GOLDEN_QUERY)
            require(pairs([r]) == [GOLDEN_LINES], f"phase 13 shim {kind}: "
                                                  f"{pairs([r])}")
            require(out_file.read_bytes() == (
                GOLDEN_DIR / f"fasta7.cobs_{kind}").read_bytes(),
                f"phase 13 shim {kind}: file != the golden file")
        torch.cuda.synchronize()
    finally:
        ct.settings.disable_cache = old
    shim = {"gather_and_count": qk.LAUNCHES, "rows_from_queries": dh.LAUNCHES,
            "construct_scatter": cs.LAUNCHES}
    require(all(shim.values()), f"phase 13 shim: launches {shim}")
    secs["shim"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    secs["phase"] = time.perf_counter() - t_phase

    print(f"phase 13 doctor ({card}): " + "; ".join(doctor_lines)
          + f"; {kernels[0]}")
    print(f"phase 13 info --scan: classic ones ratio max {classic_max:.6f}, "
          f"compact max over pages {compact_max:.6f} (fpr 0.3); header "
          "lines match the file; truncated by 50 B: exit 1, corrupt")
    print(f"phase 13 generate-queries over {len(hdr.file_names)} documents: "
          f"q1 {CLI_QUERIES} positives of 31 bp in "
          f"{secs['generate-queries q1']:.2f} s; q2 {pos} positives padded "
          f"to {CLI_QUERY_LEN} bp + {len(queries) - pos} negatives in "
          f"{secs['generate-queries q2']:.2f} s (run together with doctor "
          "and info)")
    print(f"phase 13 query -f q1 -t 1.0: every one of {CLI_QUERIES} "
          f"positives found its source document, stdout == streamed host "
          f"scoring's; K1 and the hash kernel == plain at q1's shape "
          f"({q1_shape}); query -f q2 -t 0 -l 100 "
          f"--profile: {len(queries)} queries, stdout == streamed host "
          f"scoring's; trace: {in_trace['gather_count_kernel']} "
          f"gather_count_kernel, {in_trace['device_hash_kernel']} "
          "device_hash_kernel events")
    print(f"phase 13 cobs_index_torch on the card: the reference's API test "
          f"(DocumentList, classic_construct, compact_construct, Search) "
          f"gives the golden lines and files; launches {shim}")
    print(f"phase 13 seconds ({card}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return {"shim": shim, "trace": in_trace, "secs": secs}


def sock_dir() -> Path:
    """A new directory for phase 11's Unix sockets (under TMPDIR: a
    socket path must stay under 108 bytes)."""
    import tempfile

    return Path(tempfile.mkdtemp(prefix="cobs_p11_"))


def wait_for(path: Path, proc, seconds: float) -> None:
    deadline = time.monotonic() + seconds
    while not path.exists():
        require(proc.poll() is None, f"serve for {path.name} exited "
                                     f"{proc.returncode} before serving")
        require(time.monotonic() < deadline, f"{path.name} never appeared")
        time.sleep(0.05)


def phase_serve_cli(QueryClient) -> None:
    """Phase 11 (a): `cobs serve` subprocesses on the golden files, held
    and streamed, all started together."""
    d = sock_dir()
    procs = {}
    t0 = time.perf_counter()
    try:
        for kind in ("classic", "compact"):
            for streamed in (False, True):
                name = f"{kind}{'_st' if streamed else ''}"
                sock = d / f"{name}.sock"
                sock.unlink(missing_ok=True)
                log = open(d / f"{name}.log", "wb")
                procs[name] = (sock, log, subprocess.Popen(
                    [sys.executable, "-m", "cobs_tpu_torch.cli.main",
                     "serve", "-i", str(GOLDEN_DIR / f"fasta7.cobs_{kind}"),
                     "--socket", str(sock), "-t", "0", "--linger-ms", "1"]
                    + (["--streamed"] if streamed else []),
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        for name, (sock, log, proc) in procs.items():
            wait_for(sock, proc, 300)
        ready_s = time.perf_counter() - t0
        for name, (sock, log, proc) in procs.items():
            with QueryClient(str(sock), timeout=60) as c:
                got = pairs([c.search(GOLDEN_QUERY, threshold=0.8),
                             c.search(GOLDEN_QUERY, threshold=0.0)])
                require(got == [GOLDEN_LINES[:1], GOLDEN_LINES],
                        f"serve {name}: {got}")
            proc.terminate()
            rc = proc.wait(timeout=60)
            require(rc == 0, f"serve {name}: SIGTERM gave rc {rc}")
            require(not sock.exists(), f"serve {name} left its socket")
    except BaseException:
        for name, (sock, log, proc) in procs.items():
            log.flush()
            tail = (d / f"{name}.log").read_bytes()[-2000:]
            print(f"phase 11 serve {name} log: "
                  f"{tail.decode(errors='replace')}", file=sys.stderr)
        raise
    finally:
        for sock, log, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            log.close()
        shutil.rmtree(d, ignore_errors=True)
    print(f"phase 11 cobs serve (subprocesses, golden classic and compact, "
          f"held and --streamed): all four serving {ready_s:.1f} s after "
          "start; QueryClient got the reference's lines at -t 0.8 and 0; "
          "SIGTERM gave rc 0 and removed each socket")


def served_load(QueryClient, srv, chunks, threshold=None) -> tuple:
    """One client thread per chunk, each pipelining its queries through
    QueryClient.search_batch; `threshold` is one value or one per chunk.
    Returns (wall seconds from the first send to the last response, the
    responses in query order)."""
    import threading

    n = len(chunks)
    thr = threshold if isinstance(threshold, list) else [threshold] * n
    out, errors = [None] * n, []
    go = threading.Barrier(n + 1)

    def client(i):
        try:
            with QueryClient(srv.address, timeout=120) as c:
                c.ping()
                go.wait()
                out[i] = c.search_batch(chunks[i], threshold=thr[i],
                                        strict=True)
        except BaseException as e:  # raised below
            errors.append(e)
            go.abort()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    require(not errors, f"a client failed: {errors[:1]!r}")
    require(not any(t.is_alive() for t in threads), "a client hung")
    return wall, [rl for part in out for rl in part]


def same_pairs(got, want) -> bool:
    """Client SearchResult lists equal embedded ResultLists."""
    return pairs(got) == pairs(want)


def group_payload(engine, s, batches) -> tuple:
    """(the payload multi-batch dispatch uploads for `batches`: the
    engine._concat_payloads of their `_hash_batch_lenient` payloads, the
    queries flagged) on s's first index."""
    from cobs_tpu_torch.utils.timer import Timer

    out, flagged = [], 0
    for batch in batches:
        hashed, errors = s._hash_batch_lenient(batch, Timer())
        out.append(hashed[0])
        flagged += sum(e is not None for e in errors)
    return engine._concat_payloads(s.index_files[0], out), flagged


def k1_exact(torch, qk, ix, rows, what: str) -> None:
    """K1 against its plain version, exact, on ix's matrix."""
    got = qk.gather_and_count(ix.matrix, rows, ix.num_hashes)
    want = qk.gather_and_count_reference(ix.matrix, rows, ix.num_hashes)
    require(torch.equal(got, want),
            f"{what}: K1 != plain, max error {max_err(got, want)}")


def device_hash_args(engine, ix, cat) -> tuple:
    """The hash kernel's arguments for a payload `cat` hashed on the card
    over index ix."""
    qdata, qlens = engine._device_hash_args(ix, cat)
    sig, off, mag = ix.page_tables
    return (qdata, qlens, ix.term_size, ix.num_hashes, ix.canonicalize,
            sig, off, ix.zero_row, mag)


def group_kernels_exact(torch, qk, dh, engine, ix, cat, what: str):
    """The hash kernel and K1 against their plain versions, exact, on a
    group payload `cat` hashed on the card; returns the rows."""
    require(isinstance(cat, engine.QueryBytes),
            f"{what}: the payload was not hashed on the card")
    args = device_hash_args(engine, ix, cat)
    rows = dh.rows_from_queries(*args)
    what = f"{what} (B={len(cat)}, L={args[0].shape[1]})"
    require(torch.equal(rows, dh.rows_from_queries_reference(*args)),
            f"{what}: hash kernel != plain")
    k1_exact(torch, qk, ix, rows, what)
    return rows


def group_kernels(torch, qk, dh, engine, s, settings, queries,
                  B: int) -> int:
    """The hash kernel and K1 against their plain versions, exact, on the
    payloads multi-batch dispatch builds (group_payload): a group of K
    batches for every K from 2 to the ceiling (B = K * 64 rows), one
    group of four batches of mixed query lengths (rows padded to the
    longest, a too-short and a non-ACGT query flagged to length 0), and
    K1 on the host-hashed rows of the largest group. Returns the groups
    checked."""
    ix = s.index_files[0]
    rng = np.random.default_rng(12)
    mixed = [[q[:n] for q, n in zip(queries[i * B:(i + 1) * B],
                                    rng.integers(31, 200 * (i + 1) + 31, B))]
             for i in range(4)]
    mixed[1][1] = "ACGT"
    mixed[2][3] = mixed[2][3][:40] + "N" + mixed[2][3][41:]
    mega = s._mega_k_capped(B, 100)
    groups = [[queries[i * B:(i + 1) * B] for i in range(K)]
              for K in range(2, mega + 1)] + [mixed]

    def payload(group):
        cat, flagged = group_payload(
            engine, s, [[q.encode() for q in batch] for batch in group])
        require(flagged == (2 if group is mixed else 0),
                f"phase 11 groups: {flagged} queries flagged")
        return cat

    for group in groups:
        group_kernels_exact(torch, qk, dh, engine, ix, payload(group),
                            f"phase 11 groups, K={len(group)}")
    settings.device_hash = "host"
    try:
        cat = payload(groups[-2])
    finally:
        settings.device_hash = "auto"
    k1_exact(torch, qk, ix, engine._rows_tensor(ix, cat),
             f"phase 11 groups, host hashes, B={len(cat)}")
    torch.cuda.synchronize()
    return len(groups) + 1


def phase_serve(torch, qk, dh, engine, Search, QueryServer, QueryClient,
                settings, card: str, rows: int = 1 << 21,
                conns: int = 8, per_conn: int = 512) -> dict:
    """Phase 11 (b): phase 9's file held on the card and served in
    process; see the module docstring."""
    docs, L, k, B = 10_000, 1030, 100, 64
    path = ROOT / "bench_data" / "phase9_reference.cobs_classic"
    t0 = time.perf_counter()
    size = write_classic_index(path, rows, docs, seed=9)
    print(f"phase 11 wrote {path.name} again from phase 9's seed: {size} "
          f"bytes in {time.perf_counter() - t0:.1f} s")
    d = sock_dir()
    try:
        return _phase_serve(torch, qk, dh, engine, Search, QueryServer,
                            QueryClient, settings, card, path, d, docs, L,
                            k, B, conns, per_conn)
    finally:
        path.unlink(missing_ok=True)
        shutil.rmtree(d, ignore_errors=True)


def _phase_serve(torch, qk, dh, engine, Search, QueryServer, QueryClient,
                 settings, card, path, d, docs, L, k, B, conns,
                 per_conn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_q = conns * per_conn
    queries = acgt_queries(np.random.default_rng(11), n_q, L)
    chunks = [queries[i * per_conn:(i + 1) * per_conn] for i in range(conns)]
    t0 = time.perf_counter()
    s = Search(str(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(isinstance(s.index_files[0], engine.DeviceIndex),
            "phase 11: the index was not held on the card")
    require(settings.mega_batches == 16 and s._mega_k_capped(B, k) == 16,
            f"phase 11: multi-batch ceiling {s._mega_k_capped(B, k)}")
    # the embedded answers, batch by batch, and search_stream on the
    # same queries (its q/s beside the served q/s)
    want = [rl for i in range(0, n_q, B)
            for rl in s.search_batch(queries[i:i + B], 0.0, k)]
    list(s.search_stream(queries[:2 * B], 0.0, k, batch_size=B))
    t0 = time.perf_counter()
    streamed = list(s.search_stream(queries, 0.0, k, batch_size=B))
    stream_qps = n_q / (time.perf_counter() - t0)
    require(same_ranking(streamed, want), "phase 11: search_stream != "
                                          "search_batch")

    def server(search=s, **kw):
        srv = QueryServer(search, **{
            "unix_path": str(d / "full.sock"), "batch_size": B,
            "linger_ms": 2.0, "threshold": 0.0, "num_results": k, **kw})
        srv.warmup(L)
        torch.cuda.synchronize()
        return srv

    def stats(srv):
        with QueryClient(srv.address, timeout=60) as c:
            return c.stats()

    runs = {}
    for mode, groups in (("mega on", settings.mega_batches), ("mega off", 1)):
        mega = settings.mega_batches
        settings.mega_batches = groups
        try:
            srv = server()
        finally:
            settings.mega_batches = mega
        with srv:
            s.timer_.reset()
            # the served path, with the counts at 0 just before it
            qk.LAUNCHES = dh.LAUNCHES = 0
            wall, got = served_load(QueryClient, srv, chunks)
            torch.cuda.synchronize()
            launches = (qk.LAUNCHES, dh.LAUNCHES)
            st = stats(srv)
            phases = timer_line(s.timer_, st["batches"])
            busy = None
            if mode == "mega on":
                # the card's busy share over one more served load (the
                # profiler records device activity only)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    busy_wall, again = served_load(QueryClient, srv, chunks)
                    torch.cuda.synchronize()
                busy_us = sum(e.self_device_time_total
                              for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA)
                busy = (busy_us / 1e6 / busy_wall, busy_wall)
                require(same_pairs(again, want),
                        "phase 11: the profiled load's responses differ")
        require(same_pairs(got, want), f"phase 11 {mode}: a served response "
                                       "!= Search.search_batch's")
        require(st["queries"] == n_q and st["batch_failures"] == 0
                and st["overflowed_connections"] == 0, f"phase 11 {mode}: "
                                                        f"stats {st}")
        require(min(launches) > 0, f"phase 11 {mode}: served load launched "
                                   f"K1 and the hash kernel {launches}")
        runs[mode] = dict(wall=wall, launches=launches, stats=st,
                          phases=phases, busy=busy)
    on, off = runs["mega on"], runs["mega off"]
    require(on["stats"]["mega_dispatches"] > 0,
            "phase 11: no multi-batch group was dispatched")
    require(max(on["launches"]) < on["stats"]["batches"],
            f"phase 11: {on['launches']} launches for "
            f"{on['stats']['batches']} batches with multi-batch dispatch")
    require(off["stats"]["mega_dispatches"] == 0
            and off["launches"] == (off["stats"]["batches"],) * 2,
            f"phase 11 mega off: {off['launches']} launches for "
            f"{off['stats']['batches']} batches")
    # the kernels at the group shapes the served path gives them, after
    # its counts were read
    t0 = time.perf_counter()
    n_groups = group_kernels(torch, qk, dh, engine, s, settings, queries, B)
    groups_s = time.perf_counter() - t0

    # full ranking at floor 0.8, half the clients at 0.52 (the sub-floor
    # slow path re-ranks their batches)
    n_full = conns * 128
    full_chunks = [c[:128] for c in chunks]
    thr = [0.8] * (conns // 2) + [0.52] * (conns - conns // 2)
    full_want = [rl for c, t in zip(full_chunks, thr)
                 for i in range(0, len(c), B)
                 for rl in s.search_batch(c[i:i + B], t, 0)]
    with server(threshold=0.8, num_results=0) as srv:
        full_wall, got = served_load(QueryClient, srv, full_chunks, thr)
        full_st = stats(srv)
    require(same_pairs(got, full_want), "phase 11 full ranking: a served "
                                        "response != Search.search_batch's")
    require(full_st["subfloor_batches"] > 0, "phase 11: no sub-floor batch")
    full_hits = sum(len(rl) for rl in full_want) / n_full

    # streamed (device scoring), one dispatch per batch
    s_st = Search(str(path), streamed=True)
    require(isinstance(s_st.index_files[0], engine.StreamedIndex)
            and not s_st.index_files[0].scores_on_host(),
            "phase 11: not a device-scored StreamedIndex")
    st_chunks = [c[:128] for c in chunks]
    with server(search=s_st) as srv:
        require(srv._mega == 1, "phase 11: a streamed server packs groups")
        st_wall, got = served_load(QueryClient, srv, st_chunks)
        st_st = stats(srv)
    require(same_pairs(got, [rl for c in range(conns)
                             for rl in want[c * per_conn:c * per_conn + 128]]),
            "phase 11 streamed: a served response != the held path's")
    del s_st

    # reload at full width: the old set serves until the new one is built
    def factory(paths=None):
        return Search(list(paths) if paths else [str(path)])

    with server(search_factory=factory) as srv:
        with QueryClient(srv.address, timeout=300) as c:
            t0 = time.perf_counter()
            info = c.reload()
            reload_s = time.perf_counter() - t0
        require(info == {"documents": docs, "indices": 1},
                f"phase 11 reload: {info}")
        require(srv.search is not s, "phase 11: reload kept the old set")
        _, got = served_load(QueryClient, srv, chunks[:1])
    require(same_pairs(got, want[:per_conn]),
            "phase 11: responses after the reload differ")
    torch.cuda.synchronize()

    print(f"phase 11 served reference scale ({docs} documents, "
          f"{s.index_files[0].zero_row}+1 rows held on the card, B={B}, top "
          f"{k}, {conns} clients x {per_conn} "
          f"pipelined 1,030 bp queries, {card}): index load {load_s:.2f} s; "
          "every response == Search.search_batch's")
    for mode, r in runs.items():
        st = r["stats"]
        print(f"phase 11 {mode}: {n_q / r['wall']:.0f} q/s served; "
              f"latency p50 {st.get('lat_p50_ms')} ms, p99 "
              f"{st.get('lat_p99_ms')} ms; {st['batches']} batches, "
              f"{st['mega_dispatches']} multi-batch groups; K1 "
              f"{r['launches'][0]} and hash {r['launches'][1]} launches "
              f"({r['launches'][0] / st['batches']:.3f} per batch); per "
              f"batch: {r['phases']}")
    busy, busy_wall = on["busy"]
    print(f"phase 11 search_stream on the same queries: {stream_qps:.0f} "
          f"q/s; profiled served load (mega on): {n_q / busy_wall:.0f} q/s, "
          f"card {100 * busy:.1f} % busy")
    print(f"phase 11 hash kernel and K1 == plain on {n_groups} concatenated "
          f"group payloads (K = 2-{s._mega_k_capped(B, k)} batches of {B}, "
          f"one of mixed lengths with two flagged queries, one host-hashed) "
          f"in {groups_s:.1f} s")
    print(f"phase 11 full ranking, floor 0.8 (half the clients at 0.52): "
          f"{n_full / full_wall:.0f} q/s served, {full_hits:.0f} results "
          f"per query on average, {full_st['batches']} batches, "
          f"{full_st['subfloor_batches']} sub-floor, "
          f"{full_st['mega_dispatches']} groups; p50 "
          f"{full_st.get('lat_p50_ms')} ms, p99 {full_st.get('lat_p99_ms')} "
          "ms; every response == Search.search_batch's")
    print(f"phase 11 streamed (device scoring): {n_full / st_wall:.0f} q/s "
          f"served over {conns * 128} queries, {st_st['batches']} batches, "
          f"{st_st['mega_dispatches']} groups; p50 {st_st.get('lat_p50_ms')} "
          f"ms, p99 {st_st.get('lat_p99_ms')} ms; responses == the held "
          "path's")
    print(f"phase 11 reload at full width: {reload_s:.2f} s (the card held "
          "both sets meanwhile); responses after it unchanged")
    return {"launches": on["launches"], "batches": on["stats"]["batches"]}


#: phase 12's shards: one card each when that many are visible, else
#: all on cuda:0
SHARDS = 4
#: batches per shard count in each of phase 12's two benchmark_scaling
#: runs: about a second of scoring at 4 shards (cobs_tpu's default of 10
#: took some 10 ms, too short to tell its runs apart)
SCALING_ITERS = 1000


def mesh_cards(torch, n: int) -> list:
    """n devices for a mesh: cards 0 .. n - 1 when n cards are visible,
    else cuda:0 n times (shards that share the one card)."""
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def cards_line(devices) -> str:
    """How a mesh's devices sit on cards: "4 distinct cards" or "1 card x
    4 shards"."""
    distinct = len(set(devices))
    if distinct == len(devices):
        return f"{distinct} distinct cards"
    return (f"{distinct} {'card' if distinct == 1 else 'cards'} x "
            f"{len(devices) // distinct} shards")


def announce_mesh(torch) -> list:
    """Phase 12's SHARDS devices, printed as the phase's mesh line."""
    cards = mesh_cards(torch, SHARDS)
    print(f"phase 12 mesh: {cards_line(cards)}")
    return cards


def phase_construct_sharded(torch, cs, card: str, root: Path, k: int,
                            h: int, single_wall: float) -> dict:
    """Phase 12 (d), on phase 10's corpus before it is deleted: the
    classic build with settings.construct_mesh = 4 docs shards (one a
    card when four are visible), byte-identical to phase 10's file; then
    the scatter on shards 0 and 1's words, each on its shard's card, with
    foreign updates below and past its documents, through the binned
    plan, against its plain version. With more than one card visible,
    also `cobs classic-construct` with no mesh set (the default shards
    over every card) and the build on one card (construct_mesh of
    cuda:0), both byte-identical to phase 10's file."""
    import cobs_tpu_torch as ct
    from cobs_tpu_torch.construct.bitmatrix import doc_row_indices
    from cobs_tpu_torch.construct.device import UPDATE_CHUNK
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )
    from cobs_tpu_torch.fmt.classic import read_classic_header
    from cobs_tpu_torch.ingest.document_list import DocumentList
    from cobs_tpu_torch.parallel.sharded import make_mesh

    docs = root / "docs"
    cards = mesh_cards(torch, SHARDS)
    mesh = make_mesh(1, SHARDS, cards)
    old = ct.settings.construct_mesh
    ct.settings.construct_mesh = mesh
    try:
        cs.LAUNCHES = 0
        cs.LAUNCHES_ON.clear()
        wall, stages = construct_timed(
            ct.classic_construct, docs, root / "sharded.cobs_classic",
            ct.ClassicIndexParameters(term_size=k, num_hashes=h,
                                      false_positive_rate=0.3))
        sync_all(torch)
        launches = cs.LAUNCHES
        on_cards = sorted(cs.LAUNCHES_ON)
    finally:
        ct.settings.construct_mesh = old
    require(launches > 0, "the sharded build did not launch the scatter")
    require(on_cards == sorted({d.index for d in cards}),
            f"the sharded build launched the scatter on cards {on_cards}")
    require(same_file(root / "sharded.cobs_classic",
                      root / "device.cobs_classic"),
            "the 4-shard classic build != phase 10's file")
    default = (construct_default_mesh(torch, cs, ct, root, k, h)
               if torch.cuda.device_count() > 1 else None)
    hdr = read_classic_header(root / "device.cobs_classic")
    R1, n_docs = hdr.signature_size + 1, len(hdr.file_names)
    Wl = -(-n_docs // (32 * SHARDS))

    # one full chunk of real updates (the first documents' rows, in
    # order), its documents moved to straddle the boundary of shards 0
    # and 1 (global documents 252-...): shard 0 drops those past its
    # 32 Wl documents, shard 1 those below its base
    rows, docs_of = [], []
    for d, entry in enumerate(DocumentList(docs).list()):
        for w in entry.term_windows(k):
            r = doc_row_indices(w, hdr.signature_size, h, 1)[0]
            rows.append(r.astype(np.int32))
            docs_of.append(np.full(r.size, d + 32 * Wl - 4, np.int32))
        if sum(r.size for r in rows) >= UPDATE_CHUNK:
            break
    r_host = torch.from_numpy(np.concatenate(rows)[:UPDATE_CHUNK])
    d_host = torch.from_numpy(np.concatenate(docs_of)[:UPDATE_CHUNK])
    n = r_host.numel()
    checks = {}
    for shard in (0, 1):
        # on the shard's own card: a card other than cuda:0 for shard 1
        # when four are visible
        dev = mesh.devices[0][shard]
        r = r_host.to(dev)
        d = d_host.to(dev) - shard * 32 * Wl
        plan = cs.plan_scatter(n, R1, Wl)
        require(plan.binned, f"shard {shard}: {plan} is not binned")
        words = torch.zeros((Wl, R1), dtype=torch.int32, device=dev)
        got = cs.construct_scatter(words.clone(), r, d, plan)
        want = cs.construct_scatter_reference(words.clone(), r, d)
        torch.cuda.synchronize(dev)
        require(torch.equal(got, want), f"construct_scatter on shard "
                                        f"{shard}'s words ({dev}) with "
                                        "foreign updates: kernel != plain")
        ok = (d >= 0) & (d < 32 * Wl)
        checks[shard] = (int((d < 0).sum()), int((d >= 32 * Wl).sum()),
                         int(ok.sum()))
        if shard == 1:
            # CUDA events on the shard's card, where the kernel runs
            with torch.cuda.device(dev):
                ms = median_device_ms(
                    torch, lambda i: cs.construct_scatter(words, r, d,
                                                          plan))
                plain_ms = median_device_ms(
                    torch, lambda i: cs.construct_scatter_reference(
                        words, r, d), reps=3)
            distinct = torch.unique(r[ok].long() * Wl
                                    + (d[ok].long() >> 5)).numel()
            bound_ms, bound_by = bound(8 * n + 8 * distinct, n)
        del got, want
    del r, d, r_host, d_host, words
    torch.cuda.empty_cache()
    print(f"phase 12 construction on {SHARDS} docs shards, "
          f"{cards_line(cards)} ({card}; phase 10's corpus, make_mesh(1, "
          f"{SHARDS}, {[str(c) for c in cards]})): classic build "
          f"{wall:.3f} s wall (phase 10's default build {single_wall:.3f} "
          f"s), {launches} scatter launches on cards {on_cards}, file "
          f"byte-identical to phase 10's; stages: "
          + " ".join(f"{p}={sec:.3f}s" for p, sec in stages.items())
          + f"; words per shard [{Wl}, {R1}], "
          f"{SHARDS * Wl * R1 * 4 / 1e9:.3f} GB "
          "in all")
    if default is not None:
        print(default["line"])
    print(f"phase 12 construct_scatter on one shard's words [{Wl}, {R1}] "
          f"with a full chunk of {n} updates straddling shards 0 and 1 "
          f"(binned plan; shard 0: {checks[0][1]} past its end, shard 1: "
          f"{checks[1][0]} below its base, dropped), each on its shard's "
          f"card ({mesh.devices[0][0]}, {mesh.devices[0][1]}): kernel == "
          f"plain on both; shard 1 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          "bound "
          f"{bound_ms:.4f} ms ({bound_by}, {checks[1][2]} updates kept, "
          f"{distinct} distinct words)")
    return {"launches": launches, "cards": len(on_cards), "wall": wall,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def construct_default_mesh(torch, cs, ct, root: Path, k: int,
                           h: int) -> dict:
    """On a host of several cards: `cobs classic-construct` on phase 10's
    corpus with no mesh set must launch the scatter on every card
    (construct/classic.py's default mesh), and the build with
    settings.construct_mesh on cuda:0 alone must launch it there only;
    both files byte-identical to phase 10's."""
    import contextlib
    import io

    from cobs_tpu_torch.cli.main import main as cli_main
    from cobs_tpu_torch.parallel.sharded import make_mesh

    docs, want = root / "docs", root / "device.cobs_classic"
    n_cards = torch.cuda.device_count()
    require(ct.settings.construct_mesh is None,
            "construct_mesh is set before the default build")
    walls, cards = {}, {}
    old = ct.settings.construct_mesh
    try:
        for how, mesh in (("default", None),
                          ("one card", make_mesh(1, 1, mesh_cards(torch,
                                                                  1)))):
            ct.settings.construct_mesh = mesh
            out = root / f"mesh_{how.replace(' ', '_')}.cobs_classic"
            cs.LAUNCHES_ON.clear()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = cli_main(["classic-construct", "-k", str(k),
                               "--num-hashes", str(h), "-f", "0.3",
                               str(docs), str(out)])
            sync_all(torch)
            walls[how] = time.perf_counter() - t0
            cards[how] = sorted(cs.LAUNCHES_ON)
            require(rc == 0, f"classic-construct ({how}) exited {rc}")
            require(same_file(out, want), f"classic-construct ({how}) != "
                                          "phase 10's file")
            out.unlink()
    finally:
        ct.settings.construct_mesh = old
    require(cards["default"] == list(range(n_cards)),
            f"the default build launched on cards {cards['default']}, "
            f"not on all {n_cards}")
    require(cards["one card"] == [0],
            f"the one-card build launched on cards {cards['one card']}")
    return {"walls": walls, "cards": cards, "line": (
        f"phase 12 default build on {n_cards} cards: `cobs "
        f"classic-construct` with no mesh set launched the scatter on "
        f"cards {cards['default']} in {walls['default']:.3f} s; with "
        f"construct_mesh on cuda:0 alone on cards {cards['one card']} in "
        f"{walls['one card']:.3f} s; both files byte-identical to phase "
        "10's")}


def phase_sharded(torch, qk, dh, engine, Search, QueryClient, settings,
                  cli_main, card: str, rows: int = 1 << 21, B: int = 64,
                  n_batches: int = 16) -> dict:
    """Phase 12: the document-sharded index, one shard a card when four
    are visible, else four shards of cuda:0; see the module docstring."""
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )
    from cobs_tpu_torch.parallel import dryrun
    from cobs_tpu_torch.parallel import sharded as sh
    from cobs_tpu_torch.parallel.benchmark import benchmark_scaling
    from cobs_tpu_torch.parallel.sharded import make_mesh

    # the quick-check entry points, on the card before the main path:
    # entry()'s step against K1's plain version; dryrun_multichip's
    # sharded step (the scatter and K1 on 8-word shards after the
    # transpose, against numpy) and its serving surface on a (2, 2) mesh
    cards = announce_mesh(torch)
    t0 = time.perf_counter()
    fn, args = dryrun.entry(DEVICE)
    require(torch.equal(fn(*args), qk.gather_and_count_reference(*args, 3)),
            "phase 12: dryrun.entry()'s step != K1's plain version")
    dryrun.dryrun_multichip(SHARDS, cards)
    sync_all(torch)
    dry_s = time.perf_counter() - t0

    W, docs, L, k = 384, 10_000, 1030, 100
    ix = engine.DeviceIndex.from_arrays(
        random_matrix(torch, rows, W, seed=1), [0], [rows], W,
        term_size=31, canonicalize=1, num_hashes=1, page_size=docs // 8,
        file_names=[f"doc{i:05d}" for i in range(docs)], device=DEVICE)
    queries = acgt_queries(np.random.default_rng(2), B * n_batches, L)
    batches = [queries[i:i + B] for i in range(0, len(queries), B)]
    s1 = Search(ix)
    walls = {}

    def run(s, what, num_results):
        t0 = time.perf_counter()
        out = [rl for bq in batches
               for rl in s.search_batch(bq, 0.0, num_results)]
        sync_all(torch)
        walls[what] = time.perf_counter() - t0
        return out

    run(s1, "warm", k)
    want = {nr: run(s1, ("single", nr), nr) for nr in (k, 0)}
    want_stream = list(s1.search_stream(queries, 0.0, k, batch_size=B))
    require(same_ranking(want_stream, want[k]), "phase 12: single-device "
                                                "search_stream != batch")
    long_q = acgt_queries(np.random.default_rng(13), 4, 70_000)
    want_long = {nr: s1.search_batch(long_q, 0.0, nr) for nr in (k, 0)}

    info, launches, shard_k, exact, on_cards = {}, {}, {}, {}, {}
    for shape in ((1, SHARDS), (2, 2)):
        mesh = make_mesh(*shape, cards)
        t0 = time.perf_counter()
        s = Search(ix, mesh=mesh)
        sync_all(torch)
        shard_s = time.perf_counter() - t0
        si = s._scorers[0]
        Wl = si.shard_width
        # one shard per (docs column, card): 4 on four cards, one a
        # column when the cards repeat
        want_shards = {(d, mesh.devices[b][d]) for b, d in
                       mesh.local_cells()}
        require(si.word_width == 512 and set(si._shards) == want_shards
                and all(t.is_contiguous() and tuple(t.shape) ==
                        (rows + 1, Wl) and t.device == dev
                        for (_, dev), t in si._shards.items()),
                f"phase 12 {shape}: shards "
                f"{[(key, tuple(t.shape)) for key, t in si._shards.items()]}")
        # one batch first (launch plans, pinned host blocks), then the
        # main path, with every count at 0 just before it
        s.search_batch(batches[0], 0.0, k)
        qk.LAUNCHES = dh.LAUNCHES = 0
        qk.LAUNCHES_ON.clear()
        dh.LAUNCHES_ON.clear()
        got = run(s, (shape, k), k)
        launches[shape, "batch"] = (qk.LAUNCHES, dh.LAUNCHES)
        on_cards[shape] = (sorted(qk.LAUNCHES_ON), sorted(dh.LAUNCHES_ON))
        want_cards = sorted({d.index for d in cards})
        require(on_cards[shape] == (want_cards, want_cards),
                f"phase 12 {shape}: K1 and hash launches on cards "
                f"{on_cards[shape]}, not {want_cards}")
        require(launches[shape, "batch"] == (SHARDS * n_batches,) * 2,
                f"phase 12 {shape} search_batch: launches "
                f"{launches[shape, 'batch']}, not one per cell per batch")
        require(same_ranking(got, want[k]), f"phase 12 {shape}: top {k} "
                                            "!= the single-device ranking")
        # one group first: its shapes' plans and allocations on every
        # card (four cards warm four allocators), then the timed group
        list(s.search_stream(queries, 0.0, k, batch_size=B))
        qk.LAUNCHES = dh.LAUNCHES = 0
        t0 = time.perf_counter()
        got = list(s.search_stream(queries, 0.0, k, batch_size=B))
        walls[shape, "stream"] = time.perf_counter() - t0
        launches[shape, "stream"] = (qk.LAUNCHES, dh.LAUNCHES)
        groups = -(-n_batches // settings.mega_batches)
        require(launches[shape, "stream"] == (SHARDS * groups,) * 2,
                f"phase 12 {shape} search_stream: launches "
                f"{launches[shape, 'stream']}, not one per cell per group")
        require(same_ranking(got, want[k]), f"phase 12 {shape}: "
                                            "search_stream ranks differently")
        require(same_ranking(run(s, (shape, 0), 0), want[0]),
                f"phase 12 {shape}: full ranking != the single-device one")
        require(same_ranking(
            list(s.search_stream(queries, 0.0, 0, batch_size=B)), want[0]),
            f"phase 12 {shape}: search_stream full ranking differs")
        if shape == (2, 2):
            # the sequence split: 69,970 terms >= settings.seq_split_terms
            require(not s._device_hashed(ix, [q.encode() for q in long_q]),
                    "phase 12: a long query was hashed on the card")
            for nr in (k, 0):
                qk.LAUNCHES = dh.LAUNCHES = 0
                got = s.search_batch(long_q, 0.0, nr)
                sync_all(torch)
                launches[shape, "seq", nr] = (qk.LAUNCHES, dh.LAUNCHES)
                require(launches[shape, "seq", nr] == (SHARDS, 0),
                        f"phase 12 sequence split: launches "
                        f"{launches[shape, 'seq', nr]}")
                require(same_ranking(got, want_long[nr]),
                        f"phase 12 sequence split, num_results={nr}: "
                        "!= the single-device ranking")
        else:
            shard_k = shard_kernels(torch, qk, dh, engine, sh, si, batches[0],
                                    k, median_device_ms)
        exact[shape] = shard_shapes_exact(
            torch, qk, dh, engine, si, shape, batches,
            long_q if shape == (2, 2) else None)
        info[shape] = (shard_s, Wl)
        del s, si
        torch.cuda.empty_cache()
    del s1, ix
    torch.cuda.empty_cache()

    streamed = phase_sharded_files(torch, qk, engine, Search, QueryClient,
                                   cli_main, sh, make_mesh, queries, B, k,
                                   rows, docs, cards)
    # two runs, each shard count timed over SCALING_ITERS batches, so
    # that the spread between them stands beside the effect
    scaling = [benchmark_scaling(n_devices=SHARDS, iters=SCALING_ITERS,
                                 devices=cards)
               for _ in range(2)]
    sync_all(torch)

    qps = {key: len(queries) / w for key, w in walls.items()}
    print(f"phase 12 sharded reference scale ({card}; phase 3's matrix, "
          f"{rows}+1 rows x {W} words, {docs} documents, {len(queries)} "
          f"random {L} bp queries in batches of {B}; shards on "
          f"{cards_line(cards)}): every ranking (top {k} and full, "
          "search_batch and search_stream) == the single-device Search's")
    for shape, (shard_s, Wl) in info.items():
        print(f"phase 12 mesh {shape}: word_width 512, {shape[1]} docs "
              f"shards of {Wl} words ({(rows + 1) * Wl * 4 / 1e9:.2f} GB "
              f"each), made in {shard_s:.2f} s; search_batch launched K1 "
              f"on cards {on_cards[shape][0]} and the hash kernel on "
              f"{on_cards[shape][1]}; launches (K1, hash) per "
              f"{n_batches} batches: search_batch "
              f"{launches[shape, 'batch']}, search_stream (groups of "
              f"{settings.mega_batches}) {launches[shape, 'stream']}; top "
              f"{k} search_batch {qps[shape, k]:.0f} q/s, search_stream "
              f"{qps[shape, 'stream']:.0f} q/s, full ranking "
              f"{qps[shape, 0]:.0f} q/s; single device in this call: "
              f"{qps['single', k]:.0f} / {qps['single', 0]:.0f} q/s "
              "(top k / full)")
    print(f"phase 12 sequence split on the (2, 2) mesh: 4 queries of "
          f"70,000 bp ({70_000 - 30} terms), launches (K1, hash) "
          f"{launches[(2, 2), 'seq', k]} top {k} and "
          f"{launches[(2, 2), 'seq', 0]} full: == the single-device "
          "rankings")
    print(f"phase 12 K1 at one cell's shape (B={B} T={L - 30} h=1 P=1 "
          f"W={shard_k['W']}): kernel {shard_k['k1']['ms']:.4f} ms, plain "
          f"{shard_k['k1']['plain_ms']:.4f} ms, bound "
          f"{shard_k['k1']['bound_ms']:.4f} ms ({shard_k['k1']['bound_by']}"
          f"); hash kernel on one cell's payload {shard_k['hash']['ms']:.4f}"
          f" ms, plain {shard_k['hash']['plain_ms']:.4f} ms, bound "
          f"{shard_k['hash']['bound_ms']:.6f} ms; _merge_topk_host of "
          f"{SHARDS} x {k} candidates per query, one batch: "
          f"{shard_k['merge_ms']:.4f} ms (median of 20)")
    print(f"phase 12 dryrun ({card}): entry()'s step == K1's plain "
          f"version; dryrun_multichip({SHARDS}, {cards_line(cards)}) "
          f"(scatter and K1 on 8-word shards == numpy, groups, serving "
          f"surface) passed; {dry_s:.2f} s")
    for shape, lines in exact.items():
        print(f"phase 12 mesh {shape}, kernel == plain, exact: "
              + "; ".join(lines))

    def spread(a, b):
        return abs(a - b) / ((a + b) / 2)

    a, b = scaling
    for n in sorted(a["per_n"]):
        print(f"phase 12 benchmark_scaling: {n} shards on "
              f"{a['distinct'][n]} device(s) ({card}): {a['per_n'][n]:.0f} / "
              f"{b['per_n'][n]:.0f} q/s in two runs (spread "
              f"{spread(a['per_n'][n], b['per_n'][n]):.3f}; B=16, 1,000 "
              f"terms, 4,096 documents per shard, {SCALING_ITERS} batches "
              f"each), cross-device copies per batch "
              f"{a['copies_per_batch'][n]:g} / {b['copies_per_batch'][n]:g}"
              f", exchanges per batch {a['exchanges_per_batch'][n]:g} / "
              f"{b['exchanges_per_batch'][n]:g}, CPU cores busy "
              f"{a['cpu_util'][n]:.2f} / {b['cpu_util'][n]:.2f}")
    print(f"phase 12 benchmark_scaling: efficiency "
          f"{a['efficiency']:.3f} / {b['efficiency']:.3f} (spread "
          f"{spread(a['efficiency'], b['efficiency']):.3f}) against "
          f"predicted {a['predicted_efficiency']:.3f} (min(1, d / n): "
          f"{SHARDS} shards on {cards_line(cards)}); K=8 groups "
          f"{a['mega_qps']:.0f} / {b['mega_qps']:.0f} q/s")
    return {"launches": launches[(1, SHARDS), "batch"],
            "stream_launches": launches[(1, SHARDS), "stream"],
            "cards": len(on_cards[1, SHARDS][0]),
            "batches": n_batches, **shard_k, **streamed}


def shard_kernels(torch, qk, dh, engine, sh, si, batch, k,
                  median_device_ms) -> dict:
    """K1 and the hash kernel against their plain versions at one cell's
    shapes (cell (0, 0) of the (1, 4) mesh: the whole batch against a
    128-word shard), timed beside their bounds; and the host merge of one
    batch's candidates."""
    qbytes = [q.encode() for q in batch]
    B, L = len(batch), len(batch[0])
    T = L - 30
    hashes = engine.create_hashes(qbytes, 31, 1, 1)
    rows = torch.from_numpy(si._rows_idx(hashes, B)).to(DEVICE)
    shard = si.shard(0, 0)
    W = shard.shape[1]
    got = qk.gather_and_count(shard, rows, 1)
    want = qk.gather_and_count_reference(shard, rows, 1)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K1 at a shard's shape != plain")
    k1 = {"ms": median_device_ms(
              torch, lambda i: qk.gather_and_count(shard, rows, 1)),
          "plain_ms": median_device_ms(
              torch, lambda i: qk.gather_and_count_reference(shard, rows,
                                                             1), reps=5)}
    k1["bound_ms"], k1["bound_by"] = bound(
        B * T * W * 4 + B * W * 32 * 4 + B * T * 4, B * T * W * 32)
    qdata, qlens = si._pack_queries(engine.QueryBytes(qbytes), B)
    sig, off, mag = si._tables[shard.device]
    args = (torch.from_numpy(qdata).to(DEVICE),
            torch.from_numpy(qlens).to(DEVICE), 31, 1, 1, sig, off,
            si.zero_row, mag)
    require(torch.equal(dh.rows_from_queries(*args),
                        dh.rows_from_queries_reference(*args)),
            "the hash kernel on a cell's payload != plain")
    require(torch.equal(dh.rows_from_queries(*args), rows),
            "the hash kernel on a cell's payload != the host rows")
    hk = {"ms": median_device_ms(torch,
                                 lambda i: dh.rows_from_queries(*args)),
          "plain_ms": median_device_ms(
              torch, lambda i: dh.rows_from_queries_reference(*args),
              reps=5)}
    hk["bound_ms"], hk["bound_by"] = bound(
        B * L + B * 4 + B * T * 4 + 16, B * T * (3 * 31 + 40 + 15 + 2))
    v, g = si._dispatch(hashes, k).get()
    lay, W32 = si.index.doc_layout, si.word_width * 32
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        sh._merge_topk_host(v, g, W32, lay, B, k)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"W": W, "k1": k1, "hash": hk,
            "merge_ms": statistics.median(times)}


def shard_shapes_exact(torch, qk, dh, engine, si, shape, batches,
                       long_q=None) -> list[str]:
    """The hash kernel and K1 against their plain versions, exact, at the
    other shapes the main path gives them on this mesh (each a launch
    geometry of its own: plan_gather_count picks slices and clusters
    from B, T and W): the last cell's share of one batch, its share of a
    search_stream group (engine._concat_payloads of every batch), and,
    given the long queries, its term slice of the sequence split (host
    rows) against its shard. Returns one line per kernel and shape."""
    ix = si.index
    n_batch = shape[0]
    b, d = n_batch - 1, shape[1] - 1
    shard = si.shard(b, d)
    sig, off, mag = si._tables[shard.device]
    done = []

    def k1(rows, what):
        got = qk.gather_and_count(shard, rows, ix.num_hashes)
        want = qk.gather_and_count_reference(shard, rows, ix.num_hashes)
        require(torch.equal(got, want), f"phase 12 {shape}: K1 != plain "
                                        f"({what}), {max_err(got, want)}")
        done.append(f"K1 on {what} (B={rows.shape[0]} T={rows.shape[1]} "
                    f"W={shard.shape[1]}, {shard.device})")

    def cell_payload(queries, what):
        payloads = [engine.QueryBytes([q.encode() for q in bq])
                    for bq in queries]
        cat = engine._concat_payloads(ix, payloads)
        n_pad = -(-max(len(cat), n_batch) // n_batch) * n_batch
        nl = n_pad // n_batch
        qdata, qlens = si._pack_queries(cat, n_pad)
        args = (torch.from_numpy(np.ascontiguousarray(
                    qdata[b * nl:(b + 1) * nl])).to(shard.device),
                torch.from_numpy(np.ascontiguousarray(
                    qlens[b * nl:(b + 1) * nl])).to(shard.device),
                ix.term_size, ix.num_hashes, ix.canonicalize, sig, off,
                si.zero_row, mag)
        rows = dh.rows_from_queries(*args)
        require(torch.equal(rows, dh.rows_from_queries_reference(*args)),
                f"phase 12 {shape}: hash kernel != plain ({what})")
        done.append(f"hash kernel on {what} (B={nl} L={qdata.shape[1]}, "
                    f"{shard.device})")
        k1(rows, what)

    cell_payload(batches[:1], f"cell ({b}, {d}) of one batch")
    cell_payload(batches, f"cell ({b}, {d}) of a search_stream group of "
                          f"{len(batches)}")
    if long_q is not None:
        hashes = engine.create_hashes([q.encode() for q in long_q],
                                      ix.term_size, ix.num_hashes,
                                      ix.canonicalize)
        rows = si._rows_idx(hashes, len(long_q), n_batch)
        tl = rows.shape[1] // n_batch
        k1(torch.from_numpy(np.ascontiguousarray(
               rows[:, b * tl:(b + 1) * tl])).to(shard.device),
           f"the sequence split's cell ({b}, {d}) term slice")
    torch.cuda.synchronize(shard.device)
    return done


def phase_sharded_files(torch, qk, engine, Search, QueryClient, cli_main,
                        sh, make_mesh, queries, B, k, rows, docs,
                        cards) -> dict:
    """Phase 12 (c), (e) and (f): phase 9's file written again, streamed
    into 4 shards on `cards`; two processes on a global mesh; `query` and
    `serve` with --mesh over the distinct cards."""
    path = ROOT / "bench_data" / "phase9_reference.cobs_classic"
    work = ROOT / "bench_data" / "phase12"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    size = write_classic_index(path, rows, docs, seed=9)
    read_through(path)
    print(f"phase 12 wrote {path.name} again from phase 9's seed: {size} "
          f"bytes in {time.perf_counter() - t0:.1f} s")
    try:
        return _phase_sharded_files(torch, qk, engine, Search, QueryClient,
                                    cli_main, sh, make_mesh, queries, B, k,
                                    path, work, cards)
    finally:
        path.unlink(missing_ok=True)
        shutil.rmtree(work, ignore_errors=True)


#: the corpus of phase 12's two processes: cobs_tpu's two-process test's
#: (tests/multihost_construct_worker.py), 20 documents; the golden corpus
#: has 7, fewer than one 8-document slice per process
CHILD_DOCS = 20


def child_corpus(root: Path) -> list[bytes]:
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bases[rng.integers(0, 4, size=130 + 53 * i)].tobytes()
            for i in range(CHILD_DOCS)]
    root.mkdir(parents=True, exist_ok=True)
    for i, seq in enumerate(seqs):
        (root / f"doc{i:03d}.fasta").write_bytes(b">d\n" + seq + b"\n")
    return seqs


def _phase_sharded_files(torch, qk, engine, Search, QueryClient, cli_main,
                         sh, make_mesh, queries, B, k, path, work,
                         cards) -> dict:
    import contextlib
    import io

    import cobs_tpu_torch as ct

    mesh = make_mesh(1, SHARDS, cards)
    # --mesh N of the CLI takes the first N cards: 4 on four cards, 1 on
    # one
    n_mesh = len(set(cards))
    held = Search(str(path))
    require(isinstance(held.index_files[0], engine.DeviceIndex),
            "phase 12: phase 9's file was not held on the card")
    want = [rl for i in range(0, len(queries), B)
            for rl in held.search_batch(queries[i:i + B], 0.0, k)]
    want_full = [rl for i in range(0, 2 * B, B)
                 for rl in held.search_batch(queries[i:i + B], 0.0, 0)]
    del held
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    st = Search(str(path), mesh=mesh, streamed=True)
    sync_all(torch)
    upload_s = time.perf_counter() - t0
    require(isinstance(st.index_files[0], engine.StreamedIndex)
            and len(st._scorers[0]._shards) == SHARDS
            and [t.device for _, t in sorted(
                st._scorers[0]._shards.items(), key=lambda kv: kv[0][0])]
            == cards,
            "phase 12: the streamed mesh Search did not hold 4 shards on "
            f"{cards}")
    qk.LAUNCHES = 0
    got = [rl for i in range(0, len(queries), B)
           for rl in st.search_batch(queries[i:i + B], 0.0, k)]
    sync_all(torch)
    st_launches = qk.LAUNCHES
    require(same_ranking(got, want), "phase 12 streamed into shards: top "
                                     f"{k} != the held index's")
    got = [rl for i in range(0, 2 * B, B)
           for rl in st.search_batch(queries[i:i + B], 0.0, 0)]
    require(same_ranking(got, want_full), "phase 12 streamed into shards: "
                                          "full ranking != the held one")
    del st
    torch.cuda.empty_cache()

    # two processes on one global mesh of 4 cells, 2 per process, and
    # `serve --mesh N`, started together
    n_child = 4 * B
    seqs = child_corpus(work / "docs")
    single = work / "single.cobs_classic"
    with contextlib.redirect_stderr(io.StringIO()):
        ct.classic_construct(ct.DocumentList(work / "docs"), single,
                             index_params=ct.ClassicIndexParameters())
    child_q = [seqs[1][:61].decode(), seqs[10][5:80].decode(),
               seqs[19][:45].decode()]
    (work / "spec.json").write_text(json.dumps({
        "path": str(path), "queries": queries[:n_child], "B": B, "k": k,
        "want": pairs(want[:n_child]), "fed_queries": child_q,
        "fed_want": pairs(Search(str(single)).search_batch(child_q, 0.0))}))
    d = sock_dir()
    sock = d / "mesh.sock"
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        logs += [open(work / f"child{i}.log", "wb") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; "
             f"chip_smoke.sharded_child({i}, {str(work)!r})"],
            cwd=ROOT, stdout=logs[i], stderr=subprocess.STDOUT)
            for i in range(2)]
        serve_log = open(work / "serve.log", "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cobs_tpu_torch.cli.main", "serve",
             "--mesh", str(n_mesh), "-i",
             str(GOLDEN_DIR / "fasta7.cobs_classic"),
             "--socket", str(sock), "-t", "0", "--linger-ms", "1"],
            cwd=ROOT, stdout=serve_log, stderr=subprocess.STDOUT))
        logs.append(serve_log)
        # query --mesh in this process meanwhile
        for kind in ("classic", "compact"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = cli_main(["query", "--mesh", str(n_mesh), "-i",
                               str(GOLDEN_DIR / f"fasta7.cobs_{kind}"),
                               "-t", "0", GOLDEN_QUERY])
            lines = [tuple(x.split("\t")) for x in
                     out.getvalue().splitlines()]
            require(rc == 0 and [(a, int(b)) for a, b in lines]
                    == GOLDEN_LINES, f"query --mesh {n_mesh} {kind}: rc "
                                     f"{rc}, {lines}")
        too_many = torch.cuda.device_count() + 1
        for cmd in ("query", "serve"):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli_main([cmd, "--mesh", str(too_many), "-i",
                               str(GOLDEN_DIR / "fasta7.cobs_classic"),
                               "--socket", str(d / "no.sock")]
                              if cmd == "serve" else
                              [cmd, "--mesh", str(too_many), "-i",
                               str(GOLDEN_DIR / "fasta7.cobs_classic"),
                               GOLDEN_QUERY])
            require(rc != 0 and "mesh needs" in err.getvalue(),
                    f"{cmd} --mesh {too_many} on {too_many - 1} card(s): "
                    f"rc {rc}")
        wait_for(sock, procs[2], 300)
        with QueryClient(str(sock), timeout=60) as c:
            got = pairs([c.search(GOLDEN_QUERY, threshold=0.8),
                         c.search(GOLDEN_QUERY, threshold=0.0)])
        require(got == [GOLDEN_LINES[:1], GOLDEN_LINES],
                f"serve --mesh {n_mesh}: {got}")
        procs[2].terminate()
        require(procs[2].wait(timeout=60) == 0,
                f"serve --mesh {n_mesh}: SIGTERM did not give rc 0")
        for i in range(2):
            rc = procs[i].wait(timeout=300)
            require(rc == 0, f"phase 12 child {i} exited {rc}")
        children_s = time.perf_counter() - t0
    except BaseException:
        for log in logs:
            log.flush()
        for name in ("child0", "child1", "serve"):
            f = work / f"{name}.log"
            if f.exists():
                print(f"phase 12 {name} log: "
                      f"{f.read_bytes()[-3000:].decode(errors='replace')}",
                      file=sys.stderr)
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for log in logs:
            log.close()
        shutil.rmtree(d, ignore_errors=True)
    child_lines = [line for i in range(2) for line in
                   (work / f"child{i}.log").read_text().splitlines()
                   if line.startswith("phase 12 child")]
    print(f"phase 12 streamed into {SHARDS} shards on {cards_line(cards)} "
          f"(Search(path, mesh, streamed=True), phase 9's file): uploaded "
          f"in {upload_s:.2f} s; {len(queries)} queries top {k} "
          f"({st_launches} K1 launches) and {2 * B} full rankings == the "
          "held index's")
    for line in child_lines:
        print(line)
    print(f"phase 12 two processes and serve --mesh {n_mesh} done in "
          f"{children_s:.1f} s; query --mesh {n_mesh} and serve --mesh "
          f"{n_mesh} gave the reference's lines; --mesh {too_many} exited "
          "non-zero")
    return {"streamed_launches": st_launches}


def sharded_child(rank: int, work: str) -> None:
    """One of phase 12's two processes (started by _phase_sharded_files):
    a gloo group through a file store, a global mesh of 4 cells (2 per
    process: cards 2 rank and 2 rank + 1 when four are visible, else
    cuda:0 twice); phase 9's file streamed into this process's
    own shards and 256 queries scored, equal to the parent's single-
    device rankings; then construction of its slice of a 20-document
    corpus and the federation, on one device and over the global mesh,
    equal to one build."""
    import torch

    import cobs_tpu_torch as ct
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.parallel import distributed, sharded

    work = Path(work)
    spec = json.loads((work / "spec.json").read_text())
    ct.settings.disable_cache = True
    t0 = time.perf_counter()
    distributed.initialize(f"file://{work / 'store'}", num_processes=2,
                           process_id=rank, timeout=300)
    cards = mesh_cards(torch, SHARDS)[2 * rank:2 * rank + 2]
    try:
        mesh = distributed.global_mesh(devices=cards)
        require(mesh.shape == {"batch": 1, "docs": SHARDS}
                and mesh.local_cells() == [(0, 2 * rank),
                                           (0, 2 * rank + 1)],
                f"child {rank}: mesh {mesh}")
        t1 = time.perf_counter()
        s = ct.Search(spec["path"], mesh=mesh, streamed=True)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t1
        require(sorted(str(dev) for _, dev in s._scorers[0]._shards)
                == [str(c) for c in cards],
                f"child {rank} uploaded shards {list(s._scorers[0]._shards)}"
                f", not one on each of {cards}")
        B, k, q = spec["B"], spec["k"], spec["queries"]
        qk.LAUNCHES = sharded.EXCHANGES = 0
        t1 = time.perf_counter()
        got = [rl for i in range(0, len(q), B)
               for rl in s.search_batch(q[i:i + B], 0.0, k)]
        sync_all(torch)
        score_s = time.perf_counter() - t1
        k1_launches = qk.LAUNCHES
        n_b = len(q) // B
        require([[list(p) for p in rl] for rl in pairs(got)]
                == spec["want"], f"child {rank}: rankings differ")
        require((k1_launches, sharded.EXCHANGES) == (2 * n_b, n_b),
                f"child {rank}: {k1_launches} K1 launches, "
                f"{sharded.EXCHANGES} exchanges for {n_b} batches")
        prefix = work / "fed"
        mine = distributed.construct(
            ct.DocumentList(work / "docs"), prefix, kind="classic",
            index_params=ct.ClassicIndexParameters(clobber=True),
            tmp_path=work / f"tmp{rank}")
        require(mine == distributed.shard_path(prefix, rank),
                f"child {rank}: shard {mine}")
        distributed.barrier()
        fq = spec["fed_queries"]
        for how, m in (("one device", None),
                       ("global mesh", distributed.global_mesh(
                           devices=cards))):
            fed = distributed.open_federated(prefix, 2, "classic", mesh=m)
            got = [[list(p) for p in rl]
                   for rl in pairs(fed.search_batch(fq, 0.0))]
            require(got == spec["fed_want"], f"child {rank}: federation "
                                             f"on {how} != one build")
        distributed.barrier()
        print(f"phase 12 child {rank}: global mesh of {SHARDS} cells, 2 "
              f"local on {[str(c) for c in cards]}, uploaded in "
              f"{upload_s:.2f} s; {len(q)} queries top "
              f"{k} in {score_s:.2f} s == the single-device rankings, "
              f"{k1_launches} K1 launches and {n_b} exchanges for {n_b} "
              f"batches; construct + open_federated (one device and the "
              f"global mesh) == one build; {time.perf_counter() - t0:.1f} "
              "s in all", flush=True)
    finally:
        distributed.shutdown()


#: phase 14: cobs_tpu's experiments/paper_scale.py at its defaults (the
#: reference paper's scale: 100,000 documents of 20 kbp, out-of-core
#: compact construction in 256 MiB, repack, B=512, mega 8, 16,384 queries)
PAPER_DOCS, PAPER_DOC_SIZE, PAPER_MEMORY = 100_000, 20_000, "256MiB"
PAPER_QUERIES, PAPER_BATCH, PAPER_MEGA, PAPER_TERMS = 16384, 512, 8, 1000
#: served responses held to streamed host scoring; queries of the
#: --streamed (device scoring) run
PAPER_CHECKED, PAPER_STREAMED_QUERIES = 1024, 2048
#: phase 15: the serving soak's seconds, and those of its run with the
#: scorer's phase timers on
SOAK_SECONDS, SOAK_DEBUG_SECONDS = 30.0, 10.0


def rss_now() -> int:
    """This process's resident set size in bytes (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def run_child(call: str, log: Path, seconds: float) -> int:
    """The exit code of a fresh Python process that imports this script
    and runs `call`, its output in `log`; killed and failed after
    `seconds`."""
    with open(log, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
    try:
        return proc.wait(timeout=seconds)
    except subprocess.TimeoutExpired:
        require(False, f"{call}: no exit in {seconds:.0f} s")
    finally:
        if proc.returncode is None:
            proc.kill()
            proc.wait()


@contextlib.contextmanager
def environ(**values):
    """Environment variables set for the length of a block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def event_ms(torch, fn):
    """(fn()'s result, its device time in ms from CUDA events): one call,
    for plain versions too slow to repeat."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def numpy_hashes(qbytes: list, k: int) -> np.ndarray:
    """The numpy host hashing the native library replaced (canonical
    k-mers, XXH64 seed 0) over a batch's windows."""
    from cobs_tpu_torch.core.canonical import canonicalize_batch
    from cobs_tpu_torch.core.xxh64 import xxh64_multi_seed
    from cobs_tpu_torch.ingest.util import sliding_windows

    w = np.concatenate([sliding_windows(np.frombuffer(q, np.uint8), k)
                        for q in qbytes])
    w, _ = canonicalize_batch(w)
    return xxh64_multi_seed(np.ascontiguousarray(w), 1)


def phase_paper_scale(torch, qk, dh, cs, engine, Search, settings,
                      card: str) -> dict:
    """Phase 14: the reference paper's scale; see the module docstring."""
    from cobs_tpu_torch.experiments import paper_scale as ps

    root = ROOT / "bench_data" / "paper"
    shutil.rmtree(root, ignore_errors=True)
    try:
        out = _paper_build(torch, cs, ps, root, card)
        out.update(_paper_query(torch, qk, dh, cs, engine, Search, settings,
                                ps, root, out["pages"], card))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def paper_build_child(root: str, out: str) -> None:
    """Phase 14 (b) in a fresh process: the harness's build (the CLI's
    compact-construct on the card, then repack), the scatter kernel's
    count at 0 just before. Writes to `out` (JSON) the steps, the
    launches, the construction log's sub-index count and stages, the
    worker threads, this process's resident set size before the build
    (torch, the CUDA context and the kernel loaded), and (seconds, RSS,
    page sub-indices written so far) sampled every 0.2 s from the
    build's start. The samples give the peaks: getrusage's ru_maxrss
    also counts the parent's resident set at the fork, and the card's
    host has no VmHWM in /proc/self/status."""
    import io
    import threading

    import torch

    from cobs_tpu_torch.experiments import paper_scale as ps
    from cobs_tpu_torch.ops import _build
    from cobs_tpu_torch.ops import construct_scatter as cs
    from cobs_tpu_torch.settings import settings

    torch.zeros(1, device=DEVICE)
    _build.load("construct_scatter")
    torch.cuda.synchronize()
    base = rss_now()
    log = io.StringIO()
    samples, stop = [], threading.Event()
    t0 = time.perf_counter()

    def sample():
        while not stop.wait(0.2):
            samples.append((time.perf_counter() - t0, rss_now(),
                            log.getvalue().count("Construct Classic Index")))

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    cs.LAUNCHES = 0
    try:
        with contextlib.redirect_stderr(log):
            steps = ps.build(Path(root), PAPER_MEMORY, DEVICE)
        torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join()
    text = log.getvalue()
    Path(out).write_text(json.dumps({
        "steps": steps, "launches": cs.LAUNCHES, "base_rss": base,
        "threads": settings.threads, "samples": samples,
        "sub_indices": text.count("Construct Classic Index"),
        "stages": construct_stages(text), "log_tail": text[-2000:]}))


def build_rss(res: dict, pages: int) -> tuple[int, int, int]:
    """(pages written when the build's fixed buffers are in place, the
    build process's peak RSS up to then, its peak through the
    construction), from paper_build_child's samples. Out of core, the
    pages are written as they are built, so the process stops growing
    once its fixed buffers are in place: the pinned upload rings of the
    pages built at once, the document list, the workers' heaps. That is
    once every page worker has built a page (`threads` pages, one in
    flight a worker) and a quarter of the pages are written, leaving at
    least half of them to judge the growth by."""
    first = min(max(pages // 4, res["threads"]), pages // 2)
    samples = res["samples"]
    settled = max((r for _, r, n in samples if n <= first),
                  default=res["base_rss"])
    peak = max((r for t, r, _ in samples
                if t <= res["steps"]["construct_s"]),
               default=res["base_rss"])
    return first, settled, peak


def _paper_build(torch, cs, ps, root: Path, card: str) -> dict:
    """Phase 14 (a), (b): gen, then build through the harness in a fresh
    process (paper_build_child), then one subdirectory split
    (_paper_split)."""
    import io

    from cobs_tpu_torch.construct.device import UPDATE_CHUNK, UPLOAD_BUFFERS
    from cobs_tpu_torch.fmt.compact import read_compact_header

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ps.gen(root, PAPER_DOCS, PAPER_DOC_SIZE)
    gen_s = time.perf_counter() - t0
    fasta_gb = PAPER_DOCS * (PAPER_DOC_SIZE + 4) / 1e9
    print(f"phase 14 gen: {PAPER_DOCS} documents x {PAPER_DOC_SIZE} bp "
          f"({fasta_gb:.2f} GB of FASTA) in {gen_s:.1f} s")

    res_file, log = root / "build_child.json", root / "build_child.log"
    rc = run_child(
        f"paper_build_child({str(root)!r}, {str(res_file)!r})", log, 900)
    require(rc == 0, f"the paper-scale build process exited {rc}; log "
                     f"tail {log.read_bytes()[-3000:]!r}")
    res = json.loads(res_file.read_text())
    steps, launches = res["steps"], res["launches"]
    require(steps["construct_rc"] == 0 and steps["repack_rc"] == 0,
            f"paper-scale build failed: {steps}; log tail "
            f"{res['log_tail']}")
    require(launches > 0, "the paper-scale build did not launch the bit "
                          "scatter kernel")
    hdr, _ = read_compact_header(root / "paper.cobs_compact")
    wide, _ = read_compact_header(root / "paper_wide.cobs_compact")
    sigs = {p.signature_size for p in hdr.parameters}
    pages = len(hdr.parameters)
    require(pages == -(-PAPER_DOCS // (8 * hdr.page_size)) and len(sigs) == 1,
            f"{pages} pages of Bloom sizes {sigs}")
    require(len(wide.parameters) == 1
            and wide.page_size == pages * hdr.page_size,
            f"repack gave {len(wide.parameters)} pages of {wide.page_size} B")
    sig = sigs.pop()
    matrix_bytes = sig * hdr.page_size * pages
    samples = res["samples"]
    first, settled, peak = build_rss(res, pages)
    late = peak - settled
    late_pages = pages - first
    late_bytes = sig * hdr.page_size * late_pages
    rings = (min(res["threads"], pages) * UPLOAD_BUFFERS * 2 * 4
             * UPDATE_CHUNK)
    curve = [max((r for _, r, n in samples if n <= q * pages // 4),
                 default=res["base_rss"]) for q in range(1, 4)]
    k = ps.TERM_SIZE
    updates = PAPER_DOCS * (PAPER_DOC_SIZE - k + 1)
    print(f"phase 14 build ({card}): compact-construct --memory "
          f"{PAPER_MEMORY} on the card {steps['construct_s']:.1f} s "
          f"({updates / steps['construct_s'] / 1e6:.1f} M updates/s, "
          f"{updates} updates, k={k}, h=1, fpr 0.3, canonical), repack "
          f"{steps['repack_s']:.1f} s; {pages} pages of {hdr.page_size} B "
          f"x {sig} rows ({matrix_bytes / 1e6:.1f} MB of matrix), "
          f"repacked to 1 page of {wide.page_size} B; {res['sub_indices']} "
          f"page sub-indices written and combined into {pages} pages; "
          f"scatter kernel launches {launches}; the build process "
          f"({res['threads']} threads): RSS {res['base_rss'] / 1e9:.3f} "
          f"GB before (torch, CUDA context, kernel); peak with 1/4, 2/4, "
          f"3/4 of the pages written "
          + ", ".join(f"{r / 1e9:.3f}" for r in curve)
          + f" GB, through the construction "
          f"{peak / 1e9:.3f} GB (with {first} pages written "
          f"{settled / 1e9:.3f} GB, then +{late / 1e9:.3f} GB over the "
          f"last {late_pages} pages, under "
          f"half of their {late_bytes / 1e9:.3f} GB of matrix; "
          f"{min(res['threads'], pages)} pinned upload rings "
          f"{rings / 1e9:.3f} GB), with repack "
          f"{max([peak] + [r for _, r, _ in samples]) / 1e9:.3f} GB "
          f"(sampled every 0.2 s)")
    print("phase 14 build stages (summed over pages and workers): "
          + " ".join(f"{n}={s:.3f}s" for n, s in res["stages"].items()))
    require(late < late_bytes / 2,
            f"the construction's peak RSS grew {late / 1e9:.3f} GB over "
            f"its last {late_pages} pages, not under half of their "
            f"{late_bytes / 1e9:.3f} GB of matrix")
    split = _paper_split(torch, cs, root, sig, hdr.page_size, card)
    return {"gen_s": gen_s, "build": steps, "scatter_launches": launches,
            "pages": pages, "sub_indices": res["sub_indices"],
            "matrix_bytes": matrix_bytes,
            "rss": (res["base_rss"], settled, peak),
            "page_size": hdr.page_size, "split": split}


def _paper_split(torch, cs, root: Path, sig: int, page_size: int,
                 card: str) -> dict:
    """Phase 14 (b): the first subdirectory (1,000 documents: one page of
    the main build's page size) compact-constructed on the card at a
    --memory that makes the classic batch rule (construct/classic.py:
    memory // (sig / 8) // threads documents) cut each page into
    quarter-page classic sub-indices, combined per page, and at
    PAPER_MEMORY (one sub-index a page); the files are equal byte for
    byte. The scatter's count at 0 before each build."""
    import io

    from cobs_tpu_torch.cli.main import main as cli
    from cobs_tpu_torch.fmt.compact import read_compact_header
    from cobs_tpu_torch.settings import settings

    memory = 8 * page_size // 4 * (sig // 8) * settings.threads
    runs = {}
    for label, mem in (("split", str(memory)), ("whole", PAPER_MEMORY)):
        log = io.StringIO()
        cs.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            rc = cli(["compact-construct", str(root / "docs" / "000"),
                      str(root / f"{label}.cobs_compact"), "--memory", mem,
                      "-p", str(page_size), "--clobber", "--device",
                      DEVICE])
        torch.cuda.synchronize()
        runs[label] = {"rc": rc, "launches": cs.LAUNCHES,
                       "sub_indices":
                           log.getvalue().count("Construct Classic Index"),
                       "s": time.perf_counter() - t0}
        require(rc == 0 and cs.LAUNCHES > 0,
                f"subdirectory 000 at --memory {mem}: {runs[label]}, log "
                f"tail {log.getvalue()[-2000:]}")
    pages = len(read_compact_header(root / "whole.cobs_compact")[0]
                .parameters)
    require(runs["split"]["sub_indices"] >= 2 * pages
            and runs["whole"]["sub_indices"] == pages,
            f"subdirectory 000, {pages} pages: sub-indices {runs}")
    require(same_file(root / "split.cobs_compact",
                      root / "whole.cobs_compact"),
            "subdirectory 000: the split build's file != the whole's")
    print(f"phase 14 split ({card}): subdirectory 000 (1,000 documents, "
          f"{pages} page of {page_size} B) at --memory {memory} B: "
          f"{runs['split']['sub_indices']} classic sub-indices combined "
          f"per page, {runs['split']['launches']} scatter launches, "
          f"{runs['split']['s']:.1f} s; at {PAPER_MEMORY}: "
          f"{runs['whole']['sub_indices']} sub-indices, one a page, "
          f"{runs['whole']['launches']} launches, {runs['whole']['s']:.1f} "
          f"s; files byte-identical")
    return runs


def _paper_query(torch, qk, dh, cs, engine, Search, settings, ps,
                 root: Path, pages: int, card: str) -> dict:
    """Phase 14 (c)-(g): verify on every load, the kernels at this path's
    shapes, serve, host hashing."""
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )

    paper = str(root / "paper.cobs_compact")
    wide = str(root / "paper_wide.cobs_compact")
    n_docs, plants = ps.planted(root)
    require(n_docs == PAPER_DOCS and len(plants) == 11,
            f"{n_docs} documents, {len(plants)} planted")

    # (c) verify: PLANT_SEQ on every load of both files
    def opened(label, path, pages, **kw):
        t0 = time.perf_counter()
        s = Search(path, **kw)
        torch.cuda.synchronize()
        ix = s.index_files[0]
        require(ix.num_pages == pages, f"{label}: {ix.num_pages} pages")
        ranking = ps.check_planted(s, n_docs, plants, label)
        return s, ranking, time.perf_counter() - t0

    loads, rankings = {}, {}
    s, rankings["coalesced"], loads["coalesced"] = opened(
        "paper.cobs_compact held, coalesced at load", paper, 1)
    require(isinstance(s.index_files[0], engine.DeviceIndex), "not held")
    del s
    with environ(COBS_TPU_COALESCE_PAGES="0"):
        s98, rankings["P=98"], loads["P=98"] = opened(
            "paper.cobs_compact held, COBS_TPU_COALESCE_PAGES=0", paper,
            pages)
        old = settings.streamed_host_score
        settings.streamed_host_score = "host"
        try:
            _, rankings["streamed host"], loads["streamed host"] = opened(
                "paper.cobs_compact streamed, host scoring, "
                "COBS_TPU_COALESCE_PAGES=0", paper, pages, streamed=True)
        finally:
            settings.streamed_host_score = old
    sw, rankings["wide"], loads["wide"] = opened(
        "paper_wide.cobs_compact held", wide, 1)
    require(all(r == rankings["coalesced"] for r in rankings.values()),
            "the planted rankings differ between loads")
    print(f"phase 14 verify: {len(plants)} planted documents at 70/70 and "
          f"every other "
          f"score below 0.9 x 70 on each load, rankings equal; load s "
          + " ".join(f"{n}={t:.2f}" for n, t in loads.items()))

    # (d) the hash kernel and K1 at this path's shapes, exact
    k, B, T = ps.TERM_SIZE, PAPER_BATCH, PAPER_TERMS
    queries = ps.random_queries(B, T)
    kern = {}
    for label, ix in (("P=98", s98.index_files[0]),
                      ("P=1", sw.index_files[0])):
        P, W = ix.num_pages, ix.word_width
        qdata, qlens = engine._device_hash_args(ix, engine.QueryBytes(
            queries))
        sig, off, mag = ix.page_tables
        args = (qdata, qlens, k, 1, 1, sig, off, ix.zero_row, mag)
        rows = dh.rows_from_queries(*args)
        plain_rows, hash_plain_ms = event_ms(
            torch, lambda: dh.rows_from_queries_reference(*args))
        host_rows = engine._rows_tensor(ix, engine.create_hashes(
            queries, k, 1, 1))
        torch.cuda.synchronize()
        require(torch.equal(rows, plain_rows), f"{label}: hash kernel != "
                                               "plain")
        require(torch.equal(rows, host_rows), f"{label}: hash kernel != "
                                              "native host hashing")
        del plain_rows, host_rows
        got = qk.gather_and_count(ix.matrix, rows, 1)
        want, k1_plain_ms = event_ms(
            torch, lambda: qk.gather_and_count_reference(ix.matrix, rows, 1))
        err = max_err(got, want)
        require(err == 0, f"{label}: K1 != plain, max error {err}")
        del got, want
        torch.cuda.empty_cache()
        unique = torch.unique(rows).numel()
        k1_ms = median_device_ms(
            torch, lambda i: qk.gather_and_count(ix.matrix, rows, 1),
            reps=10)
        hash_ms = median_device_ms(
            torch, lambda i: dh.rows_from_queries(*args))
        gathered = B * T * P * W * 4
        k1_bound, k1_by = bound(unique * W * 4 + rows.numel() * 4
                                + B * P * W * 32 * 4, B * T * P * W * 32)
        hash_bound, hash_by = bound(
            qdata.numel() + B * 4 + rows.numel() * 4 + 24 * P,
            B * T * (3 * k + 40 + 15 + 2 * P))
        kern[label] = {
            "k1": {"ms": k1_ms, "plain_ms": k1_plain_ms,
                   "bound_ms": k1_bound, "bound_by": k1_by},
            "hash": {"ms": hash_ms, "plain_ms": hash_plain_ms,
                     "bound_ms": hash_bound, "bound_by": hash_by}}
        print(f"phase 14 kernels at {label} (B={B}, T={T}, h=1, W={W} words "
              f"per page on the card, {card}): hash kernel == plain == "
              f"native host hashing, {hash_ms:.4f} ms (plain, host numpy, "
              f"{hash_plain_ms:.1f} ms; bound {hash_bound:.4f} ms, "
              f"{hash_by}); K1 == plain exactly, {k1_ms:.4f} ms (plain "
              f"{k1_plain_ms:.1f} ms; bound {k1_bound:.4f} ms, {k1_by}: "
              f"{unique} distinct rows; {gathered / k1_ms / 1e6:.0f} GB/s "
              f"of gathered rows)")
        del rows, qdata, qlens
    del s98
    torch.cuda.empty_cache()

    scatter = _paper_scatter(torch, cs, ps, root, card)

    # (e) serve: search_stream held on the card, the counts at 0 just
    # before; every batch of the two rounds and the warm-up group counted
    qk.LAUNCHES = dh.LAUNCHES = 0
    served = ps.serve(root, PAPER_QUERIES, PAPER_BATCH, PAPER_MEGA, False,
                      num_kmers=T, device=DEVICE)
    torch.cuda.synchronize()
    launches = (qk.LAUNCHES, dh.LAUNCHES)
    batches = PAPER_MEGA + 2 * (PAPER_QUERIES // PAPER_BATCH)
    require(0 < launches[0] == launches[1] < batches,
            f"serve: {launches} launches of K1 and the hash kernel for "
            f"{batches} batches (groups of {PAPER_MEGA} expected)")
    s = served.pop("search")
    allq = ps.random_queries(PAPER_QUERIES, T)
    # the served rounds' first group, at their mega
    window = allq[:B * PAPER_MEGA]
    old_mega = settings.mega_batches
    settings.mega_batches = PAPER_MEGA
    try:
        t0 = time.perf_counter()
        grouped = list(s.search_stream(window, 0.8, 100, batch_size=B))
        wall_ms = (time.perf_counter() - t0) * 1e3
        # one group: one launch of each kernel
        busy_us, top = device_busy_us(
            torch,
            lambda: list(s.search_stream(window, 0.8, 100, batch_size=B)),
            {"gather_count_kernel": 1, "device_hash_kernel": 1})
        settings.mega_batches = 1
        one = list(s.search_stream(window, 0.8, 100, batch_size=B))
    finally:
        settings.mega_batches = old_mega
    busy = None if busy_us is None else busy_us / 1e3 / wall_ms
    require(pairs(grouped) == pairs(one), "the served group of "
            f"{PAPER_MEGA} batches ranks differently from one batch at a "
            "time")
    group = paper_group_kernels(torch, qk, dh, engine, s, window, B, card)
    checked = allq[:PAPER_CHECKED]
    held = list(s.search_stream(checked, 0.8, 100, batch_size=B))
    old = settings.streamed_host_score
    settings.streamed_host_score = "host"
    try:
        hs = Search(wide, streamed=True)
        hs.timer_.reset()
        host = list(hs.search_stream(checked, 0.8, 100, batch_size=B))
        host_hash_ms = hs.timer_.get("hashes") / (PAPER_CHECKED // B) * 1e3
    finally:
        settings.streamed_host_score = old
    require(pairs(held) == pairs(host), "the first served responses != "
                                        "streamed host scoring's")
    del hs
    # COBS_TPU_DEVICE_HASH=host on the held file: native host hashing
    settings.device_hash = "host"
    try:
        s.timer_.reset()
        dev_host = s.search_batch(checked[:B], 0.8, 100)
        host_hashed_ms = s.timer_.get("hashes") * 1e3
    finally:
        settings.device_hash = "auto"
    require(pairs(dev_host) == pairs(held[:B]), "device_hash=host ranks "
                                                "differently")
    del s
    torch.cuda.empty_cache()
    # the cost of hashing on the host at phase 3's shape (64 x 1,030 bp):
    # native against the numpy it replaced, same queries, same call
    q64 = [q.encode() for q in acgt_queries(np.random.default_rng(2), 64,
                                            1030)]
    nat = np.concatenate(engine.create_hashes(q64, k, 1, 1))
    require(np.array_equal(nat, numpy_hashes(q64, k)),
            "native hashes != numpy hashes")
    walls = {"native": [], "numpy": []}
    for how in ("native", "numpy", "numpy", "native", "native", "numpy"):
        t0 = time.perf_counter()
        if how == "native":
            engine.create_hashes(q64, k, 1, 1)
        else:
            numpy_hashes(q64, k)
        walls[how].append((time.perf_counter() - t0) * 1e3)
    native_ms = statistics.median(walls["native"])
    numpy_ms = statistics.median(walls["numpy"])

    # (f) --streamed: device scoring from the host mmap
    streamed = ps.serve(root, PAPER_STREAMED_QUERIES, PAPER_BATCH,
                        PAPER_MEGA, True, num_kmers=T, device=DEVICE)
    del streamed["search"]
    torch.cuda.empty_cache()
    print(f"phase 14 serve ({card}): search_stream held, B={B}, mega "
          f"{PAPER_MEGA}, -t 0.8 -l 100, {PAPER_QUERIES} random 1,030 bp "
          f"queries: open+upload {served['open_s']:.2f} s, "
          + ", ".join(f"{q:.0f}" for q in served["qps"])
          + f" q/s in two rounds; K1 / hash launches {launches[0]} / "
          f"{launches[1]} for {batches} batches "
          f"({launches[0] / batches:.3f} per batch); "
          + (f"card busy share not measured (the profiler windows lost "
             f"records: {top})" if busy is None else
             f"card {100 * busy:.1f} % busy over {len(window)} queries "
             f"({busy_us / 1e3:.2f} of {wall_ms:.2f} ms; largest: "
             + "; ".join(f"{n[:50]} {us / 1e3:.2f} ms" for us, n in top[:3])
             + ")")
          + f"; its first group == one batch at a time (mega 1); the "
          f"first {PAPER_CHECKED} responses == streamed host "
          f"scoring's; --streamed (device scoring) "
          + ", ".join(f"{q:.0f}" for q in streamed["qps"])
          + f" q/s over {PAPER_STREAMED_QUERIES} queries")
    print(f"phase 14 host hashing (native): streamed host scoring "
          f"`hashes` {host_hash_ms:.2f} ms per batch of {B}; "
          f"COBS_TPU_DEVICE_HASH=host {host_hashed_ms:.2f} ms per batch "
          f"of {B} (rankings equal to device hashing); at phase 3's shape "
          f"(64 x 1,030 bp) native {native_ms:.2f} ms against numpy "
          f"{numpy_ms:.2f} ms in this call (hashes equal)")
    return {"kernels": kern, "scatter": scatter, "group": group,
            "served_launches": launches,
            "served_batches": batches, "qps": served["qps"],
            "streamed_qps": streamed["qps"], "busy": busy,
            "host_hash_ms": host_hash_ms, "native_ms": native_ms,
            "numpy_ms": numpy_ms}


def paper_group_kernels(torch, qk, dh, engine, s, queries, B: int,
                        card: str) -> dict:
    """The hash kernel and K1 against their plain versions, exact, at the
    launch shape of the served rounds: one group's payload
    (group_payload), here len(queries) // B batches of B on the held
    one-page index; K1 timed there beside its bound."""
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )

    ix = s.index_files[0]
    batches = [queries[i:i + B] for i in range(0, len(queries), B)]
    cat, flagged = group_payload(engine, s, batches)
    require(flagged == 0, f"phase 14 group: {flagged} queries flagged")
    rows = group_kernels_exact(torch, qk, dh, engine, ix, cat,
                               f"phase 14 group, K={len(batches)}")
    torch.cuda.empty_cache()
    shape = tuple(rows.shape)
    Bg, T, h, P = shape
    W = ix.word_width
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = qk.plan_gather_count(Bg, T, h, P, W, sm)
    ms = median_device_ms(
        torch, lambda i: qk.gather_and_count(ix.matrix, rows, ix.num_hashes),
        reps=10)
    unique = torch.unique(rows).numel()
    bound_ms, bound_by = bound(unique * W * 4 + rows.numel() * 4
                               + Bg * P * W * 32 * 4, Bg * T * h * P * W * 32)
    print(f"phase 14 group ({card}): the served launch shape, rows "
          f"{list(shape)} over {W} words ({len(batches)} batches of {B} "
          f"in one payload): hash kernel == plain, K1 == plain exactly "
          f"(plan: cluster {plan.cluster}, {plan.n_slices} slices of "
          f"{plan.slice_w} words, grid {plan.grid}); K1 {ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {unique} distinct rows)")
    return {"shape": shape, "k1_ms": ms, "k1_bound_ms": bound_ms}


def _paper_scatter(torch, cs, ps, root: Path, card: str) -> dict:
    """Phase 14 (d): the scatter kernel against its plain version on one
    upload chunk of this build: the first documents of page 0 in the
    construction's order, into that page's word-major words."""
    from cobs_tpu_torch.construct.bitmatrix import doc_row_indices
    from cobs_tpu_torch.construct.device import UPDATE_CHUNK
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )
    from cobs_tpu_torch.fmt.compact import read_compact_header
    from cobs_tpu_torch.ingest.document_list import DocumentList

    hdr, _ = read_compact_header(root / "paper.cobs_compact")
    sig = hdr.parameters[0].signature_size
    # the construction orders documents by size, then path: every size is
    # equal, so page 0 opens with the first subdirectory's documents, and
    # only they are listed (listing all 100,000 costs as much as the
    # listing inside the build)
    docs = DocumentList(root / "docs" / "000")
    docs.sort_by_size()
    rows, docs_of, n = [], [], 0
    for d, entry in enumerate(docs.list()[:8 * hdr.page_size]):
        for w in entry.term_windows(ps.TERM_SIZE):
            r = doc_row_indices(w, sig, 1, 1)[0].astype(np.int32)
            rows.append(r)
            docs_of.append(np.full(r.size, d, dtype=np.int32))
            n += r.size
        if n >= UPDATE_CHUNK:
            break
    r = torch.from_numpy(np.concatenate(rows)[:UPDATE_CHUNK]).to(DEVICE)
    d = torch.from_numpy(np.concatenate(docs_of)[:UPDATE_CHUNK]).to(DEVICE)
    del rows, docs_of
    Wc, R1 = -(-hdr.page_size // 4), sig + 1
    words = torch.zeros((Wc, R1), dtype=torch.int32, device=DEVICE)
    got = cs.construct_scatter(words.clone(), r, d)
    want, plain_ms = event_ms(
        torch, lambda: cs.construct_scatter_reference(words.clone(), r, d))
    require(torch.equal(got, want), "construct_scatter on a paper-scale "
                                    "chunk: kernel != plain")
    # warm: successive launches OR the same updates into the same words
    ms = median_device_ms(torch, lambda i: cs.construct_scatter(words, r, d))
    distinct = torch.unique(r.long() * Wc + (d.long() >> 5)).numel()
    bound_ms, bound_by = bound(8 * r.numel() + 2 * 4 * distinct, r.numel())
    print(f"phase 14 construct_scatter on one upload chunk of this build "
          f"(Wc={Wc}, R1={R1}, {r.numel()} updates, documents "
          f"0-{int(d.max())} of page 0, {card}): == plain exactly; "
          f"{ms:.4f} ms warm, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {distinct} distinct words)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_soak(torch, qk, dh, cs, card: str) -> dict:
    """Phase 15: cobs_tpu_torch/experiments/server_soak.py on the card,
    then again with the scorer's phase timers on."""
    from cobs_tpu_torch.experiments import server_soak

    qk.LAUNCHES = dh.LAUNCHES = cs.LAUNCHES = 0
    res = server_soak.soak(SOAK_SECONDS, 4, DEVICE)
    torch.cuda.synchronize()
    launches = (qk.LAUNCHES, dh.LAUNCHES, cs.LAUNCHES)
    st = res["stats"]
    require(res["ok"], f"soak failed (harness exit 1): {res['errors'][:5]}, "
                       f"batch_failures {st.get('batch_failures')}, open "
                       f"connections {res['open_conns']}")
    require(res["reloads"] >= 20, f"only {res['reloads']} reloads")
    require(min(launches) > 0, f"the soak launched {launches}")
    require(not any(k in st for k in server_soak.PHASES),
            "phase timers without COBS_TPU_SERVER_DEBUG")
    print(f"phase 15 soak ({card}, {SOAK_SECONDS:.0f} s, 4 pipelining "
          f"clients, reload every second, chaos): {res['exact']} responses "
          f"exact, {res['reloads']} reloads, {res['chaos_conns']} chaos "
          f"connections, {st.get('bad_requests', 0)} bad requests and "
          f"{st.get('query_errors', 0)} query errors answered, "
          f"{st.get('batch_failures', 0)} batch failures, "
          f"{res['open_conns']} connections left open; {st['batches']} "
          f"batches, K1 / hash / scatter launches {launches}; harness exit 0")
    with environ(COBS_TPU_SERVER_DEBUG="1"):
        dbg = server_soak.soak(SOAK_DEBUG_SECONDS, 4, DEVICE)
    st = dbg["stats"]
    require(dbg["ok"], f"debug soak failed: {dbg['errors'][:5]}")
    require({k for k in st if k.startswith("t_")} == set(server_soak.PHASES),
            f"COBS_TPU_SERVER_DEBUG: stats keys {sorted(st)}")
    per = {k: 1e3 * st[k] / st["batches"] for k in server_soak.PHASES}
    print(f"phase 15 soak with COBS_TPU_SERVER_DEBUG=1 "
          f"({SOAK_DEBUG_SECONDS:.0f} s): {dbg['exact']} responses exact, {st['batches']} batches; "
          f"scorer ms per batch: "
          + " ".join(f"{k}={v:.4f}" for k, v in per.items()))
    return {"exact": res["exact"], "reloads": res["reloads"],
            "phases_ms": per}


#: phase 16: the runcap serve (queries, batch, queries held to host
#: scoring, document queries per tier), the mega_serve_bench configs
#: over its queries, serve_bench's queries and clients
RUNCAP_QUERIES, RUNCAP_BATCH, RUNCAP_CHECKED, RUNCAP_PER_TIER = \
    4096, 1024, 256, 64
#: the harness's default rounds: one group of 4,096 queries takes tens of
#: ms, so a single round's best was as noisy as 39,231 against 120,043
#: q/s for the same load in two processes on one card
RUNCAP_ROUNDS = 3
MEGA_CONFIGS, MEGA_QUERIES = "64:1,64:16,1024:16", 4096
SERVE_QUERIES, SERVE_CLIENTS = 2048, 4


def phase_harnesses(torch, qk, dh, cs, engine, Search, settings,
                    card: str) -> dict:
    """Phase 16: the ports of cobs_tpu's remaining harnesses on the card;
    see the module docstring."""
    out = {}
    root = ROOT / "bench_data" / "runcap"
    shutil.rmtree(root, ignore_errors=True)
    try:
        out["runcap"] = _phase_runcap(torch, qk, dh, cs, engine, Search,
                                      settings, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["bench"] = _phase_bench_torch(torch, qk, card)
    torch.cuda.empty_cache()
    out["width"] = _phase_width(torch, qk, card)
    torch.cuda.empty_cache()
    path = ROOT / "bench_data" / "phase9_reference.cobs_classic"
    try:
        if not path.exists():
            write_classic_index(path, 1 << 21, 10_000, seed=9)
        s = Search(str(path), device=DEVICE, streamed=False)
        out["mega"] = _phase_mega(torch, qk, dh, s, settings, card)
        out["serve"] = _phase_serve_bench(torch, qk, dh, s, path, card)
        del s
    finally:
        path.unlink(missing_ok=True)
    torch.cuda.empty_cache()
    out["score"] = _phase_score_batch(card)
    return out


def runcap_doc_queries(rb, root: Path) -> tuple[list, list]:
    """(queries, their documents' (name, terms)): RUNCAP_PER_TIER
    documents of each tier (seed 16), each query the document's first
    1,030 bases (all of a shorter one)."""
    rng = np.random.default_rng(16)
    starts = np.cumsum([0] + [n for n, _ in rb.TIERS])
    queries, docs = [], []
    for lo, hi in zip(starts[:-1], starts[1:]):
        for d in rng.choice(np.arange(lo, hi), RUNCAP_PER_TIER,
                            replace=False):
            name = f"d{d:05d}"
            seq = read_fasta_sequence(root / "docs" / f"{name}.fasta")[:1030]
            queries.append(seq)
            docs.append((name, len(seq) - 30))
    return queries, docs


def _phase_runcap(torch, qk, dh, cs, engine, Search, settings, root: Path,
                  card: str) -> dict:
    from cobs_tpu_torch.experiments import runcap_serve_bench as rb
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )
    from cobs_tpu_torch.fmt.compact import read_compact_header

    t0 = time.perf_counter()
    rb.write_corpus(root)
    gen_s = time.perf_counter() - t0
    cs.LAUNCHES = 0
    t0 = time.perf_counter()
    idx = rb.construct_index(root, DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    scatter = cs.LAUNCHES
    require(scatter > 0, "runcap: the build did not launch the scatter")
    header, _ = read_compact_header(idx)
    n_docs, n_pages = len(header.file_names), len(header.parameters)
    require(n_docs == sum(n for n, _ in rb.TIERS), f"runcap: {n_docs} docs")
    print(f"phase 16 runcap ({card}): {n_docs} documents written in "
          f"{gen_s:.1f} s, compact-constructed on the card in {build_s:.1f} "
          f"s ({scatter} scatter launches): {n_pages} pages of "
          f"{header.page_size} B, {idx.stat().st_size >> 20} MiB")

    mega = settings.mega_batches
    settings.mega_batches = 16
    try:
        t0 = time.perf_counter()
        searches = rb.load_variants(idx, DEVICE)
        load_s = time.perf_counter() - t0
        lay = {n: s.index_files[0] for n, s in searches.items()}
        for n, s in searches.items():
            print(f"phase 16 runcap ({card}): " + rb.layout_line(n, s))
        cap = lay["capped"]
        require(cap.page_docs is not None
                and len(set(cap.page_docs.tolist())) >= 2,
                f"runcap: capped is not run-coalesced with unequal runs "
                f"(page_docs {cap.page_docs})")
        require(lay["uncapped"].num_pages != cap.num_pages,
                "runcap: uncapped and capped have the same page count")
        require(lay["plain"].page_docs is None
                and lay["plain"].num_pages == n_pages,
                "runcap: plain is not one device page per file page")

        queries = rb.random_queries(RUNCAP_QUERIES, 1000)
        qk.LAUNCHES = dh.LAUNCHES = 0
        best = rb.serve(searches, queries, RUNCAP_BATCH, RUNCAP_ROUNDS,
                        RUNCAP_BATCH * 16,
                        log=lambda m: print(f"phase 16 runcap {m}"))
        torch.cuda.synchronize()
        launches = (qk.LAUNCHES, dh.LAUNCHES)
        batches = ((1 + RUNCAP_ROUNDS) * len(searches)
                   * -(-RUNCAP_QUERIES // RUNCAP_BATCH))
        require(min(launches) > 0, f"runcap: serving launched {launches}")
        for name, qps in best.items():
            print(rb.result_line(name, RUNCAP_BATCH, qps))

        # rankings: the served queries at -t 0 (at the harness's -t 0.8
        # few random queries rank a document), document queries of every
        # tier at -t 0.8, and a full ranking, alike in all three; held to
        # host scoring
        ranked = {n: pairs(s.search_stream(queries, 0.0, rb.LIMIT,
                                           batch_size=RUNCAP_BATCH))
                  for n, s in searches.items()}
        dq, dq_docs = runcap_doc_queries(rb, root)
        dranked = {n: pairs(rb.rep(s, dq, RUNCAP_BATCH, keep=True)[1])
                   for n, s in searches.items()}
        full = {n: pairs(s.search_batch(dq[::RUNCAP_PER_TIER], 0.0, 0))
                for n, s in searches.items()}
        for got in (ranked, dranked, full):
            require(got["capped"] == got["uncapped"] == got["plain"],
                    "runcap: the variants rank differently")
        for res, (name, terms) in zip(dranked["capped"], dq_docs):
            require((name, terms) in res,
                    f"runcap: {name} does not score its {terms} terms")
        require(all(len(r) == n_docs for r in full["capped"]),
                "runcap: a full ranking is not one line per document")
        old = settings.device_hash, settings.streamed_host_score
        settings.device_hash = settings.streamed_host_score = "host"
        try:
            host = Search(str(idx), streamed=True)
            require(isinstance(host.index_files[0], engine.StreamedIndex),
                    "runcap: host scoring is not streamed")
            host_q = pairs(host.search_batch(queries[:RUNCAP_CHECKED],
                                             0.0, rb.LIMIT))
            host_d = pairs(host.search_batch(dq, rb.THRESHOLD, rb.LIMIT))
            host_f = pairs(host.search_batch(dq[::RUNCAP_PER_TIER], 0.0, 0))
        finally:
            settings.device_hash, settings.streamed_host_score = old
        require(ranked["capped"][:RUNCAP_CHECKED] == host_q
                and dranked["capped"] == host_d and full["capped"] == host_f,
                "runcap: the card ranks differently from host scoring")
        require(all(len(r) == rb.LIMIT for r in ranked["capped"]),
                f"runcap: a -t 0 ranking is not {rb.LIMIT} documents")
        print(f"phase 16 runcap ({card}): the three variants rank "
              f"{len(queries)} random queries alike (-t 0, top "
              f"{rb.LIMIT}), {len(dq)} document queries ({RUNCAP_PER_TIER} a "
              f"tier, each finding its document at all its terms) and "
              f"{len(full['capped'])} full rankings of {n_docs} lines; "
              f"the first {RUNCAP_CHECKED} random, all document queries "
              f"and the full rankings equal streamed host scoring's; "
              f"loads {load_s:.2f} s for three; K1 / hash launches "
              f"{launches} for {batches} batches")

        # the kernels at this path's launch shape: each layout's first
        # served group (as many batches as its top-k budget lets
        # search_stream pack), exact against their plain versions
        batched = [queries[i:i + RUNCAP_BATCH]
                   for i in range(0, RUNCAP_QUERIES, RUNCAP_BATCH)]
        k1 = {}
        for name, s in searches.items():
            ix = s.index_files[0]
            mega_k = s._mega_k_capped(RUNCAP_BATCH, rb.LIMIT)
            cat, flagged = group_payload(engine, s, batched[:mega_k])
            require(flagged == 0, f"runcap {name}: {flagged} flagged")
            rows = group_kernels_exact(torch, qk, dh, engine, ix, cat,
                                       f"phase 16 runcap {name} group")
            Bg, T, h, P = rows.shape
            W = ix.word_width
            unique = torch.unique(rows).numel()
            b_ms, b_by = bound(unique * W * 4 + rows.numel() * 4
                               + Bg * P * W * 32 * 4, Bg * T * h * P * W * 32)
            k1[name] = {
                "shape": [Bg, T, h, P], "W": W, "bound_ms": b_ms,
                "bound_by": b_by,
                "ms": median_device_ms(
                    torch, lambda i: qk.gather_and_count(ix.matrix, rows, h),
                    reps=10)}
            if name == "capped":
                _, k1[name]["plain_ms"] = event_ms(
                    torch, lambda: qk.gather_and_count_reference(
                        ix.matrix, rows, h))
            del rows
            torch.cuda.empty_cache()
            print(f"phase 16 runcap K1 ({card}) {name}: rows {[Bg, T, h, P]} "
                  f"over {W} words, {k1[name]['ms']:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by})"
                  + (f", plain {k1[name]['plain_ms']:.1f} ms"
                     if "plain_ms" in k1[name] else ""))
    finally:
        settings.mega_batches = mega
    return {"gen_s": gen_s, "build_s": build_s, "scatter_launches": scatter,
            "launches": launches, "batches": batches, "qps": best,
            "layout": {n: (ix.num_pages, ix.word_width * 4)
                       for n, ix in lay.items()},
            "k1": k1}


def _phase_bench_torch(torch, qk, card: str) -> dict:
    """bench_torch.py's measurement on the reference-default matrix,
    after one batch's totals equal to plain K1's."""
    import bench_torch
    from cobs_tpu_torch.experiments import hot_loop

    sig, docs, B, T, _ = bench_torch.CUDA_SIZES
    m = hot_loop.reference_matrix(torch, sig, hot_loop.words_for(docs),
                                  device=DEVICE)
    ids = hot_loop.random_ids(torch, np.random.default_rng(16), 1, B, T, 1,
                              sig, DEVICE)[0]
    want = qk.gather_and_count_reference(m, ids, 1).sum(dim=1)
    require(torch.equal(hot_loop.batch_totals(m, ids, 1), want),
            "bench_torch: K1's totals != plain")
    qk.LAUNCHES = 0
    res = bench_torch.run(torch, DEVICE, m)
    torch.cuda.synchronize()
    require(qk.LAUNCHES > 0, "bench_torch did not launch K1")
    res["launches"] = qk.LAUNCHES
    print(f"phase 16 bench_torch ({card}): {res['queries_per_s']:.1f} "
          f"queries/s, {res['gbps']:.1f} GB/s gathered, "
          f"{res['ms_per_batch']:.4f} ms a batch of {B} x {T} terms "
          f"(differenced, {res['launches']} K1 launches; one batch's totals "
          f"== plain): {bench_torch.result_line(res)}")
    return res


def _phase_width(torch, qk, card: str) -> dict:
    """width_sweep at one round (K1's launches counted); then each
    width's K1 equal to plain on a batch of 8 queries and on the B=64 ids
    it is then timed on (the planner cuts slices by B too), beside its
    bound."""
    from cobs_tpu_torch.experiments import width_sweep
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms,
    )
    from cobs_tpu_torch.experiments.hot_loop import random_ids

    qk.LAUNCHES = 0
    st = width_sweep.setups(torch, device=DEVICE)
    for s in st:
        s["run"].round()
    torch.cuda.synchronize()
    launches = qk.LAUNCHES
    require(launches > 0, "width_sweep did not launch K1")
    rows = [dict(s["run"].result(), lg=s["lg"], W=s["W"], docs=s["W"] * 32)
            for s in st]
    for line in width_sweep.table(rows):
        print(f"phase 16 width_sweep ({card}): {line}")
    rng = np.random.default_rng(17)
    B, T = width_sweep.B, width_sweep.T
    for s, r in zip(st, rows):
        m, W = s["matrix"], s["W"]
        sig = m.shape[0] - 1
        ids = random_ids(torch, rng, 1, 8, T, 1, sig, DEVICE)[0]
        got = qk.gather_and_count(m, ids, 1)
        want, r["plain_ms"] = event_ms(
            torch, lambda: qk.gather_and_count_reference(m, ids, 1))
        require(torch.equal(got, want), f"width_sweep W={W}: K1 != plain")
        del got, want
        ids = random_ids(torch, rng, 1, B, T, 1, sig, DEVICE)[0]
        require(torch.equal(qk.gather_and_count(m, ids, 1),
                            qk.gather_and_count_reference(m, ids, 1)),
                f"width_sweep W={W}: K1 != plain at B={B}")
        r["ms"] = median_device_ms(
            torch, lambda i: qk.gather_and_count(m, ids, 1), reps=10)
        r["bound_ms"], r["bound_by"] = bound(
            B * T * W * 4 + B * W * 32 * 4 + B * T * 4, B * T * W * 32)
        r["plan"] = qk.launch_plan(m.device.index, B, T, 1, 1, W)
        p = r["plan"]
        print(f"phase 16 width_sweep K1 ({card}) W={W}: == plain at B=8 "
              f"(plain {r['plain_ms']:.1f} ms) and on the timed B={B} ids; "
              f"B={B} {r['ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['gbps']:.1f} GB/s in the sweep; plan {p.n_slices} slices "
              f"of {p.slice_w} words, cluster {p.cluster}, {p.stages} stages")
        del ids
    del st
    return {"rows": rows, "launches": launches}


def _phase_mega(torch, qk, dh, s, settings, card: str) -> dict:
    """mega_serve_bench's sweep, one round, threshold 0 (so every query
    ranks 100 documents), each config's results equal to search_batch's."""
    from cobs_tpu_torch.experiments import mega_serve_bench as mb

    configs = mb.parse_configs(MEGA_CONFIGS)
    queries = mb.random_queries(MEGA_QUERIES, 1000)
    qk.LAUNCHES = dh.LAUNCHES = 0
    best = mb.sweep(s, settings, configs, queries, 1, 0.0, 100,
                    log=lambda m: print(f"phase 16 mega_serve {m}"))
    torch.cuda.synchronize()
    launches = (qk.LAUNCHES, dh.LAUNCHES)
    batches = sum(-(-min(B * mega, MEGA_QUERIES) // B)
                  + -(-MEGA_QUERIES // B) for B, mega in configs)
    require(min(launches) > 0, f"mega_serve launched {launches}")
    require(launches[0] < batches, f"mega_serve: {launches[0]} K1 launches "
                                   f"for {batches} batches")
    for (B, mega), qps in sorted(best.items()):
        print(mb.result_line(B, mega, 0.0, 100, qps))
    want = pairs(s.search_batch(queries, 0.0, 100))
    for B, mega in configs:
        got = mb.rep(s, settings, B, mega, queries, 0.0, 100, keep=True)[2]
        require(pairs(got) == want, f"mega_serve {B}:{mega}: results != "
                                    "search_batch's")
    print(f"phase 16 mega_serve ({card}): every config's {MEGA_QUERIES} "
          f"rankings == search_batch's; K1 / hash launches {launches} for "
          f"{batches} batches")
    return {"qps": best, "launches": launches, "batches": batches}


def _phase_serve_bench(torch, qk, dh, s, path: Path, card: str) -> dict:
    """serve_bench on phase 9's file: direct, then SERVE_CLIENTS client
    processes, threshold 0 (every response ranks 100 documents), every
    served response equal to search_batch's."""
    import argparse

    from cobs_tpu_torch.experiments import serve_bench as sb

    args = argparse.Namespace(
        index=str(path), threshold=0.0, limit=100, batch=1024,
        clients=SERVE_CLIENTS, queries=SERVE_QUERIES, kmers=1000,
        warmup=256, linger_ms=5.0, streamed=False, pin_clients=False,
        skip_direct=False, device=DEVICE)
    qk.LAUNCHES = dh.LAUNCHES = 0
    res = sb.run(args, search=s, keep=True)
    torch.cuda.synchronize()
    launches = (qk.LAUNCHES, dh.LAUNCHES)
    require(min(launches) > 0, f"serve_bench launched {launches}")
    queries = sb.random_queries(SERVE_QUERIES, 1000)
    want = pairs(s.search_batch(queries, 0.0, 100))
    require(res["responses"] == want,
            "serve_bench: a served response != search_batch's")
    print(f"phase 16 serve_bench ({card}): {SERVE_QUERIES} queries from "
          f"{SERVE_CLIENTS} client processes, every response == "
          f"search_batch's; served {res['served']:.1f} q/s against direct "
          f"{res['direct']:.1f} (overhead {res['overhead_pct']:.1f} %), p50 "
          f"{res['p50']} ms p99 {res['p99']} ms; K1 / hash launches "
          f"{launches}")
    res.pop("responses")
    res["launches"] = launches
    return res


def _phase_score_batch(card: str) -> dict:
    """score_batch_bench at its defaults (host only)."""
    from cobs_tpu_torch.experiments import score_batch_bench

    best = score_batch_bench.bench()
    print(f"phase 16 score_batch_bench ({card} host): {best * 1e3:.2f} ms "
          f"a batch of 64 x 1,000 terms over 10,000 documents")
    return {"ms": best * 1e3}


def main() -> int:
    t_start = time.perf_counter()
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
    from cobs_tpu_torch.query.client import QueryClient
    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.query.server import QueryServer
    from cobs_tpu_torch.settings import settings

    # every card's name and power limit, one line each; card 0's names
    # the measurements
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    card = cards[0].strip()
    print("\n".join(line.strip() for line in cards))
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    with phase_clock("build"):
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

    with phase_clock(1):
        err = phase_mixed_shapes(torch, qk, np.random.default_rng(0))
    with phase_clock(2):
        phase_golden(torch, qk, dh, Search)
    with phase_clock(3):
        ref = phase_reference_scale(torch, qk, dh, engine, Search, settings,
                                    card)
    torch.cuda.empty_cache()
    with phase_clock(4):
        err = max(err, ref["err"], phase_wide_rows(torch, qk, dg, card))
    torch.cuda.empty_cache()
    with phase_clock(5):
        hash5 = phase_hash_kernel(torch, dh, np.random.default_rng(5), card)
    with phase_clock(6):
        phase_gather_small(torch, dg, np.random.default_rng(6))

    # K2's path, with its count at 0 just before it
    with phase_clock(7):
        dg.LAUNCHES = 0
        sweep = bench.sweep(torch, plain=dg.dma_gather_rows_reference)
        torch.cuda.synchronize()
        k2_launches = dg.LAUNCHES
        require(k2_launches > 0, "the bandwidth sweep did not launch K2")
        for row in sweep:
            print(f"phase 7 K2 bandwidth ({card}): " + bench.format_row(row))
        k2 = sweep[0]  # W=384: the row width of phase 3

    # K1's batch sweep, with its count at 0 just before it
    with phase_clock(8):
        qk.LAUNCHES = 0
        k1_sweep = gc_bench.sweep(torch)
        torch.cuda.synchronize()
        require(qk.LAUNCHES > 0, "the batch sweep did not launch K1")
        for row in k1_sweep:
            print(f"phase 8 K1 batch sweep ({card}): "
                  + gc_bench.format_row(row))
    torch.cuda.empty_cache()

    with phase_clock(9):
        phase_streamed_golden(torch, native, Search, engine.StreamedIndex,
                              settings)
        streamed = phase_streamed(torch, qk, dh, engine, native, Search,
                                  settings, card)
    err = max(err, streamed["err"])
    torch.cuda.empty_cache()

    with phase_clock(10):
        phase_construct_edges(torch, cs, build_batch_matrix_device)
        phase_construct_golden(torch, cs, cli_main)
        con = phase_construct(torch, cs, qk, dh, card)
    torch.cuda.empty_cache()

    with phase_clock(11):
        phase_serve_cli(QueryClient)
        served = phase_serve(torch, qk, dh, engine, Search, QueryServer,
                             QueryClient, settings, card)
    torch.cuda.empty_cache()
    with phase_clock(12):
        mesh = phase_sharded(torch, qk, dh, engine, Search, QueryClient,
                             settings, cli_main, card)
    con_mesh = con.pop("sharded")
    cli = con.pop("cli")
    torch.cuda.empty_cache()
    with phase_clock(14):
        paper = phase_paper_scale(torch, qk, dh, cs, engine, Search,
                                  settings, card)
    torch.cuda.empty_cache()
    with phase_clock(15):
        phase_soak(torch, qk, dh, cs, card)
    torch.cuda.empty_cache()
    with phase_clock(16):
        har = phase_harnesses(torch, qk, dh, cs, engine, Search, settings,
                              card)
    require(set(PHASE_SECONDS) == {"build", *range(1, 17)},
            f"phases timed: {sorted(map(str, PHASE_SECONDS))}")
    print("phase_seconds " + " ".join(
        f"{k}={PHASE_SECONDS[k]:.1f}" for k in ["build", *range(1, 17)])
        + f" total={time.perf_counter() - t_start:.1f}")
    rc, hk = har["runcap"], har["runcap"]["k1"]
    pk = paper["kernels"]

    entries = {
        "gather_and_count": dict(
            launches=ref["launches"]["gather_and_count"], max_abs_err=err,
            library_ms=None,
            streamed_launches=streamed["launches"]["gather_and_count"],
            served_launches=served["launches"][0],
            served_batches=served["batches"],
            sharded_launches=mesh["launches"][0],
            sharded_cards=mesh["cards"],
            sharded_stream_launches=mesh["stream_launches"][0],
            sharded_batches=mesh["batches"],
            sharded_streamed_launches=mesh["streamed_launches"],
            cli_shim_launches=cli["shim"]["gather_and_count"],
            cli_trace_kernels=cli["trace"]["gather_count_kernel"],
            shard_ms=mesh["k1"]["ms"], shard_plain_ms=mesh["k1"]["plain_ms"],
            shard_bound_ms=mesh["k1"]["bound_ms"],
            paper_served_launches=paper["served_launches"][0],
            paper_served_batches=paper["served_batches"],
            paper_group_ms=paper["group"]["k1_ms"],
            paper_group_bound_ms=paper["group"]["k1_bound_ms"],
            **{f"paper_{p}_{key}": pk[p]["k1"][key]
               for p in ("P=98", "P=1") for key in ("ms", "plain_ms",
                                                     "bound_ms")},
            runcap_launches=rc["launches"][0], runcap_batches=rc["batches"],
            **{f"runcap_{v}_group_{key}": hk[v][key]
               for v in hk for key in ("ms", "bound_ms")},
            runcap_capped_group_plain_ms=hk["capped"]["plain_ms"],
            bench_torch_launches=har["bench"]["launches"],
            bench_torch_ms_per_batch=har["bench"]["ms_per_batch"],
            **{f"width_k1_{key}": {w["W"]: w[key]
                                   for w in har["width"]["rows"]}
               for key in ("ms", "plain_ms", "bound_ms")},
            width_launches=har["width"]["launches"],
            mega_launches=har["mega"]["launches"][0],
            mega_batches=har["mega"]["batches"],
            serve_bench_launches=har["serve"]["launches"][0],
            **ref["k1"]),
        "rows_from_queries": dict(
            launches=ref["launches"]["rows_from_queries"], max_abs_err=0,
            library_ms=None,
            streamed_launches=streamed["launches"]["rows_from_queries"],
            served_launches=served["launches"][1],
            served_batches=served["batches"],
            sharded_launches=mesh["launches"][1],
            sharded_cards=mesh["cards"],
            sharded_stream_launches=mesh["stream_launches"][1],
            sharded_batches=mesh["batches"],
            cli_shim_launches=cli["shim"]["rows_from_queries"],
            cli_trace_kernels=cli["trace"]["device_hash_kernel"],
            shard_ms=mesh["hash"]["ms"],
            shard_plain_ms=mesh["hash"]["plain_ms"],
            shard_bound_ms=mesh["hash"]["bound_ms"],
            control_ms=hash5["phase 3"]["control_ms"],
            paper_served_launches=paper["served_launches"][1],
            paper_served_batches=paper["served_batches"],
            **{f"paper_{p}_{key}": pk[p]["hash"][key]
               for p in ("P=98", "P=1") for key in ("ms", "plain_ms",
                                                     "bound_ms")},
            runcap_launches=rc["launches"][1], runcap_batches=rc["batches"],
            mega_launches=har["mega"]["launches"][1],
            mega_batches=har["mega"]["batches"],
            serve_bench_launches=har["serve"]["launches"][1],
            **ref["hash"]),
        "dma_gather_rows": dict(
            launches=k2_launches, max_abs_err=0, ms=k2["ms"],
            plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
            bound_by="bytes", library_ms=k2["library_ms"]),
        "construct_scatter": dict(
            max_abs_err=0, library_ms=None,
            sharded_launches=con_mesh["launches"],
            sharded_cards=con_mesh["cards"],
            cli_shim_launches=cli["shim"]["construct_scatter"],
            shard_ms=con_mesh["ms"], shard_plain_ms=con_mesh["plain_ms"],
            shard_bound_ms=con_mesh["bound_ms"],
            paper_launches=paper["scatter_launches"],
            paper_ms=paper["scatter"]["ms"],
            paper_plain_ms=paper["scatter"]["plain_ms"],
            paper_bound_ms=paper["scatter"]["bound_ms"],
            runcap_launches=rc["scatter_launches"], **con),
    }
    stray = live_children()
    require(not stray, f"child processes still running: {stray}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **entries[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if stop_children():   # only after a failure: main checks for them
            print("chip_smoke: killed child processes left running",
                  file=sys.stderr)
    sys.exit(rc)
