#!/usr/bin/env python3
"""Smoke test of the cobs_tpu_torch query path on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernel from the sources in this checkout, then runs four
phases, each ending in torch.cuda.synchronize():

1. the gather-and-count kernel against its plain PyTorch twin at mixed
   shapes (T, h, P, W), exact;
2. `Search` on the committed golden indexes (tests/data/golden) on the
   card: the reference's result lines, and the kernel launched;
3. the reference's default scale (`cobs classic-construct-random`
   defaults, reference src/cobs.cpp:243-291): 10,000 documents,
   2^21 Bloom rows, one hash, k=31; a random matrix made on the card from
   a seed; 64 random 1,030 bp queries through
   `Search.search_batch(threshold=0, num_results=100)`. The kernel's full
   score tensors and top-k pairs equal the twin's, the ranked results
   equal a numpy ranking of the twin's scores, and both are timed;
4. wide rows: 2^21 rows x 3,136 words (100,352 documents, a 26.3 GB
   matrix, past int32 word offsets), kernel against twin, exact.

Prints the card's name and power limit, the build time, the times, then
a JSON line of the kernels and, last, the device JSON line. Any failure
raises and exits non-zero; so does a machine without a CUDA card.
"""

import json
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
KERNEL_SOURCE = "cobs_tpu_torch/ops/csrc/gather_count.cu"
KERNEL_REPLACES = "cobs_tpu/ops/query_kernel.py:171"
DEVICE = "cuda"


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(torch, fn, reps: int = 20) -> float:
    """Median over `reps` of one call's device time (CUDA events), after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def random_matrix(torch, rows: int, words: int, seed: int):
    """int32 [rows + 1, words] of uniform random bits made on the card in
    stripes, with the all-zero last row."""
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    m = torch.empty((rows + 1, words), dtype=torch.int32, device=DEVICE)
    stripe = max(1, (256 << 20) // (words * 8))
    for r0 in range(0, rows, stripe):
        r1 = min(rows, r0 + stripe)
        m[r0:r1] = torch.randint(-2**31, 2**31, (r1 - r0, words),
                                 generator=g, device=DEVICE,
                                 dtype=torch.int64).to(torch.int32)
    m[rows] = 0
    return m


def max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item())


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
                    require(err == 0, f"kernel != twin at B={B} T={T} "
                                      f"h={h} P={P} W={W}: {err}")
                    worst = max(worst, err)
    print("phase 1 mixed shapes: kernel == twin at 48 shapes")
    return worst


def phase_golden(torch, qk, Search) -> None:
    for name in ("fasta7.cobs_classic", "fasta7.cobs_compact"):
        before = qk.LAUNCHES
        s = Search(str(GOLDEN_DIR / name), device=DEVICE)
        got = [(r.doc_name, r.score)
               for r in s.search(GOLDEN_QUERY, threshold=0.0)]
        top = [(r.doc_name, r.score)
               for r in s.search(GOLDEN_QUERY, 0.0, num_results=3)]
        torch.cuda.synchronize()
        require(got == GOLDEN_LINES, f"{name}: {got}")
        require(top == GOLDEN_LINES[:3], f"{name} top 3: {top}")
        require(qk.LAUNCHES >= before + 2, f"{name}: kernel not launched")
        print(f"phase 2 golden {name}: {got}")


def phase_reference_scale(torch, qk, engine, Search, card: str,
                          rows: int = 1 << 21, B: int = 64) -> dict:
    W, docs, L, k = 384, 10_000, 1030, 100
    ix = engine.DeviceIndex.from_arrays(
        random_matrix(torch, rows, W, seed=1), [0], [rows], W,
        term_size=31, canonicalize=1, num_hashes=1, page_size=docs // 8,
        file_names=[f"doc{i:05d}" for i in range(docs)], device=DEVICE)
    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    queries = [acgt[rng.integers(0, 4, L)].tobytes().decode()
               for _ in range(B)]
    s = Search(ix)
    torch.cuda.synchronize()

    qk.LAUNCHES = 0
    results = s.search_batch(queries, threshold=0.0, num_results=k)
    torch.cuda.synchronize()
    launches = qk.LAUNCHES
    require(launches > 0, "Search.search_batch did not launch the kernel")

    hashes = engine.create_hashes([q.encode() for q in queries], 31, 1, 1)
    r = engine._rows_tensor(ix, hashes)
    got = qk.gather_and_count(ix.matrix, r, 1)
    want = qk.gather_and_count_reference(ix.matrix, r, 1)
    err = max_err(got, want)
    kv, ks = engine.topk_slots(got, ix.valid_mask, k)
    tv, ts = engine.topk_slots(want, ix.valid_mask, k)
    torch.cuda.synchronize()
    require(err == 0, f"reference scale: kernel != twin, {err}")
    require(torch.equal(kv, tv) and torch.equal(ks, ts),
            "reference scale: top-k pairs differ")
    twin = engine._strip_word_padding(want.cpu().numpy(), B, ix.doc_layout)
    for b in range(B):
        sc = twin[b, :docs]
        order = np.lexsort((np.arange(docs), -sc))[:k]
        expect = [(f"doc{i:05d}", int(sc[i])) for i in order]
        require([(x.doc_name, x.score) for x in results[b]] == expect,
                f"reference scale: query {b} ranking differs")

    ms = median_ms(torch, lambda: qk.gather_and_count(ix.matrix, r, 1))
    plain_ms = median_ms(
        torch, lambda: qk.gather_and_count_reference(ix.matrix, r, 1))
    s.timer_.reset()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        s.search_batch(queries, threshold=0.0, num_results=k)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"phase 3 reference scale (B={B} T={L - 30} h=1 P=1 W={W}, "
          f"{rows}+1 rows, {card}): kernel {ms:.4f} ms "
          f"({B / ms * 1e3:.0f} q/s), twin {plain_ms:.4f} ms "
          f"({B / plain_ms * 1e3:.0f} q/s); Search.search_batch "
          f"wall {wall * 1e3:.3f} ms ({B / wall:.0f} q/s)")
    print("phase 3 Search timer over 5 batches: " + " ".join(
        f"{n}={s.timer_.get(n) / 5 * 1e3:.3f}ms"
        for n in ("hashes", "io", "sort results")))
    return {"launches": launches, "err": err, "ms": ms,
            "plain_ms": plain_ms}


def phase_wide_rows(torch, qk, card: str, rows: int = 1 << 21,
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
    require(err == 0, f"wide rows: kernel != twin, {err}")
    ms = median_ms(torch, lambda: qk.gather_and_count(m, r, 1), reps=10)
    plain_ms = median_ms(
        torch, lambda: qk.gather_and_count_reference(m, r, 1), reps=10)
    print(f"phase 4 wide rows (B={B} T={T} h=1 P=1 W={W}, {rows}+1 rows, "
          f"{card}): kernel {ms:.4f} ms ({B / ms * 1e3:.0f} q/s), "
          f"twin {plain_ms:.4f} ms ({B / plain_ms * 1e3:.0f} q/s)")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from cobs_tpu_torch.ops import _build
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.query import engine
    from cobs_tpu_torch.query.search import Search

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load("gather_count")
    print(f"build gather_count.cu: {time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get("gather_count", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    err = phase_mixed_shapes(torch, qk, np.random.default_rng(0))
    phase_golden(torch, qk, Search)
    ref = phase_reference_scale(torch, qk, engine, Search, card)
    torch.cuda.empty_cache()
    err = max(err, ref["err"], phase_wide_rows(torch, qk, card))

    print(json.dumps({"kernels": [{
        "name": "gather_and_count", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": ref["launches"], "max_abs_err": err,
        "ms": ref["ms"], "plain_ms": ref["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
