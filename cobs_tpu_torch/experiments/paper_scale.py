"""Reference-paper-scale end to end on the port: generate a corpus,
compact-construct it out of core, repack, verify planted queries, serve.

The port of cobs_tpu's experiments/paper_scale.py, with its stages,
flags, defaults and constants: a 100,000-document FASTA corpus of
20,000 bp each (one file per document, 1,000 per subdirectory, drawn
from the same seed, so both packages write byte-identical corpora),
`compact-construct --memory 256MiB --clobber` through the port's CLI (on
the card: the bit scatter kernel sets the Bloom bits; every compact page
is its own classic sub-index, built in batches that fit the memory and
combined per page, so the matrix is never held whole), then `repack`
(equal Bloom sizes merge into one wide page, bit-preserving), planted
queries verified exactly, and `Search.search_stream` timed.

    python -m cobs_tpu_torch.experiments.paper_scale gen    DIR [--docs 100000] [--doc-size 20000]
    python -m cobs_tpu_torch.experiments.paper_scale build  DIR [--memory 256MiB]
    python -m cobs_tpu_torch.experiments.paper_scale verify DIR
    python -m cobs_tpu_torch.experiments.paper_scale serve  DIR [--queries 16384] \\
        [--batch 512] [--mega 8] [--streamed]

Every stage runs on the card (`--device cuda`, the default); `--device
cpu` runs the kernels' plain versions on the CPU, for small corpora.

Planted ground truth: document i with i % PLANT_EVERY == 0 holds the
31-mer-rich PLANT_SEQ at a document-dependent offset, so `verify` knows
the exact positives, each at full score.
"""

import argparse
import concurrent.futures
import time
from pathlib import Path

import numpy as np

PLANT_SEQ = ("AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
             "GATGGTACCTTAGCAGGTCCAGGGTCGATGGATCCTTAAGGCAATTCGAG")
PLANT_EVERY = 9973  # docs i with i % PLANT_EVERY == 0 carry PLANT_SEQ
SEED = 0xC0B5
TERM_SIZE = 31


def random_queries(n, num_kmers, term_size=TERM_SIZE, seed=SEED):
    """n random ACGT queries of num_kmers terms (cobs_tpu's
    experiments/mega_serve_bench.py draws, in the same order)."""
    rng = np.random.default_rng(seed)
    length = num_kmers + term_size - 1
    codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    return [bytes(alphabet[c]) for c in codes]


def gen(root: Path, n_docs: int, doc_size: int = 20_000,
        seed: int = SEED) -> None:
    """One .fasta per document under root/docs, 1,000 per subdirectory.
    Every document has exactly doc_size bases, so every compact page gets
    the same Bloom size and `repack` merges them all (the planted
    sequence overwrites a slice in place, keeping the length). The
    sequences are drawn in document order from one generator; the files
    are written by a pool of threads, a subdirectory at a time."""
    docs = root / "docs"
    docs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        pending = []
        for i in range(n_docs):
            seq = bases[rng.integers(0, 4, size=doc_size)].tobytes()
            if i % PLANT_EVERY == 0:
                off = 17 * (i % 97) + 11
                seq = (seq[:off] + PLANT_SEQ.encode()
                       + seq[off + len(PLANT_SEQ):])
            sub = docs / f"{i // 1000:03d}"
            if i % 1000 == 0:
                # at most two subdirectories' files held in memory
                for f in pending[:-1000]:
                    f.result()
                pending = pending[-1000:]
                sub.mkdir(exist_ok=True)
            pending.append(pool.submit((sub / f"doc{i:06d}.fasta")
                                       .write_bytes, b">s\n" + seq + b"\n"))
            if (i + 1) % 10000 == 0:
                dt = time.perf_counter() - t0
                print(f"gen {i + 1}/{n_docs} ({dt:.0f}s)", flush=True)
        for f in pending:
            f.result()
    print(f"gen done: {n_docs} docs x {doc_size} bp = "
          f"{n_docs * doc_size / 1e9:.2f} GB, "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


def build(root: Path, memory: str, device: str = "cuda") -> dict:
    """compact-construct root/docs into root/paper.cobs_compact, then
    repack it into root/paper_wide.cobs_compact, both through the port's
    CLI. Returns each step's exit code and seconds."""
    from cobs_tpu_torch.cli.main import main as cli

    out = root / "paper.cobs_compact"
    t0 = time.perf_counter()
    rc = cli(["compact-construct", str(root / "docs"), str(out),
              "--memory", memory, "--clobber", "--device", device])
    construct_s = time.perf_counter() - t0
    print(f"RESULT name=paper_construct docs_dir={root / 'docs'} "
          f"memory={memory} rc={rc} seconds={construct_s:.1f}", flush=True)
    t0 = time.perf_counter()
    repack_rc = cli(["repack", str(out),
                     str(root / "paper_wide.cobs_compact")])
    repack_s = time.perf_counter() - t0
    print(f"RESULT name=paper_repack rc={repack_rc} "
          f"seconds={repack_s:.1f}", flush=True)
    return {"construct_rc": rc, "construct_s": construct_s,
            "repack_rc": repack_rc, "repack_s": repack_s}


def planted(root: Path) -> tuple[int, list[int]]:
    """(documents in the corpus, the planted document numbers)."""
    n_docs = sum(1 for _ in (root / "docs").rglob("doc*.fasta"))
    return n_docs, list(range(0, n_docs, PLANT_EVERY))


def check_planted(search, n_docs: int, plants: list[int],
                  name: str) -> list:
    """PLANT_SEQ at threshold 0.9 through `search` returns exactly the
    planted documents at full score, and every other score is below 0.9
    of it. Returns the ranking as (document, score) pairs."""
    T = len(PLANT_SEQ) - TERM_SIZE + 1
    want = sorted(f"doc{i:06d}" for i in plants)
    res = search.search(PLANT_SEQ, threshold=0.9)
    got = sorted(r.doc_name for r in res if r.score == T)
    if got != want:
        raise RuntimeError(f"{name}: planted positives {got[:5]} != "
                           f"{want[:5]}")
    if not all(r.score == T or r.score < 0.9 * T for r in res):
        raise RuntimeError(f"{name}: a score between 0.9 x {T} and {T}")
    print(f"verify {name}: {len(want)} planted positives exact "
          f"(score {T}/{T}) among {n_docs} docs", flush=True)
    return [(r.doc_name, r.score) for r in res]


def verify(root: Path, device: str = "cuda") -> None:
    """Planted queries return exactly the planted documents at full
    score on both the construction's output and the repacked index."""
    from cobs_tpu_torch.query.search import Search

    n_docs, plants = planted(root)
    for name in ("paper.cobs_compact", "paper_wide.cobs_compact"):
        check_planted(Search(str(root / name), device=device), n_docs,
                      plants, name)


def serve(root: Path, n_queries: int, batch: int, mega: int,
          streamed: bool, num_kmers: int = 1000,
          device: str = "cuda") -> dict:
    """search_stream over n_queries random queries of num_kmers terms on
    root/paper_wide.cobs_compact (held on `device`, or streamed from the
    host mmap), top 100 at threshold 0.8, settings.mega_batches = mega,
    after one warm-up group; two timed rounds. Returns the open seconds,
    each round's q/s and the open `Search`."""
    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.settings import settings

    old_mega = settings.mega_batches
    settings.mega_batches = mega
    try:
        idx = root / "paper_wide.cobs_compact"
        t0 = time.perf_counter()
        s = Search(str(idx), device=device,
                   streamed=True if streamed else None)
        open_s = time.perf_counter() - t0
        print(f"open+upload: {open_s:.1f}s", flush=True)
        queries = random_queries(n_queries, num_kmers)
        # the first launches build and load the kernels: off the clock
        for _ in s.search_stream(queries[:batch * max(1, mega)], 0.8, 100,
                                 batch_size=batch):
            pass
        qps = []
        for rnd in range(2):
            t0 = time.perf_counter()
            n = sum(1 for _ in s.search_stream(queries, 0.8, 100,
                                               batch_size=batch))
            dt = time.perf_counter() - t0
            qps.append(n / dt)
            print(f"RESULT name=paper_serve round={rnd} B={batch} "
                  f"mega={mega} streamed={int(streamed)} queries={n} "
                  f"queries_per_s={n / dt:.1f}", flush=True)
    finally:
        settings.mega_batches = old_mega
    return {"open_s": open_s, "qps": qps, "search": s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cobs_tpu_torch.experiments.paper_scale")
    ap.add_argument("stage", choices=["gen", "build", "verify", "serve"])
    ap.add_argument("dir")
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--doc-size", type=int, default=20_000)
    ap.add_argument("--memory", default="256MiB")
    ap.add_argument("--queries", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--mega", type=int, default=8)
    ap.add_argument("--streamed", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every stage (default: cuda)")
    args = ap.parse_args(argv)
    root = Path(args.dir)
    if args.stage == "gen":
        gen(root, args.docs, args.doc_size)
    elif args.stage == "build":
        rcs = build(root, args.memory, args.device)
        return 0 if rcs["construct_rc"] == rcs["repack_rc"] == 0 else 1
    elif args.stage == "verify":
        verify(root, args.device)
    else:
        serve(root, args.queries, args.batch, args.mega, args.streamed,
              device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
