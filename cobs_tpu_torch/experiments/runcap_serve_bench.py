"""Capped run-coalescing A/B on a skewed heterogeneous compact index, on
one CUDA card.

The port of cobs_tpu's experiments/runcap_serve_bench.py, with its
flags, corpus, queries and variants. It builds (once) a 20,480-document
corpus in 4 size tiers (seed 0xCAFE; one `d%05d.fasta` per document)
whose tiers straddle the default 64 B compact page and whose page runs
are skewed: one dominant tier and short tails (sorted by size: runs of
equal-Bloom pages of about [29, 4, 4, 3]), so the uncapped run merge pads
every merged page to the dominant run's width. The port's
`compact_construct` builds it, one hash, the bit scatter kernel on the
card. The same file is loaded three ways in one process:

- `capped`: run-coalesced, the run cap from the cost model
  (`engine._best_run_cap`);
- `uncapped`: COBS_TPU_RUN_CAP=0, runs merged whole;
- `plain`: COBS_TPU_COALESCE_PAGES=0, one device page per file page;

and each serves the same random queries through `Search.search_stream`
(-t 0.8 -l 100, settings.mega_batches 16), the variants in turns for
`--rounds` rounds, the best of each kept. Prints per variant its pages,
row bytes and first page_docs, then

    RESULT name=runcap_serve variant=<v> B=<B> queries_per_s=<q/s>

    python -m cobs_tpu_torch.experiments.runcap_serve_bench DIR \\
        [--queries 32768] [--num-kmers 1000] [--rounds 3] [--batch 1024]

`--device cpu` builds and serves with the kernels' plain versions (tests
and small tiers only).
"""

import argparse
import contextlib
import os
import time
from pathlib import Path

import numpy as np

# cobs_tpu's runcap harness draws its queries as mega_serve_bench does
# (num_kmers + 30 random bases each, seed 0xC0B5)
from cobs_tpu_torch.experiments.paper_scale import random_queries

#: (documents, bases each), in document order
TIERS = ((14848, 150), (2048, 600), (2048, 1800), (1536, 5000))
CORPUS_SEED = 0xCAFE
THRESHOLD, LIMIT = 0.8, 100
#: name -> the environment of its load
VARIANTS = {"capped": {}, "uncapped": {"COBS_TPU_RUN_CAP": "0"},
            "plain": {"COBS_TPU_COALESCE_PAGES": "0"}}
INDEX_NAME = "skew.cobs_compact"


def write_corpus(root: Path, tiers=TIERS) -> Path:
    """root/docs: one FASTA file `>s\\n<seq>\\n` per document, drawn in
    document order from one generator (cobs_tpu's draws: the same files
    for the same tiers)."""
    docs = root / "docs"
    docs.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(CORPUS_SEED)
    bases = np.frombuffer(b"ACGT", np.uint8)
    i = 0
    for n, length in tiers:
        for _ in range(n):
            seq = bases[rng.integers(0, 4, size=length)].tobytes()
            (docs / f"d{i:05d}.fasta").write_bytes(b">s\n" + seq + b"\n")
            i += 1
    return docs


def construct_index(root: Path, device=None) -> Path:
    """root/skew.cobs_compact from root/docs: the port's compact_construct
    (num_hashes 1, defaults otherwise) with the scatter on `device` (None
    = settings.device)."""
    from cobs_tpu_torch import (
        CompactIndexParameters, DocumentList, compact_construct,
    )

    out = root / INDEX_NAME
    compact_construct(DocumentList(root / "docs"), out,
                      index_params=CompactIndexParameters(
                          num_hashes=1, clobber=True, device=device))
    return out


def build_corpus(root: Path, tiers=TIERS, device=None) -> Path:
    """root/skew.cobs_compact, written with its corpus unless it exists."""
    if (root / INDEX_NAME).exists():
        return root / INDEX_NAME
    write_corpus(root, tiers)
    return construct_index(root, device)


@contextlib.contextmanager
def _environ(values: dict):
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


def load_variants(idx: Path, device=None) -> dict:
    """name -> Search over `idx` held on `device`, loaded under the
    variant's environment."""
    from cobs_tpu_torch.query.search import Search

    out = {}
    for name, env in VARIANTS.items():
        with _environ(env):
            out[name] = Search(str(idx), device=device, streamed=False)
    return out


def layout_line(name: str, s) -> str:
    ix = s.index_files[0]
    pd = None if ix.page_docs is None else [int(d) for d in ix.page_docs[:6]]
    return (f"{name}: pages={ix.num_pages} row_bytes={ix.word_width * 4} "
            f"page_docs={pd}")


def rep(s, queries, batch: int, keep: bool = False):
    """(q/s of one search_stream pass at -t 0.8 -l 100, the ranked lists
    if `keep` else None)."""
    got = [] if keep else None
    t0 = time.perf_counter()
    n = 0
    for res in s.search_stream(queries, THRESHOLD, LIMIT, batch_size=batch):
        n += 1
        if keep:
            got.append(res)
    return n / (time.perf_counter() - t0), got


def serve(searches: dict, queries, batch: int, rounds: int, warm_n: int,
          log=print) -> dict:
    """The variants in turns: a warm-up pass of warm_n queries each, then
    `rounds` rounds over all queries; name -> best q/s."""
    for name, s in searches.items():
        log(f"warmup {name}: {rep(s, queries[:warm_n], batch)[0]:.0f} q/s")
    best = {}
    for rnd in range(1, rounds + 1):
        for name, s in searches.items():
            qps = rep(s, queries, batch)[0]
            best[name] = max(best.get(name, 0.0), qps)
            log(f"round {rnd} {name}: {qps:.0f} q/s")
    return best


def result_line(name: str, batch: int, qps: float) -> str:
    return (f"RESULT name=runcap_serve variant={name} B={batch} "
            f"queries_per_s={qps:.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--num-kmers", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from cobs_tpu_torch.query.engine import resolve_device
    from cobs_tpu_torch.settings import settings

    resolve_device(args.device)   # no CUDA: raise before any file
    idx = build_corpus(Path(args.workdir), device=args.device)
    print(f"index={idx} ({idx.stat().st_size >> 20} MiB)", flush=True)
    settings.mega_batches = 16
    searches = load_variants(idx, args.device)
    for name, s in searches.items():
        print(layout_line(name, s), flush=True)
    queries = random_queries(args.queries, args.num_kmers)
    best = serve(searches, queries, args.batch, args.rounds,
                 args.batch * 16, log=lambda m: print(m, flush=True))
    for name, qps in best.items():
        print(result_line(name, args.batch, qps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
