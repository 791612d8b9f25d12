"""`cobs` command line of the PyTorch port: `query` and `benchmark-fpr`.

Same flags, defaults and output as those subtools in cobs_tpu/cli/main.py
(reference: src/cobs.cpp:471-527, 605-730), plus `--device`:

    python -m cobs_tpu_torch.cli.main query -i INDEX [-t 0.8] [-l 0] \\
        [--streamed | --load-complete] [--device cuda] \\
        (QUERY | -f QUERIES.fa)
    python -m cobs_tpu_torch.cli.main benchmark-fpr INDEX [-q 10000] \\
        [-k 1000] [-b 64] [-l 0] [--streamed] [--cold] [--device cuda]
"""

import argparse
import sys
import time

import numpy as np

from cobs_tpu_torch.fmt.magic import FileIOError


def _read_fasta_queries(path) -> tuple[list[str], list[str]]:
    """(comments, sequences) of a FASTA query file; each comment is the
    header line with its '>' or ';' replaced by '*'."""
    comments, queries = [], []
    comment, parts = "", []
    with open(path) as qf:
        for line in qf:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] in ">;":
                if parts:
                    comments.append(comment)
                    queries.append("".join(parts))
                comment, parts = "*" + line[1:], []
            else:
                parts.append(line)
    if parts:
        comments.append(comment)
        queries.append("".join(parts))
    return comments, queries


def cmd_query(argv):
    p = argparse.ArgumentParser(prog="cobs query")
    p.add_argument("-i", "--index", action="append", default=[],
                   help="path to index file(s)")
    p.add_argument("query", nargs="?", default="",
                   help="the text sequence to search for")
    p.add_argument("-f", "--file", default="",
                   help="query (fasta) file to process")
    p.add_argument("-t", "--threshold", type=float, default=0.8,
                   help="threshold in percentage of terms in query "
                        "matching, default: 0.8")
    p.add_argument("-l", "--limit", type=int, default=0,
                   help="number of results to return, default: all")
    p.add_argument("--load-complete", action="store_true",
                   help="load the whole index onto the device, whatever "
                        "its size")
    p.add_argument("--streamed", action="store_true",
                   help="serve the index from a host mmap (for indexes "
                        "larger than device memory)")
    p.add_argument("--device", default=None,
                   help="torch device holding the index, default: "
                        "settings.device (cuda)")
    args = p.parse_args(argv)

    from cobs_tpu_torch.query.search import Search

    if args.streamed and args.load_complete:
        print("Pass at most one of --streamed and --load-complete.",
              file=sys.stderr)
        return -1
    s = Search(args.index, device=args.device,
               streamed=(True if args.streamed
                         else False if args.load_complete else None))
    if args.query:
        for res in s.search(args.query, args.threshold, args.limit):
            print(f"{res.doc_name}\t{res.score}")
    elif args.file:
        # FASTA query file: batch all sequences into one kernel launch
        comments, queries = _read_fasta_queries(args.file)
        results = s.search_batch(queries, args.threshold, args.limit)
        for comment, result in zip(comments, results):
            print(f"{comment}\t{len(result)}")
            for res in result:
                print(f"{res.doc_name}\t{res.score}")
    else:
        print("Pass a verbatim query or a query file.", file=sys.stderr)
        return -1
    s.timer().print("search")
    return 0


def cmd_benchmark_fpr(argv):
    p = argparse.ArgumentParser(prog="cobs benchmark-fpr")
    p.add_argument("in_file")
    p.add_argument("-k", "--num-kmers", type=int, default=1000)
    p.add_argument("-q", "--queries", type=int, default=10000)
    p.add_argument("-w", "--warmup", type=int, default=100)
    p.add_argument("-d", "--dist", action="store_true",
                   help="calculate false positive distribution")
    p.add_argument("-b", "--batch", type=int, default=64,
                   help="queries per device batch")
    p.add_argument("-t", "--threshold", type=float, default=0.0,
                   help="score threshold fraction (reference query "
                        "default is 0.8)")
    p.add_argument("-l", "--limit", type=int, default=0,
                   help="top-k results per query (0 = full ranking)")
    p.add_argument("--streamed", action="store_true",
                   help="benchmark the host-mmap streamed backend")
    p.add_argument("--cold", action="store_true",
                   help="read rows past the OS page cache (io_uring "
                        "RWF_DONTCACHE, else evict the index after every "
                        "batch; implies --streamed) so numbers reflect "
                        "disk, not cache")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device holding the index, default: "
                        "settings.device (cuda)")
    args = p.parse_args(argv)

    from cobs_tpu_torch.query.engine import StreamedIndex
    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.utils.misc import random_sequence_rng

    rng = np.random.default_rng(args.seed)
    backend = None
    if args.streamed or args.cold:
        backend = StreamedIndex(args.in_file, device=args.device,
                                drop_cache=args.cold)
        s = Search(backend)
    else:
        s = Search(args.in_file, device=args.device)
    # at least one whole batch of warm-up: the first batch builds and
    # loads the CUDA kernels
    warmup = [random_sequence_rng(args.num_kmers + 30, rng)
              for _ in range(max(args.warmup, args.batch))]
    queries = [random_sequence_rng(args.num_kmers + 30, rng)
               for _ in range(args.queries)]
    for _ in s.search_stream(warmup, threshold=args.threshold,
                             num_results=args.limit,
                             batch_size=args.batch):
        pass
    s.timer().reset()
    if args.cold:
        backend.drop_cache()  # the measured loop starts cold too

    counts: dict[int, int] = {}
    t0 = time.perf_counter()
    last_result = []
    for res_list in s.search_stream(queries, threshold=args.threshold,
                                    num_results=args.limit,
                                    batch_size=args.batch):
        # reference parity: results= is the LAST query's hit count
        # (reference: src/cobs.cpp:655)
        last_result = res_list
        if args.dist:
            for r in res_list:
                counts[r.score] = counts.get(r.score, 0) + 1
    elapsed = time.perf_counter() - t0

    t = s.timer()
    print("RESULT"
          " name=benchmark "
          f" index={args.in_file}"
          f" kmer_queries={len(queries[0]) - 30}"
          f" queries={len(queries)}"
          f" warmup={len(warmup)}"
          f" results={len(last_result)}"
          f" batch={args.batch}"
          f" backend={'device' if backend is None else 'streamed'}"
          f" cold={_cold_mode(args.cold)}"
          f" t_hashes={t.get('hashes')}"
          f" t_io={t.get('io')}"
          f" t_and={t.get('and rows')}"
          f" t_add={t.get('add rows')}"
          f" t_sort={t.get('sort results')}"
          f" t_total={elapsed}"
          f" queries_per_s={len(queries) / elapsed}")
    for score in sorted(counts):
        print(f"RESULT name=benchmark_fpr fpr={score} dist={counts[score]}")
    return 0


def _cold_mode(cold: bool) -> str:
    """How the RESULT line's run was kept cold: on-dontcache when the
    reads bypassed the page cache (RWF_DONTCACHE, the reference's
    O_DIRECT analog), on-evict when the index was evicted after every
    batch instead."""
    if not cold:
        return "off"
    from cobs_tpu_torch import native

    return "on-dontcache" if native.dontcache_supported() else "on-evict"


SUBTOOLS = {
    "query": (cmd_query, "query an index"),
    "benchmark-fpr": (cmd_benchmark_fpr,
                      "run a query benchmark over random queries"),
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: cobs <subtool> ...\n\nSubtools:")
        for name, (_fn, help_) in SUBTOOLS.items():
            print(f"  {name:28s} {help_}")
        return 0 if argv else -1
    name, rest = argv[0], argv[1:]
    if name not in SUBTOOLS:
        print(f"Unknown subtool '{name}'", file=sys.stderr)
        return -1
    try:
        return SUBTOOLS[name][0](rest)
    except (ValueError, FileNotFoundError, RuntimeError, FileIOError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
