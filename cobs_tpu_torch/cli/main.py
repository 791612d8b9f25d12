"""`cobs` command line of the PyTorch port: the `query` subtool.

Same flags, defaults and output as `cobs query` in cobs_tpu/cli/main.py
(reference: src/cobs.cpp:471-527), plus `--device`:

    python -m cobs_tpu_torch.cli.main query -i INDEX [-t 0.8] [-l 0] \\
        [--device cuda] (QUERY | -f QUERIES.fa)
"""

import argparse
import sys

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
    p.add_argument("--device", default=None,
                   help="torch device holding the index, default: "
                        "settings.device (cuda)")
    args = p.parse_args(argv)

    from cobs_tpu_torch.query.search import Search

    s = Search(args.index, device=args.device)
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


SUBTOOLS = {
    "query": (cmd_query, "query an index"),
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
