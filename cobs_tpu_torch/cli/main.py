"""`cobs` command line of the PyTorch port: the 16 subtools of
cobs_tpu/cli/main.py, with the same flags, defaults and output
(reference: src/cobs.cpp:970-1016), plus `--device` where a command uses
the device. `info` differs only in its page-size `hint:` line, and
`doctor` probes a torch device and reports the CUDA kernels' builds:

    python -m cobs_tpu_torch.cli.main doc-list PATH [--file-type any] [-k 31]
    python -m cobs_tpu_torch.cli.main doc-dump PATH [-k 31] \\
        [--no-canonicalize]
    python -m cobs_tpu_torch.cli.main classic-construct INPUT OUT.cobs_classic \\
        [-h 1] [-f 0.3] [-k 31] [-m MEM] [-T THREADS] [-C] [--continue] \\
        [--keep-temporary] [--tmp-path DIR] [--device cuda]
    python -m cobs_tpu_torch.cli.main compact-construct INPUT OUT.cobs_compact \\
        [the same flags] [-p PAGE_SIZE]
    python -m cobs_tpu_torch.cli.main classic-construct-random OUT \\
        [-s 2Mi] [-n 10000] [-m 1000000] [-h 1] [--seed S]
    python -m cobs_tpu_torch.cli.main compact-construct-combine DIR OUT \\
        [-p 8192]
    python -m cobs_tpu_torch.cli.main repack IN OUT [-p 0] [--clobber]
    python -m cobs_tpu_torch.cli.main query -i INDEX [-t 0.8] [-l 0] \\
        [--streamed | --load-complete] [-T THREADS] [--device cuda] \\
        [--mesh N] [--profile DIR] (QUERY | -f QUERIES.fa)
    python -m cobs_tpu_torch.cli.main benchmark-fpr INDEX [-q 10000] \\
        [-k 1000] [-b 64] [-l 0] [--streamed] [--cold] [--device cuda]
    python -m cobs_tpu_torch.cli.main serve -i INDEX [--socket PATH | \\
        --host H --port 7687] [-t 0.8] [-l 0] [-b 64] [--linger-ms 2] \\
        [--warmup LEN] [--log-interval S] [--stall-timeout 300] \\
        [--slo-ms MS] [--streamed | --load-complete] [--device cuda] \\
        [--mesh N]
    python -m cobs_tpu_torch.cli.main benchmark-scaling [-n N] \\
        [--docs-per-shard 4096] [--sig-size 262144] [-b 16] \\
        [--num-kmers 1000] [--iterations 10] [--batch-sweep B,B] \\
        [--device cuda]
    python -m cobs_tpu_torch.cli.main info INDEX [--scan]
    python -m cobs_tpu_torch.cli.main doctor [--timeout 60] [--device cuda]
    python -m cobs_tpu_torch.cli.main print-parameters [-h 1] [-f 0.3] \\
        [-n NUM_ELEMENTS]
    python -m cobs_tpu_torch.cli.main print-kmers QUERY [-k 31]
    python -m cobs_tpu_torch.cli.main generate-queries PATH [-k 31] \\
        [-p POSITIVE] [-n NEGATIVE] [-N] [-s SIZE] [-S SEED] [-o OUT]

Construction sets the Bloom bits on the device (the bit scatter kernel on
a CUDA card; `--device cpu` runs its plain version); `--device-construct`
is accepted for the reference CLI's sake and is the default. Without
CUDA, a command that uses the device raises unless given `--device cpu`.
`--mesh N` shards each index over the first N visible devices of
`--device` (document-axis sharding, parallel/sharded.py); N beyond them
raises.
"""

import argparse
import contextlib
import sys
import time
from pathlib import Path

import numpy as np

from cobs_tpu_torch.fmt.magic import FileIOError
from cobs_tpu_torch.settings import settings

FILE_TYPE_HELP = (
    'filter documents by file type (any, text, cortex, cobs, fasta, '
    'fastq, fasta_multi, fastq_multi, list)')


def _add_threads_flag(p):
    p.add_argument("-T", "--threads", type=int, default=None,
                   help="number of threads to use, default: max cores")


def _apply_threads(args):
    if args.threads:
        settings.threads = args.threads


def _add_device_flag(p, what: str):
    p.add_argument("--device", default=None,
                   help=f"torch device {what}, default: settings.device "
                        "(cuda)")


def _add_mesh_flag(p):
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the index over the first N devices "
                        "(document-axis sharding), default: 0 = one "
                        "device")


def _mesh(args):
    """The --mesh N mesh over the first N visible devices of --device, or
    None; raises when fewer are visible."""
    if not args.mesh:
        return None
    from cobs_tpu_torch.parallel.sharded import make_mesh, visible_devices

    return make_mesh(1, args.mesh, visible_devices(args.device))


def _parser_with_num_hashes(prog) -> argparse.ArgumentParser:
    """Parser whose `-h` means --num-hashes, as in the reference CLI
    (reference: src/cobs.cpp:186); help stays available as --help."""
    p = argparse.ArgumentParser(prog=prog, add_help=False)
    p.add_argument("--help", action="help",
                   help="show this help message and exit")
    return p


def _add_num_hashes_flag(p):
    p.add_argument("-h", "-h2", "--num-hashes", type=int, default=1,
                   dest="num_hashes",
                   help="number of hash functions, default: 1")


def _parse_bytes(s: str) -> int:
    """Parse '4G', '512M', '2Mi' style byte sizes."""
    s = s.strip()
    mult = 1
    suffixes = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    low = s.lower()
    for suf, m in suffixes.items():
        if low.endswith((suf + "i", suf + "ib", suf + "b", suf)):
            mult = m
            s = s[:low.find(suf)]
            break
    return int(float(s) * mult)


# ---------------------------------------------------------------- doc tools

def _print_document_list(filelist, term_size, os_=None):
    os_ = os_ or sys.stdout
    print("--- document list (" + str(filelist.size()) + " entries) ---",
          file=os_)
    total, min_t, max_t = 0, None, 0
    for i, e in enumerate(filelist.list()):
        t = e.num_terms(term_size)
        total += t
        min_t = t if min_t is None else min(min_t, t)
        max_t = max(max_t, t)
        print(f"document[{i}] size {e.size} {e.type.name} "
              f"terms {t} : {e.path} : {e.name}", file=os_)
    print(f"--- end of document list ({filelist.size()} entries) ---",
          file=os_)
    print(f"documents: {filelist.size()}", file=os_)
    if filelist.size():
        print(f"minimum {term_size}-mers: {min_t}", file=os_)
        print(f"maximum {term_size}-mers: {max_t}", file=os_)
        print(f"average {term_size}-mers: "
              f"{int(total / filelist.size())}", file=os_)
        print(f"total {term_size}-mers: {total}", file=os_)


def cmd_doc_list(argv):
    p = argparse.ArgumentParser(prog="cobs doc-list")
    p.add_argument("path")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    p.add_argument("-k", "--term-size", type=int, default=31)
    args = p.parse_args(argv)

    from cobs_tpu_torch.ingest.document_list import (
        DocumentList,
        string_to_file_type,
    )
    filelist = DocumentList(args.path, string_to_file_type(args.file_type))
    _print_document_list(filelist, args.term_size)
    return 0


def cmd_doc_dump(argv):
    p = argparse.ArgumentParser(prog="cobs doc-dump")
    p.add_argument("path")
    p.add_argument("-k", "--term-size", type=int, default=31)
    p.add_argument("--no-canonicalize", action="store_true")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    args = p.parse_args(argv)

    from cobs_tpu_torch.core.canonical import canonicalize_batch
    from cobs_tpu_torch.ingest.document_list import (
        DocumentList,
        string_to_file_type,
    )
    filelist = DocumentList(args.path, string_to_file_type(args.file_type))
    print(f"Found {filelist.size()} documents.", file=sys.stderr)
    for i, e in enumerate(filelist.list()):
        print(f"document[{i}] : {e.path} : {e.name}", file=sys.stderr)
        count = 0
        for w in e.term_windows(args.term_size):
            count += w.shape[0]
            if args.no_canonicalize:
                for row in w:
                    sys.stdout.write(row.tobytes().decode() + "\n")
            else:
                canon, good = canonicalize_batch(w)
                for row, g, raw in zip(canon, good, w):
                    if not g:
                        sys.stdout.write("Invalid DNA base pair: "
                                         + raw.tobytes().decode() + "\n")
                    else:
                        sys.stdout.write(row.tobytes().decode() + "\n")
        sys.stdout.flush()
        print(f"document[{i}] : {count} terms.", file=sys.stderr)
    return 0


# ------------------------------------------------------------- construction

def _construct_common_flags(p, compact=False):
    p.add_argument("input", help="path to the input directory or file")
    p.add_argument("out_file", help="path to the output index file")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    p.add_argument("-m", "--memory", default=None,
                   help="memory in bytes to use")
    _add_num_hashes_flag(p)
    p.add_argument("-f", "--false-positive-rate", type=float, default=0.3)
    p.add_argument("-k", "--term-size", type=int, default=31)
    p.add_argument("--no-canonicalize", action="store_true")
    p.add_argument("-C", "--clobber", action="store_true",
                   help="erase output directory if it exists")
    p.add_argument("--continue", dest="continue_", action="store_true",
                   help="continue in existing output directory")
    _add_threads_flag(p)
    p.add_argument("--keep-temporary", action="store_true")
    p.add_argument("--tmp-path", default=None)
    p.add_argument("--device-construct", action="store_true",
                   help="set the Bloom bits on the device (the default; "
                        "accepted for the reference CLI)")
    _add_device_flag(p, "that sets the Bloom bits")
    if compact:
        p.add_argument("-p", "--page-size", type=int, default=0,
                       help="page size of the compact index, "
                            "default: sqrt(#documents)")


def _construct(argv, prog: str, compact: bool) -> int:
    p = _parser_with_num_hashes(prog)
    _construct_common_flags(p, compact)
    args = p.parse_args(argv)
    _apply_threads(args)

    import cobs_tpu_torch
    from cobs_tpu_torch.ingest.document_list import (
        DocumentList,
        string_to_file_type,
    )
    common = dict(term_size=args.term_size,
                  canonicalize=0 if args.no_canonicalize else 1,
                  num_hashes=args.num_hashes,
                  false_positive_rate=args.false_positive_rate,
                  clobber=args.clobber, continue_=args.continue_,
                  keep_temporary=args.keep_temporary, device=args.device)
    params = (cobs_tpu_torch.CompactIndexParameters(
        page_size=args.page_size, **common) if compact
        else cobs_tpu_torch.ClassicIndexParameters(**common))
    if args.memory:
        params.mem_bytes = _parse_bytes(args.memory)
    if args.threads:
        params.num_threads = args.threads

    filelist = DocumentList(args.input, string_to_file_type(args.file_type))
    _print_document_list(filelist, params.term_size, sys.stderr)
    build = (cobs_tpu_torch.compact_construct if compact
             else cobs_tpu_torch.classic_construct)
    build(filelist, args.out_file, args.tmp_path, params)
    return 0


def cmd_classic_construct(argv):
    return _construct(argv, "cobs classic-construct", compact=False)


def cmd_compact_construct(argv):
    return _construct(argv, "cobs compact-construct", compact=True)


def cmd_classic_construct_random(argv):
    p = _parser_with_num_hashes("cobs classic-construct-random")
    p.add_argument("out_file")
    p.add_argument("-s", "--signature-size", default=str(2 * 1024 * 1024),
                   help="number of bits of the signatures, default: 2 Mi")
    p.add_argument("-n", "--num-documents", type=int, default=10000)
    p.add_argument("-m", "--document-size", type=int, default=1000000)
    _add_num_hashes_flag(p)
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    from cobs_tpu_torch.construct.classic import classic_construct_random
    seed = args.seed if args.seed is not None else \
        int.from_bytes(np.random.bytes(4), "little")
    classic_construct_random(
        args.out_file, _parse_bytes(args.signature_size),
        args.num_documents, args.document_size, args.num_hashes, seed)
    return 0


def cmd_compact_construct_combine(argv):
    p = argparse.ArgumentParser(prog="cobs compact-construct-combine")
    p.add_argument("in_dir")
    p.add_argument("out_file")
    p.add_argument("-p", "--page-size", type=int, default=8192,
                   help="page size of the compact index, default: 8192")
    args = p.parse_args(argv)

    from cobs_tpu_torch.construct.compact import compact_combine_into_compact
    compact_combine_into_compact(args.in_dir, args.out_file, args.page_size)
    return 0


def cmd_repack(argv):
    p = argparse.ArgumentParser(prog="cobs repack")
    p.add_argument("in_file", help="compact index to repack")
    p.add_argument("out_file", help="output compact index")
    p.add_argument("-p", "--page-size", type=int, default=0,
                   help="target page size in bytes (achievable sizes "
                        "are multiples of the input's; default: merge "
                        "maximally)")
    p.add_argument("--clobber", action="store_true",
                   help="overwrite output file if it exists")
    args = p.parse_args(argv)

    from cobs_tpu_torch.construct.compact import compact_repack
    from cobs_tpu_torch.fmt import compact as fmt_compact
    h, _ = fmt_compact.read_compact_header(args.in_file)
    new_page = compact_repack(args.in_file, args.out_file,
                              page_size=args.page_size,
                              clobber=args.clobber)
    print(f"repacked {len(h.parameters)} pages of {h.page_size} B into "
          f"{len(h.parameters) * h.page_size // new_page} pages of "
          f"{new_page} B (bit-preserving per document)")
    return 0


# ------------------------------------------------------------------- query


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


#: the file `query --profile DIR` writes into DIR
PROFILE_TRACE = "query.pt.trace.json"


@contextlib.contextmanager
def _profiled(trace_dir: str, cuda: bool):
    """Record a torch.profiler trace of the body into
    trace_dir/PROFILE_TRACE: CPU activity, and CUDA activity (the kernels'
    launches and device times) when `cuda`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(trace_dir) / PROFILE_TRACE))


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
    p.add_argument("--profile", default="", metavar="DIR",
                   help="record a torch.profiler trace of the search (CPU "
                        "activity, and CUDA activity when the index is on "
                        f"a CUDA device) into DIR/{PROFILE_TRACE} "
                        "(export_chrome_trace)")
    _add_threads_flag(p)
    _add_device_flag(p, "holding the index")
    _add_mesh_flag(p)
    args = p.parse_args(argv)
    _apply_threads(args)

    from cobs_tpu_torch.query.search import Search

    # --streamed wins over --load-complete, as in cobs_tpu
    s = Search(args.index, device=args.device, mesh=_mesh(args),
               streamed=(True if args.streamed
                         else False if args.load_complete else None))
    profile_ctx = contextlib.nullcontext()
    if args.profile:
        profile_ctx = _profiled(args.profile, "cuda" in s.device_types())
    if args.query:
        with profile_ctx:
            for res in s.search(args.query, args.threshold, args.limit):
                print(f"{res.doc_name}\t{res.score}")
    elif args.file:
        # FASTA query file: batch all sequences into one kernel launch
        comments, queries = _read_fasta_queries(args.file)
        with profile_ctx:
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
    _add_device_flag(p, "holding the index")
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


def cmd_serve(argv):
    """The resident batching query server (query/server.py): the index
    stays on the card and client queries coalesce into device batches.
    SIGTERM or SIGINT drains queued requests and the batches in flight
    (for at most server.STOP_GRACE_S), removes a Unix socket file and
    exits 0; a second SIGTERM or SIGINT ends the process at once."""
    p = argparse.ArgumentParser(prog="cobs serve")
    p.add_argument("-i", "--index", action="append", default=[],
                   help="path to index file(s)")
    p.add_argument("--socket", default="", metavar="PATH",
                   help="serve on a Unix domain socket at PATH")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7687,
                   help="TCP port (used when --socket is not given), "
                        "default: 7687")
    p.add_argument("-t", "--threshold", type=float, default=0.8,
                   help="server score floor, default: 0.8 (requests "
                        "above it are fast prefix cuts; below it, the "
                        "batch re-ranks at the lower threshold)")
    p.add_argument("-l", "--limit", type=int, default=0,
                   help="top-k serving mode: cap results per query "
                        "on the device, default: 0 = full ranking")
    p.add_argument("-b", "--batch", type=int, default=64,
                   help="max queries coalesced per device batch")
    p.add_argument("--linger-ms", type=float, default=2.0,
                   help="batching window after the first query of a "
                        "batch arrives, default: 2 ms")
    p.add_argument("--warmup", type=int, default=0, metavar="LEN",
                   help="build and load the kernels and run one batch "
                        "of LEN-character queries before accepting "
                        "clients")
    p.add_argument("--log-interval", type=float, default=0.0,
                   metavar="SECS",
                   help="print a RESULT throughput/counter line every "
                        "SECS seconds (0 = off)")
    p.add_argument("--stall-timeout", type=float, default=300.0,
                   metavar="SECS",
                   help="liveness breaker: when the scoring pipeline "
                        "makes no progress for SECS, answer NEW queries "
                        "with an error instead of queueing them; "
                        "default: 300, 0 disables")
    p.add_argument("--slo-ms", type=float, default=0.0, metavar="MS",
                   help="p99 latency target: adaptively cap the deep-"
                        "queue multi-batch group size (and the linger) "
                        "so tail latency stays under MS; default: 0 = "
                        "throughput mode")
    p.add_argument("--load-complete", action="store_true",
                   help="load the whole index onto the device, whatever "
                        "its size")
    p.add_argument("--streamed", action="store_true",
                   help="serve the index from a host mmap")
    _add_threads_flag(p)
    _add_device_flag(p, "holding the index")
    _add_mesh_flag(p)
    args = p.parse_args(argv)
    _apply_threads(args)
    if not args.index:
        print("Pass at least one -i index.", file=sys.stderr)
        return -1

    import signal

    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.query.server import QueryServer

    mesh = _mesh(args)

    def factory(paths=None):
        # --streamed wins over --load-complete, as in cobs_tpu
        return Search(list(paths) if paths else args.index,
                      device=args.device, mesh=mesh,
                      streamed=(True if args.streamed
                                else False if args.load_complete
                                else None))

    server = QueryServer(
        factory(), unix_path=args.socket or None, host=args.host,
        port=args.port, batch_size=args.batch,
        linger_ms=args.linger_ms, threshold=args.threshold,
        num_results=args.limit, search_factory=factory,
        stall_timeout=args.stall_timeout, slo_ms=args.slo_ms)
    if args.warmup:
        server.warmup(args.warmup)
        print(f"WARM query_len={args.warmup}", flush=True)
    addr = server.address
    addr = addr if isinstance(addr, str) else f"{addr[0]}:{addr[1]}"
    print(f"SERVING {addr} floor_t={args.threshold} "
          f"limit={args.limit} batch={args.batch} "
          f"linger_ms={args.linger_ms}", flush=True)

    def _graceful(signum, frame):
        # drain queued requests and the batches in flight, then exit 0;
        # a second SIGTERM or SIGINT ends the process at once
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, signal.SIG_DFL)
        server.stop()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _graceful)
    try:
        server.serve_forever(log_interval=args.log_interval)
    finally:
        server.close()
    return 0


def cmd_benchmark_scaling(argv):
    p = argparse.ArgumentParser(prog="cobs benchmark-scaling")
    p.add_argument("-n", "--num-devices", type=int, default=0,
                   help="devices to scale to (default: all visible)")
    p.add_argument("--docs-per-shard", type=int, default=4096)
    p.add_argument("--sig-size", type=int, default=1 << 18)
    p.add_argument("-b", "--batch", type=int, default=16)
    p.add_argument("--batch-sweep", type=str, default="",
                   help="comma-separated batch sizes to also measure at "
                        "the full width (scaling claims must state B)")
    p.add_argument("--num-kmers", type=int, default=1000)
    p.add_argument("--iterations", type=int, default=10)
    _add_device_flag(p, "whose visible devices are sharded over")
    args = p.parse_args(argv)

    from cobs_tpu_torch.parallel.benchmark import benchmark_scaling
    from cobs_tpu_torch.parallel.sharded import visible_devices

    sweep = tuple(int(x) for x in args.batch_sweep.split(",") if x)
    r = benchmark_scaling(
        n_devices=args.num_devices or None, sig_size=args.sig_size,
        docs_per_shard=args.docs_per_shard, B=args.batch,
        T=args.num_kmers, iters=args.iterations, B_sweep=sweep,
        devices=visible_devices(args.device))
    for n, qps in sorted(r["per_n"].items()):
        print(f"RESULT shards={n} distinct_devices={r['distinct'][n]} "
              f"batch={args.batch} queries_per_s={qps:.1f} "
              f"docs_per_query={n * args.docs_per_shard} "
              f"cpu_cores_busy={r['cpu_util'][n]:.2f} "
              f"cross_device_copies_per_batch="
              f"{r['copies_per_batch'][n]:g} "
              f"exchanges_per_batch={r['exchanges_per_batch'][n]:g}")
    for b, qps in sorted(r["per_b"].items()):
        print(f"RESULT batch_sweep B={b} queries_per_s={qps:.1f}")
    full = r["per_n"][max(r["per_n"])]
    print(f"RESULT mesh_mega batch={args.batch} K=8 "
          f"queries_per_s={r['mega_qps']:.1f} "
          f"vs_per_batch={r['mega_qps'] / full:.2f}")
    cm = r["cost_model"]
    print(f"RESULT cost_model hbm_bytes_per_query_per_shard="
          f"{cm['hbm_bytes_per_query_per_shard']} "
          f"cross_device_bytes_per_query="
          f"{cm['cross_device_bytes_per_query']} "
          f"upload_bytes_per_query={cm['upload_bytes_per_query']} "
          f"distinct_devices={cm['distinct_devices']}")
    if r["efficiency"] is not None:
        ratio = r["efficiency"] / r["predicted_efficiency"]
        print(f"RESULT weak_scaling_efficiency={r['efficiency']:.3f} "
              f"predicted={r['predicted_efficiency']:.3f} "
              f"measured_over_predicted={ratio:.3f}")
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


# ------------------------------------------------------------ index tools

def _scan_ones(path, offset: int, num_rows: int, row_bytes: int):
    """Per-doc-slot set-bit counts over a row-major bitmap, streamed in
    ~32 MB chunks (constant memory: unpacking a multi-GB payload whole
    would take 8x the file size in RAM). Raises FileIOError when the file
    ends early."""
    ones = np.zeros(8 * row_bytes, dtype=np.int64)
    rows_per_chunk = max(1, (32 << 20) // max(1, row_bytes))
    with open(path, "rb") as f:
        f.seek(offset)
        remaining = num_rows
        while remaining:
            n = min(rows_per_chunk, remaining)
            chunk = np.fromfile(f, dtype=np.uint8, count=n * row_bytes)
            if chunk.size != n * row_bytes:
                raise FileIOError(f'truncated index payload in "{path}"')
            ones += np.unpackbits(
                chunk.reshape(n, row_bytes), axis=1,
                bitorder="little").sum(axis=0, dtype=np.int64)
            remaining -= n
    return ones


def cmd_info(argv):
    """Inspect an index file: header fields, geometry, sizes; --scan adds
    payload statistics (per-document set-bit ratio, the density the
    reference's tests bound, reference:
    tests/classic_index_construction.cpp:87-92). A payload that does not
    match its header raises FileIOError."""
    p = argparse.ArgumentParser(prog="cobs info")
    p.add_argument("index", help="index file (classic or compact)")
    p.add_argument("--scan", action="store_true",
                   help="scan the payload: ones ratio + corruption check "
                        "(reads the whole file)")
    args = p.parse_args(argv)

    import io
    import os

    from cobs_tpu_torch.fmt import classic as fc
    from cobs_tpu_torch.fmt import compact as fco
    from cobs_tpu_torch.query.engine import _WORD_ALIGN
    from cobs_tpu_torch.utils.misc import format_iec

    path = args.index
    size = os.path.getsize(path)
    if fc.is_classic_file(path):
        h = fc.read_classic_header(path)
        print(f"kind            classic ({fc.FILE_EXTENSION})")
        print(f"file size       {format_iec(size)}")
        print(f"term size       {h.term_size}")
        print(f"canonicalize    {h.canonicalize}")
        print(f"num hashes      {h.num_hashes}")
        print(f"signature size  {h.signature_size} bits")
        print(f"documents       {len(h.file_names)}")
        print(f"row size        {h.row_size} B "
              f"(8-aligned doc slots: {8 * h.row_size})")
        print(f"payload         "
              f"{format_iec(h.signature_size * h.row_size)}")
        if args.scan:
            buf = io.BytesIO()
            h.serialize(buf)
            hdr_len = buf.tell()
            payload = h.signature_size * h.row_size
            if hdr_len + payload != size:
                raise FileIOError(
                    f'corrupt classic index "{path}": header {hdr_len} B '
                    f"+ payload {payload} B != file size {size} B")
            ones = _scan_ones(path, hdr_len, h.signature_size, h.row_size)
            ratio = ones / float(h.signature_size)
            n = len(h.file_names)
            print(f"ones ratio      min {ratio[:n].min():.6f} "
                  f"mean {ratio[:n].mean():.6f} "
                  f"max {ratio[:n].max():.6f}")
            pad = ratio[n:]
            if pad.size and pad.max() > 0:
                print("WARNING: padding doc slots contain set bits")
    elif fco.is_compact_file(path):
        h, payload_off = fco.read_compact_header(path)
        print(f"kind            compact ({fco.FILE_EXTENSION})")
        print(f"file size       {format_iec(size)}")
        print(f"term size       {h.term_size}")
        print(f"canonicalize    {h.canonicalize}")
        print(f"page size       {h.page_size} B "
              f"({8 * h.page_size} docs/page)")
        print(f"pages           {len(h.parameters)}")
        print(f"documents       {len(h.file_names)}")
        sigs = [p_.signature_size for p_ in h.parameters]
        nhs = sorted({p_.num_hashes for p_ in h.parameters})
        nh_txt = (f"uniform num_hashes {nhs[0]}" if len(nhs) == 1
                  else f"num_hashes {nhs[0]}..{nhs[-1]} "
                       "(NON-UNIFORM: unqueryable)")
        print(f"signature sizes {min(sigs)}..{max(sigs)} bits ({nh_txt})")
        payload = sum(s * h.page_size for s in sigs)
        print(f"payload         {format_iec(payload)} "
              f"(starts page-aligned at {payload_off})")
        sig_nh = [(p_.signature_size, p_.num_hashes) for p_ in h.parameters]
        m = fco.coalesce_factor(sig_nh)
        if m > 1:
            print(f"mergeable       groups of {m} equal-size pages -> "
                  f"{m * h.page_size} B pages, bit-preserving "
                  f"(`cobs repack`; the query engine merges in HBM "
                  "automatically)")
        else:
            runs = fco.coalesce_runs(sig_nh)
            if any(n > 1 for _, n in runs):
                print(f"mergeable       {len(runs)} equal-size RUNS "
                      f"(longest {max(n for _, n in runs)} pages); no "
                      "uniform factor, so `cobs repack` cannot "
                      "materialize it — the query engine merges the "
                      "runs in HBM automatically")
        # the engine pads each (merged) page to a multiple of
        # _WORD_ALIGN 4-byte words on the device
        align = 4 * _WORD_ALIGN
        if h.page_size < align:
            extra = ("" if m * h.page_size >= align
                     else f"; a --page-size that is a multiple of "
                          f"{align} needs no padding")
            print(f"hint: {h.page_size} B pages pad to {_WORD_ALIGN} "
                  f"words ({align} B) each on the device at query "
                  f"time{extra}")
        if args.scan:
            if payload_off + payload != size:
                raise FileIOError(
                    f'corrupt compact index "{path}": header+padding '
                    f"{payload_off} B + payload {payload} B != file size "
                    f"{size} B")
            doc, pos, worst = 0, payload_off, 0.0
            for prm in h.parameters:
                ones = _scan_ones(path, pos, prm.signature_size,
                                  h.page_size)
                pos += prm.signature_size * h.page_size
                n_here = min(len(h.file_names) - doc, 8 * h.page_size)
                if n_here > 0:
                    worst = max(worst, float(
                        (ones[:n_here] / prm.signature_size).max()))
                doc += n_here
            print(f"ones ratio      max over pages {worst:.6f}")
    else:
        raise FileIOError(
            f'Could not open index path "{path}" (unknown format)')
    return 0


#: the device probe of `cobs doctor`, run in a fresh interpreter: argv[1]
#: is the torch device; prints one JSON line
_DOCTOR_PROBE = """\
import json, platform, sys, time
import torch
dev = torch.device(sys.argv[1])
t0 = time.time()
if dev.type == "cuda":
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available "
                         "(torch.cuda.is_available() is False)")
    torch.cuda.init()
    n, name = torch.cuda.device_count(), torch.cuda.get_device_name(dev)
else:
    n, name = 1, platform.machine()
y = (torch.arange(8, device=dev) * 2).cpu()
if int(y[3]) != 6:
    raise SystemExit(f"arange(8) * 2 on {dev} gave {y.tolist()}")
print(json.dumps({"n": n, "type": dev.type, "name": name,
                  "roundtrip_s": round(time.time() - t0, 2)}))
"""


def cmd_doctor(argv):
    """Deployment self-check: the device probe (in a fresh interpreter
    under --timeout, so a hung CUDA runtime is diagnosed, not reproduced), the
    native host library and io_uring, the CUDA kernels' builds, and the
    settings. Exits 1 if the device probe or the native library fails;
    io_uring and the kernel builds are reported, not failed."""
    p = argparse.ArgumentParser(prog="cobs doctor")
    p.add_argument("--timeout", type=float, default=60.0,
                   help="seconds to wait for the device probe (default 60)")
    _add_device_flag(p, "to probe")
    args = p.parse_args(argv)

    import json
    import platform
    import subprocess
    import tempfile

    import torch

    from cobs_tpu_torch import native
    from cobs_tpu_torch.ops import _build

    failures = 0
    device = settings.device if args.device is None else args.device
    print(f"python {sys.version.split()[0]} on {platform.platform()}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {device}")

    # --- device: a fresh interpreter, so no CUDA context is inherited
    # and a hung CUDA runtime cannot hang this process
    try:
        r = subprocess.run([sys.executable, "-c", _DOCTOR_PROBE, device],
                           capture_output=True, text=True,
                           timeout=args.timeout)
        info = None
        for line in (r.stdout or "").splitlines():
            if line.startswith("{"):
                try:
                    info = json.loads(line)
                except ValueError:
                    pass  # a stray brace-prefixed log line, not ours
        if r.returncode == 0 and info:
            print(f"DEVICE OK: {info['n']}x {info['name']} "
                  f"({info['type']}), first op round-trip "
                  f"{info['roundtrip_s']}s")
        else:
            failures += 1
            tail = (r.stderr or "").strip().splitlines()[-1:]
            print(f"DEVICE FAILED: probe of {device} exited "
                  f"{r.returncode}" + (f" ({tail[0]})" if tail else ""))
    except subprocess.TimeoutExpired:
        failures += 1
        print(f"DEVICE UNREACHABLE: init and first op on {device} did not "
              f"return within {args.timeout:.0f}s - CUDA runtime hung or card "
              "wedged; retry with a longer --timeout")

    # --- native host library + io_uring
    try:
        native.lib()
    except RuntimeError as e:
        failures += 1
        print(f"NATIVE FAILED: {str(e).splitlines()[0]} (check g++)")
    else:
        print("NATIVE OK: C++ host library loaded "
              "(hashing, scatter, row gather, scoring)")
        with tempfile.NamedTemporaryFile() as f:
            f.write(b"x" * 4096)
            f.flush()
            out = np.empty((2, 16), dtype=np.uint8)
            if native.gather_rows_file(f.name, 0, 16,
                                       np.array([0, 4], np.int64), out,
                                       dontcache=True):
                dc = ("cache-bypass (RWF_DONTCACHE) reads available"
                      if native.dontcache_supported()
                      else "RWF_DONTCACHE unsupported here - cold "
                           "benchmarks evict the page cache per batch")
                print(f"IO_URING OK: batched async row reads; {dc}")
            else:
                print("IO_URING UNAVAILABLE: streamed queries gather rows "
                      "from the mmap and cold benchmarks evict the page "
                      "cache per batch (seccomp or pre-5.1 kernel?)")

    # --- the CUDA kernels' builds (doctor builds nothing)
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = "not found (set CUDA_HOME)"
    built = sum(_build._so_path(name).exists() for name in _build.SOURCES)
    print(f"KERNELS: nvcc {nvcc}; {built} of {len(_build.SOURCES)} sources "
          f"built for their current source in {_build.BUILD_DIR} (built at "
          "first use otherwise)")

    print(f"settings: device={settings.device} threads={settings.threads} "
          f"device_hash={settings.device_hash} "
          f"streamed_score={settings.streamed_host_score} "
          f"mega_batches={settings.mega_batches}")
    return 1 if failures else 0


# ------------------------------------------------------------------- misc

def cmd_print_parameters(argv):
    p = _parser_with_num_hashes("cobs print-parameters")
    _add_num_hashes_flag(p)
    p.add_argument("-f", "--false-positive-rate", type=float, default=0.3)
    p.add_argument("-n", "--num-elements", default="0")
    args = p.parse_args(argv)

    from cobs_tpu_torch.core.params import (
        calc_signature_size,
        calc_signature_size_ratio,
    )
    from cobs_tpu_torch.utils.misc import format_iec

    num_elements = _parse_bytes(args.num_elements)
    if num_elements == 0:
        print(calc_signature_size_ratio(args.num_hashes,
                                        args.false_positive_rate))
    else:
        sig = calc_signature_size(num_elements, args.num_hashes,
                                  args.false_positive_rate)
        print(f"signature_size = {sig}")
        print(f"signature_bytes = {sig // 8} = {format_iec(sig // 8)}")
    return 0


def cmd_print_kmers(argv):
    p = argparse.ArgumentParser(prog="cobs print-kmers")
    p.add_argument("query")
    p.add_argument("-k", "--kmer-size", type=int, default=31)
    args = p.parse_args(argv)

    from cobs_tpu_torch.core.canonical import canonicalize_batch
    from cobs_tpu_torch.ingest.util import sliding_windows

    q = np.frombuffer(args.query.encode(), dtype=np.uint8)
    windows = sliding_windows(q, args.kmer_size)
    # the reference emits size-k windows for i in [0, |q|-k), one fewer
    # than the total window count (reference: src/cobs.cpp:584-597)
    windows = windows[:max(0, len(args.query) - args.kmer_size)]
    if windows.shape[0]:
        canon, good = canonicalize_batch(windows)
        for row, g, raw in zip(canon, good, windows):
            if not g:
                print("Invalid DNA base pair: " + raw.tobytes().decode())
            else:
                print(row.tobytes().decode())
    return 0


def cmd_generate_queries(argv):
    """Sample positive queries (a document's term, optionally padded with
    random bases to --size) and random negatives; the same arguments and
    seed give the same file as cobs_tpu's (the same draws from
    np.random.default_rng(seed), in the same order)."""
    p = argparse.ArgumentParser(prog="cobs generate-queries")
    p.add_argument("path", help="path to base documents")
    p.add_argument("--file-type", default="any", help=FILE_TYPE_HELP)
    _add_threads_flag(p)
    p.add_argument("-k", "--term-size", type=int, default=31)
    p.add_argument("-p", "--positive", type=int, default=0)
    p.add_argument("-n", "--negative", type=int, default=0)
    p.add_argument("-N", "--true-negative", action="store_true")
    p.add_argument("-s", "--size", type=int, default=0,
                   help="extend positive terms with random data to size")
    p.add_argument("-S", "--seed", type=int, default=0)
    p.add_argument("-o", "--out-file", default="")
    args = p.parse_args(argv)
    _apply_threads(args)

    from cobs_tpu_torch.ingest.document_list import (
        DocumentList,
        string_to_file_type,
    )
    from cobs_tpu_torch.utils.misc import random_sequence_rng

    filelist = DocumentList(args.path, string_to_file_type(args.file_type))
    rng = np.random.default_rng(args.seed)
    term_size = args.term_size
    fixed_size = max(args.size, term_size)

    total_terms = sum(e.num_terms(term_size) for e in filelist.list())
    print(f"Given {filelist.size()} documents containing {total_terms} "
          f"{term_size}-gram terms", file=sys.stderr)
    if total_terms < args.positive:
        raise SystemExit("not enough terms for requested positives")

    positive_ids = set()
    while len(positive_ids) < args.positive:
        positive_ids.add(int(rng.integers(0, total_terms)))
    positive_ids = sorted(positive_ids)

    # negatives: random queries, optionally verified against the corpus
    negatives = [random_sequence_rng(fixed_size, rng)
                 for _ in range(int(1.5 * args.negative))]
    negative_terms: dict[bytes, list[int]] = {}
    for t_i, neg in enumerate(negatives):
        nb = neg.encode()
        for i in range(len(nb) - term_size + 1):
            negative_terms.setdefault(nb[i:i + term_size], []).append(t_i)

    queries = []  # (comment, sequence)
    pos_iter = iter(positive_ids)
    next_id = next(pos_iter, None)
    index = 0
    for d, e in enumerate(filelist.list()):
        doc_start = index
        for w in e.term_windows(term_size):
            n = w.shape[0]
            while next_id is not None and index <= next_id < index + n:
                term = w[next_id - index].tobytes()
                if fixed_size > term_size:
                    pad = fixed_size - term_size
                    front = int(rng.integers(0, pad))
                    term = (random_sequence_rng(front, rng).encode() + term
                            + random_sequence_rng(pad - front, rng).encode())
                queries.append((
                    f">doc:{d}:term:{next_id - doc_start}:{e.name}",
                    term.decode()))
                next_id = next(pos_iter, None)
            if args.true_negative:
                for row in w:
                    hit = negative_terms.pop(row.tobytes(), None)
                    if hit is not None:
                        for t_i in hit:
                            negatives[t_i] = ""
            index += n

    real_negatives = [x for x in negatives if x][:args.negative]
    if len(real_negatives) < args.negative:
        raise SystemExit(
            "Not enough true negatives left, you were unlucky, try again.")
    for i, neg in enumerate(real_negatives):
        queries.append((f">negative{i}", neg))

    order = rng.permutation(len(queries))
    out = sys.stdout if not args.out_file else open(args.out_file, "w")
    try:
        for i in order:
            comment, seq = queries[i]
            out.write(comment + "\n" + seq + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


SUBTOOLS = {
    "doc-list": (cmd_doc_list, "read a list of documents and print them"),
    "doc-dump": (cmd_doc_dump, "read a list of documents and dump their "
                               "terms"),
    "classic-construct": (cmd_classic_construct,
                          "construct a classic index from documents"),
    "classic-construct-random": (cmd_classic_construct_random,
                                 "construct a classic index with random "
                                 "data"),
    "compact-construct": (cmd_compact_construct,
                          "construct a compact index from documents"),
    "compact-construct-combine": (cmd_compact_construct_combine,
                                  "combine classic indices into a compact "
                                  "index"),
    "repack": (cmd_repack,
               "merge equal-size compact pages into wider pages, "
               "bit-preserving"),
    "query": (cmd_query, "query an index"),
    "serve": (cmd_serve, "run a resident batching query server"),
    "doctor": (cmd_doctor, "check the device, native library, kernel "
                           "builds and settings"),
    "info": (cmd_info, "inspect an index file (header, geometry, "
                       "--scan statistics)"),
    "print-parameters": (cmd_print_parameters,
                         "print index parameters for a given configuration"),
    "print-kmers": (cmd_print_kmers,
                    "print canonicalized k-mers of a query"),
    "benchmark-scaling": (cmd_benchmark_scaling,
                          "weak-scaling query benchmark over a mesh"),
    "benchmark-fpr": (cmd_benchmark_fpr,
                      "run a query benchmark over random queries"),
    "generate-queries": (cmd_generate_queries,
                         "select queries randomly from documents"),
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
    except (ValueError, FileNotFoundError, FileExistsError, RuntimeError,
            FileIOError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def console_main() -> None:
    raise SystemExit(main())


if __name__ == "__main__":
    console_main()
