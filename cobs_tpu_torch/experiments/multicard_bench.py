"""The document-sharded index across several cards, one shard a card.

    python -m cobs_tpu_torch.experiments.multicard_bench \
        [index|processes|scaling] [--cards N] [--rows R] [--work DIR]

Three parts (all by default), each ending in a `RESULT {...}` JSON line:

- `index`: an index that no single card holds. A classic index file of
  100,352 documents (the COBS paper's ~100k microbial genomes, 3,136
  words a row) x ROWS rows (7,000,000: 87.8 GB, 25.1 GB a card on four,
  more than one card's 80 GB). The paper's own size would be
  `calc_signature_size(5_000_000, 1, 0.3)` = 14,018,367 rows, a 5 Mbp
  assembly at `compact-construct`'s fpr 0.3 and one hash (175.8 GB);
  a chip call that writes over 90 GiB is ended, so ROWS is the size
  that such a call can write. The header comes from
  `ClassicIndexHeader.serialize`, the payload from seeded random bits
  in row chunks (`write_classic_index` would need the whole payload in
  memory). Before writing it prints the work directory's `df` line and
  the host's MemAvailable, and raises when the disk holds no such file.
  Then the same 512 random 1,030 bp queries go through
  `cobs query --mesh N -i FILE -f Q -t 0 -l 100` (streamed into N
  shards) and through the one-card streamed search (`Search(FILE,
  streamed=True)` on the first card, B=64); the rankings must be equal
  at top 100 and, for 64 queries, in full (through `Search(FILE,
  mesh=...)`, which is also timed: the shard upload's seconds, each
  card's peak memory, q/s over `search_stream`). The file is deleted.
- `processes`: N processes, one card each (`CUDA_VISIBLE_DEVICES`), a
  gloo group through a file store: `distributed.construct` over
  chip_smoke.py phase 10's corpus (1,000 FASTA documents of 250 kbp-1
  Mbp from seed 10), `open_federated`, and scoring over `global_mesh()`
  (each process's default: its one visible card). Every process's
  rankings must equal one process's `Search` over one build of the
  corpus, and every process must exit 0.
- `scaling`: `parallel.benchmark.benchmark_scaling` over 1, 2 and N
  distinct cards at its defaults and at 25,088 documents a shard, each
  beside N shards of the first card, with q/s, efficiency and the CPU
  cores busy.

The parts run on CUDA cards 0 .. N - 1 (`--cards N`): a mesh that asks
for more cards than are visible raises, as `make_mesh` does. `--rows`,
`--queries`, `--corpus-docs` and `--iters` cut the parts to a quick
check's size. The tests call `run_index`, `run_processes` and
`run_scaling` with device "cpu" (`[cpu] * N`, the kernels' plain
versions) at tiny sizes.
"""

import argparse
import concurrent.futures
import contextlib
import gc
import io
import json
import os
import shutil
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

ROOT = Path(__file__).resolve().parents[2]
#: the index part's documents and rows (module docstring) and its seed
DOCS, ROWS, SEED = 100_352, 7_000_000, 1
#: queries of the index part: all ranked at top K, the first FULL in full
QUERIES, QUERY_LEN, BATCH, K, FULL = 512, 1030, 64, 100, 64
#: bytes of payload made and written per chunk
CHUNK_BYTES = 256 << 20
#: search_stream passes timed over the mesh
PASSES = 3
#: chip_smoke.py phase 10's corpus
CORPUS_DOCS, CORPUS_LENGTHS, CORPUS_SEED = 1000, (250_000, 1_000_000), 10
#: queries of the processes part (cut from documents, then random)
PROC_QUERIES = 128
#: benchmark_scaling's documents per shard: its default and the
#: ref-random-100k width over four cards
SCALING_DOCS = (4096, 25_088)
#: batches timed per shard count (benchmark_scaling's default of 10 takes
#: some 10 ms, too short to tell runs apart)
SCALING_ITERS = 1000


def result(part: str, **fields) -> None:
    print("RESULT " + json.dumps({"part": part, **fields}), flush=True)


def mesh_devices(torch, device: str, n: int) -> list:
    """The n devices of a one-row mesh: CUDA cards 0 .. n - 1 (raises
    when fewer are visible), or the CPU n times."""
    from cobs_tpu_torch.parallel.sharded import make_mesh

    cpu = [torch.device("cpu")] * n if device == "cpu" else None
    return list(make_mesh(1, n, cpu).devices[0])


# ------------------------------------------------------------- the index

def disk_and_memory(work: Path, need: int) -> tuple[str, int, int]:
    """(the `df` line of `work`, its free bytes, the host's MemAvailable
    bytes); raises when the disk has no `need` bytes free with 5 % to
    spare."""
    df = subprocess.run(["df", "-B1", str(work)], capture_output=True,
                        text=True, timeout=60).stdout.strip().splitlines()
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    free = shutil.disk_usage(work).free
    if need * 1.05 >= free:
        raise OSError(f"{work} has {free} B free, no room for an index "
                      f"file of {need} B")
    return df[-1] if df else "", free, avail


def write_index(torch, path: Path, rows: int, docs: int, seed: int,
                device) -> int:
    """A classic index file of `rows` Bloom rows over `docs` documents
    (k=31, one hash, canonical): the header, then the payload as random
    bits in chunks of about CHUNK_BYTES, chunk i drawn on `device` from
    seed (seed, i), each written at its offset by a pool of writer
    threads. Returns the file's size in bytes."""
    from cobs_tpu_torch.fmt.classic import ClassicIndexHeader

    header = ClassicIndexHeader(
        term_size=31, canonicalize=1, signature_size=rows, num_hashes=1,
        file_names=[f"doc{i:06d}" for i in range(docs)])
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        header.serialize(f)
        start = f.tell()
    step = max(1, CHUNK_BYTES // header.row_size)
    cuda = device.type == "cuda"
    writers = 4
    bufs = [torch.empty(step * header.row_size, dtype=torch.uint8,
                        pin_memory=cuda) for _ in range(writers)]
    fd = os.open(path, os.O_WRONLY)
    try:
        os.ftruncate(fd, start + rows * header.row_size)

        def write(buf, n: int, at: int) -> None:
            view = memoryview(buf.numpy())[:n]
            while len(view):
                done = os.pwrite(fd, view, at)
                view, at = view[done:], at + done

        with concurrent.futures.ThreadPoolExecutor(writers) as pool:
            pending = [None] * writers
            g = torch.Generator(device=device)
            for i, r0 in enumerate(range(0, rows, step)):
                n = min(step, rows - r0) * header.row_size
                j = i % writers
                if pending[j] is not None:
                    pending[j].result()
                g.manual_seed(seed * 1_000_003 + i)
                bits = torch.randint(0, 256, (n,), dtype=torch.uint8,
                                     generator=g, device=device)
                bufs[j][:n].copy_(bits)
                pending[j] = pool.submit(write, bufs[j], n,
                                         start + r0 * header.row_size)
            for p in pending:
                if p is not None:
                    p.result()
    finally:
        os.close(fd)
    return path.stat().st_size


def write_fasta_queries(path: Path, queries: list[str]) -> None:
    with open(path, "w") as f:
        for i, q in enumerate(queries):
            f.write(f">q{i}\n{q}\n")


def parse_query_lines(text: str, names: dict) -> list:
    """`cobs query -f` output (`*comment<TAB>n`, then n `name<TAB>score`
    lines per query) as one (doc numbers, scores) pair of arrays per
    query."""
    out, lines, i = [], text.splitlines(), 0
    while i < len(lines):
        n = int(lines[i].rsplit("\t", 1)[1])
        rows = [line.split("\t") for line in lines[i + 1:i + 1 + n]]
        out.append((np.array([names[a] for a, _ in rows], dtype=np.int64),
                    np.array([int(b) for _, b in rows], dtype=np.int64)))
        i += 1 + n
    return out


def run_index(torch, device: str, n: int, work: Path, rows: int = ROWS,
              docs: int = DOCS, seed: int = SEED, queries: int = QUERIES,
              batch: int = BATCH, k: int = K, full: int = FULL,
              passes: int = PASSES, keep: bool = False) -> dict:
    """The index part (module docstring); returns its RESULT fields."""
    from cobs_tpu_torch.cli.main import main as cli_main
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.parallel.sharded import make_mesh
    from cobs_tpu_torch.query.engine import StreamedIndex
    from cobs_tpu_torch.query.search import Search

    devices = mesh_devices(torch, device, n)
    work.mkdir(parents=True, exist_ok=True)
    df, free, mem = disk_and_memory(work, rows * ((docs + 7) // 8))
    print(f"multicard index: df {df!r}; MemAvailable {mem} B; rows {rows}",
          flush=True)
    path = work / "multicard.cobs_classic"
    qs = acgt_queries(np.random.default_rng(seed + 1), queries, QUERY_LEN)
    qfile = work / "queries.fa"
    write_fasta_queries(qfile, qs)
    t0 = time.perf_counter()
    size = write_index(torch, path, rows, docs, seed, devices[0])
    write_s = time.perf_counter() - t0
    print(f"multicard index: wrote {size} B ({rows} rows x "
          f"{(docs + 7) // 8} B) in {write_s:.1f} s", flush=True)
    try:
        # the one-card streamed search (the port's path held against
        # cobs_tpu), at top k and in full
        t0 = time.perf_counter()
        one = Search(str(path), device=devices[0], streamed=True)
        want = [rl for i in range(0, len(qs), batch)
                for rl in one.search_batch(qs[i:i + batch], 0.0, k)]
        want_full = [rl for i in range(0, full, batch)
                     for rl in one.search_batch(qs[i:min(i + batch, full)],
                                                0.0, 0)]
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = list(one.search_stream(qs, 0.0, k, batch_size=batch))
        one_stream_s = time.perf_counter() - t0
        if not same_ranking(got, want):
            raise AssertionError("one-card search_stream != search_batch")
        names = {name: i for i, name in enumerate(one._names)}
        del one, got
        gc.collect()

        # `cobs query --mesh n`, in this process
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        out = io.StringIO()
        qk.LAUNCHES_ON.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli_main(["query", "--mesh", str(n), "--device", device,
                           "-i", str(path), "-f", str(qfile), "-t", "0",
                           "-l", str(k)])
        cli_s = time.perf_counter() - t0
        cli_cards = sorted(qk.LAUNCHES_ON)
        if rc != 0:
            raise AssertionError(f"query --mesh {n} exited {rc}")
        if device != "cpu" and cli_cards != list(range(n)):
            raise AssertionError(f"query --mesh {n} launched K1 on cards "
                                 f"{cli_cards}")
        cli = parse_query_lines(out.getvalue(), names)
        if len(cli) != len(want) or not all(
                np.array_equal(g_, w._gidx) and np.array_equal(s_,
                                                               w._scores)
                for (g_, s_), w in zip(cli, want)):
            raise AssertionError(f"query --mesh {n}: top {k} != the "
                                 "one-card streamed search")
        del out, cli
        gc.collect()
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        # the same mesh through the API: upload, full ranking, q/s
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        mesh = make_mesh(1, n, devices)
        t0 = time.perf_counter()
        s = Search(str(path), mesh=mesh)
        sync_all(torch)
        upload_s = time.perf_counter() - t0
        si = s._scorers[0]
        if not isinstance(s.index_files[0], StreamedIndex) or [
                si.shard(0, d).device for d in range(n)] != devices:
            raise AssertionError("the mesh Search did not stream the file "
                                 f"into {n} shards on {devices}")
        got_full = [rl for i in range(0, full, batch)
                    for rl in s.search_batch(qs[i:min(i + batch, full)],
                                             0.0, 0)]
        if not same_ranking(got_full, want_full):
            raise AssertionError(f"mesh of {n}: full ranking != the "
                                 "one-card streamed search")
        stream_s = []
        for _ in range(passes):
            t0 = time.perf_counter()
            got = list(s.search_stream(qs, 0.0, k, batch_size=batch))
            stream_s.append(time.perf_counter() - t0)
            if not same_ranking(got, want):
                raise AssertionError(f"mesh of {n}: search_stream top {k} "
                                     "!= the one-card streamed search")
        peak = [torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None for dev in devices]
        shard_bytes = si.shard(0, 0).numel() * 4
        del s, si, got, got_full
        gc.collect()
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if not keep:
            path.unlink(missing_ok=True)
    return {"devices": [str(d) for d in devices], "rows": rows,
            "docs": docs, "file_bytes": size, "df": df, "free_bytes": free,
            "mem_available_bytes": mem, "write_s": write_s,
            "queries": len(qs), "batch": batch, "k": k, "full": full,
            "one_card_s": one_s,
            "one_card_stream_qps": len(qs) / one_stream_s,
            "cli_s": cli_s, "cli_k1_cards": cli_cards,
            "upload_s": upload_s, "shard_bytes": shard_bytes,
            "peak_bytes": peak,
            "stream_qps": [len(qs) / t for t in stream_s],
            "equal_top_k": True, "equal_full": True}


# --------------------------------------------------------- the processes

def corpus_queries(docs: Path, lens: list[int], n: int, seed: int
                   ) -> list[str]:
    """n queries of QUERY_LEN bp: the first half cut from documents drawn
    from `seed`, the rest random."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(lens), n // 2, replace=len(lens) < n // 2)
    out = []
    for i in picks.tolist():
        seq = read_fasta_sequence(docs / f"doc{i:04d}.fasta")
        o = int(rng.integers(0, len(seq) - QUERY_LEN))
        out.append(seq[o:o + QUERY_LEN].decode())
    return out + acgt_queries(np.random.default_rng(seed + 1), n - len(out),
                              QUERY_LEN)


def run_processes(torch, device: str, n: int, work: Path,
                  corpus_docs: int = CORPUS_DOCS,
                  lengths=CORPUS_LENGTHS, queries: int = PROC_QUERIES,
                  k: int = K, full: int = 16, timeout: float = 900
                  ) -> dict:
    """The processes part (module docstring); returns its RESULT
    fields."""
    import cobs_tpu_torch as ct

    devices = mesh_devices(torch, device, n)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    lens = write_fasta_corpus(work / "docs", corpus_docs, *lengths,
                              seed=CORPUS_SEED)
    gen_s = time.perf_counter() - t0
    qs = corpus_queries(work / "docs", lens, queries, seed=17)
    old = ct.settings.disable_cache
    ct.settings.disable_cache = True
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            ct.classic_construct(
                ct.DocumentList(work / "docs"), work / "one.cobs_classic",
                index_params=ct.ClassicIndexParameters(
                    false_positive_rate=0.3, device=device))
        one_build_s = time.perf_counter() - t0
        one = ct.Search(str(work / "one.cobs_classic"), device=devices[0])
        want = pairs(one.search_batch(qs, 0.0, k))
        want_full = pairs(one.search_batch(qs[:full], 0.0, 0))
        del one
    finally:
        ct.settings.disable_cache = old
    (work / "spec.json").write_text(json.dumps({
        "device": device, "processes": n, "queries": qs, "k": k,
        "full": full, "want": want, "want_full": want_full}))
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            env = dict(os.environ)
            if device != "cpu":
                env["CUDA_VISIBLE_DEVICES"] = str(devices[r].index)
            logs.append(open(work / f"rank{r}.log", "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "cobs_tpu_torch.experiments.multicard_bench", "child",
                 "--rank", str(r), "--work", str(work)],
                cwd=ROOT, env=env, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    child = []
    for r in range(n):
        text = (work / f"rank{r}.log").read_text(errors="replace")
        lines = [line for line in text.splitlines()
                 if line.startswith("CHILD ")]
        if rcs[r] != 0 or not lines:
            raise AssertionError(f"rank {r} exited {rcs[r]}: "
                                 f"{text[-3000:]}")
        child.append(json.loads(lines[-1][len("CHILD "):]))
    shutil.rmtree(work, ignore_errors=True)
    return {"devices": [str(d) for d in devices], "processes": n,
            "corpus_docs": corpus_docs, "corpus_bp": int(sum(lens)),
            "corpus_s": gen_s, "one_build_s": one_build_s,
            "queries": len(qs), "k": k, "full": full, "rcs": rcs,
            "wall_s": wall, "ranks": child, "equal": True}


def child(rank: int, work: Path) -> None:
    """One process of the processes part: its card is the one it sees
    (CUDA_VISIBLE_DEVICES); `global_mesh()` takes every visible card of
    every process."""
    import torch

    import cobs_tpu_torch as ct
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.parallel import distributed, sharded

    spec = json.loads((work / "spec.json").read_text())
    n, device = spec["processes"], spec["device"]
    ct.settings.disable_cache = True
    if device == "cpu":
        # the processes share the host's cores
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    distributed.initialize(f"file://{work / 'store'}", num_processes=n,
                           process_id=rank, timeout=600)
    try:
        prefix = work / "fed"
        with contextlib.redirect_stderr(io.StringIO()):
            mine = distributed.construct(
                ct.DocumentList(work / "docs"), prefix, kind="classic",
                index_params=ct.ClassicIndexParameters(
                    false_positive_rate=0.3, device=device),
                tmp_path=work / f"tmp{rank}")
        build_s = time.perf_counter() - t0
        distributed.barrier()
        mesh = distributed.global_mesh(
            devices=["cpu"] if device == "cpu" else None)
        if mesh.shape != {"batch": 1, "docs": n} or \
                mesh.local_cells() != [(0, rank)]:
            raise AssertionError(f"rank {rank}: mesh {mesh}")
        t1 = time.perf_counter()
        fed = distributed.open_federated(prefix, n, "classic", mesh=mesh)
        open_s = time.perf_counter() - t1
        qs = spec["queries"]
        qk.LAUNCHES = sharded.EXCHANGES = 0
        t1 = time.perf_counter()
        got = pairs(fed.search_batch(qs, 0.0, spec["k"]))
        got_full = pairs(fed.search_batch(qs[:spec["full"]], 0.0, 0))
        score_s = time.perf_counter() - t1
        # the spec's pairs came back from JSON as lists
        want, want_full = ([[tuple(p) for p in rl] for rl in spec[key]]
                           for key in ("want", "want_full"))
        if got != want or got_full != want_full:
            raise AssertionError(f"rank {rank}: the federation over the "
                                 "global mesh != one process's rankings")
        distributed.barrier()
        card = (torch.cuda.get_device_name(0) if device != "cpu"
                else "cpu")
        print("CHILD " + json.dumps({
            "rank": rank, "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "card": card, "shard": str(mine.name), "build_s": build_s,
            "open_s": open_s, "score_s": score_s,
            "k1_launches": qk.LAUNCHES, "exchanges": sharded.EXCHANGES,
            "wall_s": time.perf_counter() - t0}), flush=True)
    finally:
        distributed.shutdown()


# ------------------------------------------------------------ the scaling

def run_scaling(torch, device: str, n: int, iters: int = SCALING_ITERS,
                docs_per_shard=SCALING_DOCS, sig_size: int = 1 << 18
                ) -> dict:
    """The scaling part (module docstring); returns its RESULT fields."""
    from cobs_tpu_torch.parallel.benchmark import benchmark_scaling

    devices = mesh_devices(torch, device, n)
    out = {}
    for dps in docs_per_shard:
        for how, devs in (("distinct", devices),
                          ("one card", [devices[0]] * n)):
            r = benchmark_scaling(n_devices=n, sig_size=sig_size,
                                  docs_per_shard=dps, iters=iters,
                                  devices=devs)
            out[f"{dps} {how}"] = {
                key: r[key] for key in ("per_n", "cpu_util", "distinct",
                                        "copies_per_batch",
                                        "exchanges_per_batch",
                                        "efficiency", "mega_qps",
                                        "predicted_efficiency")}
    return {"devices": [str(d) for d in devices], "iters": iters,
            "sig_size": sig_size, "runs": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="multicard_bench")
    ap.add_argument("part", nargs="?", default="all",
                    choices=["all", "index", "processes", "scaling",
                             "child"])
    ap.add_argument("--cards", type=int, default=4,
                    help="CUDA cards of the mesh, 0 .. N - 1")
    ap.add_argument("--work", default=str(ROOT / "bench_data" / "multicard"))
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="index rows (default 7,000,000: 87.8 GB)")
    ap.add_argument("--queries", type=int, default=QUERIES)
    ap.add_argument("--corpus-docs", type=int, default=CORPUS_DOCS)
    ap.add_argument("--iters", type=int, default=SCALING_ITERS)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    work = Path(args.work)
    if args.part == "child":
        child(args.rank, work)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("multicard_bench: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    parts = (["index", "processes", "scaling"] if args.part == "all"
             else [args.part])
    for part in parts:
        t0 = time.perf_counter()
        if part == "index":
            fields = run_index(torch, "cuda", args.cards, work / "index",
                               args.rows, queries=args.queries)
        elif part == "processes":
            fields = run_processes(torch, "cuda", args.cards,
                                   work / "processes", args.corpus_docs)
        else:
            fields = run_scaling(torch, "cuda", args.cards, args.iters)
        result(part, seconds=time.perf_counter() - t0, **fields)
    return 0


if __name__ == "__main__":
    sys.exit(main())
