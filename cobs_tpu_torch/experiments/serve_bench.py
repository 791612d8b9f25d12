"""Serving front-end overhead on one CUDA card: `QueryServer` through a
real socket against the direct `search_stream` on the same index.

The port of cobs_tpu's experiments/serve_bench.py, with its flags and
lines. The server adds socket transport, JSON framing, linger batching
and per-request cuts on top of `search_stream`'s scoring; this measures
what they cost at serving batch sizes. One `Search` serves both modes
(the index loads once). The clients are processes that cost the host
almost nothing: each pre-encodes its requests, pipelines them over one
Unix socket, counts the responses by newline and checks the first and
the last, so the measurement is the server's capacity. They start from
a forkserver, a clean process that holds no CUDA context and no server
thread, where cobs_tpu forked the server's own process, and they are
connected and waiting before the clock starts, where cobs_tpu's clock
also held their fork.

    python -m cobs_tpu_torch.experiments.serve_bench INDEX [--limit 100] \\
        [--batch 1024] [--clients 4] [--queries 8192] [--streamed] \\
        [--pin-clients] [--skip-direct] [--device cuda]

Prints

    DIAG direct t_hashes=... t_io=... t_fetch=... t_sort=...
    RESULT mode=direct ... queries_per_s=...
    DIAG stats={...} t_hashes=... ...
    RESULT mode=served_pinned ... (with --pin-clients)
    RESULT mode=served ... queries_per_s=... lat_p50_ms=... lat_p99_ms=...
        overhead_pct=...

`--streamed` serves the index from a host mmap (`StreamedIndex`);
`--pin-clients` adds a served pass with every client on the last CPU;
`--device cpu` scores with the kernels' plain versions (tests only).
"""

import argparse
import json
import os
import queue
import socket
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

from cobs_tpu_torch.experiments.paper_scale import random_queries as _draw


def random_queries(n: int, num_kmers: int) -> list[str]:
    """cobs_tpu's harness's queries (seed 0xC0B5), as str."""
    return [q.decode() for q in _draw(n, num_kmers)]


def drive_direct(search, queries, threshold, limit, batch) -> float:
    t0 = time.perf_counter()
    n = 0
    for _ in search.search_stream(queries, threshold, limit,
                                  batch_size=batch):
        n += 1
    return n / (time.perf_counter() - t0)


def _client_proc(sock, qs, out_q, go, pin_core=None, keep=False, tag=0):
    """One fully pipelined client process: its requests encoded and its
    connection made before `go` is set, its responses counted by newline
    (not parsed) and the first and the last checked. Puts (tag, None,
    None) when ready, then (tag, count, the responses' bytes if `keep`
    else None), to be parsed after the clock."""
    if pin_core is not None:
        os.sched_setaffinity(0, {pin_core})
    payload = b"".join(json.dumps({"id": i, "query": q}).encode() + b"\n"
                       for i, q in enumerate(qs))
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(sock)
    c.settimeout(600)
    out_q.put((tag, None, None))
    go.wait()
    sender = threading.Thread(target=c.sendall, args=(payload,),
                              daemon=True)
    sender.start()
    n = 0
    chunks = []
    while n < len(qs):
        chunk = c.recv(1 << 20)
        if not chunk:
            raise ConnectionError("server closed the connection")
        chunks.append(chunk)
        n += chunk.count(b"\n")
    sender.join()
    c.close()
    if n != len(qs):
        raise RuntimeError(f"{n} responses to {len(qs)} requests")
    data = b"".join(chunks)
    for line in (data[:data.index(b"\n")], data.rstrip(b"\n").rsplit(
            b"\n", 1)[-1]):
        r = json.loads(line)
        if "results" not in r and "error" not in r:
            raise RuntimeError(f"bad response {line[:200]!r}")
    out_q.put((tag, n, data if keep else None))


def parse_responses(data: bytes) -> dict:
    """Response bytes -> {request id: [(doc, score), ...]}."""
    out = {}
    for line in data.splitlines():
        r = json.loads(line)
        out[r["id"]] = [tuple(p) for p in r["results"]]
    return out


def _collect(out_q, procs, n: int, seconds: float = 600.0) -> list:
    """n items from the clients' queue; raises as soon as a client
    process has failed, or after `seconds`."""
    got = []
    deadline = time.monotonic() + seconds
    while len(got) < n:
        try:
            got.append(out_q.get(timeout=0.5))
        except queue.Empty:
            bad = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                raise RuntimeError(f"serve_bench: {n - len(got)} clients "
                                   f"did not answer (exit codes {bad})")
    return got


def drive_served(search, queries, threshold, limit, batch, clients,
                 linger_ms, warm, pin_clients=False, keep=False):
    """(q/s, p50 ms, p99 ms, with `keep` each query's served results as
    [(doc, score), ...] in query order, else None) of `clients` client
    processes each pipelining its share (queries[i::clients]) to a
    QueryServer on a Unix socket, after one warm-up client. Prints the
    DIAG line. Every process it starts has ended when it returns or
    raises: the clients, the forkserver and the resource tracker, which
    would otherwise outlive this process by the time they take to exit."""
    import gc
    import multiprocessing as mp
    from multiprocessing import forkserver, resource_tracker

    ctx = mp.get_context("forkserver")
    # the forkserver imports this module once (it imports torch), so the
    # clients start fast (by name: run as __main__, the module is not
    # preloaded as "__main__")
    ctx.set_forkserver_preload(["cobs_tpu_torch.experiments.serve_bench"])
    started = []
    try:
        return _drive_served(ctx, started, search, queries, threshold,
                             limit, batch, clients, linger_ms, warm,
                             pin_clients, keep)
    except BaseException as e:
        # the failed frames hold the queue and the events
        traceback.clear_frames(e.__traceback__)
        raise
    finally:
        for pr in started:
            if pr.exitcode is None:
                pr.kill()
            pr.join()
        started.clear()
        forkserver._forkserver._stop()
        # the queue's and events' semaphores are unregistered before the
        # tracker stops, or a later unregister would start it anew
        gc.collect()
        resource_tracker._resource_tracker._stop()


def _start_clients(ctx, started, sock, out_q, shares, pin, want):
    """(event, processes): client processes for `shares`, each appended
    to `started`, connected and waiting on the event. (Not a closure: a
    failed call's frames, cleared, keep their function and so its
    closure, which would hold the queue.)"""
    go = ctx.Event()
    procs = [ctx.Process(target=_client_proc,
                         args=(sock, qs, out_q, go, pin, want, i))
             for i, qs in enumerate(shares)]
    for pr in procs:
        pr.start()
        started.append(pr)
    _collect(out_q, procs, len(procs))   # every client ready
    return go, procs


def _drive_served(ctx, started, search, queries, threshold, limit, batch,
                  clients, linger_ms, warm, pin_clients, keep):
    """drive_served's measurement; each client process it starts is
    appended to `started`."""
    from cobs_tpu_torch.query.server import QueryServer

    si = os.environ.get("BENCH_SWITCHINTERVAL")
    sock = str(Path(tempfile.mkdtemp(prefix="cobs_sb_")) / "bench.sock")
    srv = QueryServer(search, unix_path=sock, threshold=threshold,
                      num_results=limit, batch_size=batch,
                      linger_ms=linger_ms)
    per_client = [queries[i::clients] for i in range(clients)]
    out_q = ctx.Queue()
    with srv:
        if si:
            sys.setswitchinterval(float(si))
        go, procs = _start_clients(ctx, started, sock, out_q, [warm], None,
                                   False)
        go.set()
        _collect(out_q, procs, 1)
        procs[0].join()
        ncpu = os.cpu_count() or 4
        go, procs = _start_clients(ctx, started, sock, out_q, per_client,
                                   ncpu - 1 if pin_clients else None, keep)
        t0 = time.perf_counter()
        go.set()
        got = _collect(out_q, procs, len(procs))
        dt = time.perf_counter() - t0
        for pr in procs:
            pr.join()
        p50, p99 = srv._latency_ms()
        t = search.timer_
        print(f"DIAG stats={dict(srv._stats)} "
              f"t_hashes={t.get('hashes'):.2f} t_io={t.get('io'):.2f} "
              f"t_fetch={t.get('add rows'):.2f} "
              f"t_sort={t.get('sort results'):.2f}", flush=True)
    os.rmdir(os.path.dirname(sock))
    total = sum(n for _, n, _ in got)
    if total != len(queries):
        raise RuntimeError(f"{total} responses to {len(queries)} queries")
    responses = None
    if keep:
        responses = [None] * len(queries)
        for tag, _, data in got:   # client `tag` sent queries[tag::clients]
            for rid, res in parse_responses(data).items():
                responses[rid * clients + tag] = res
    return len(queries) / dt, p50, p99, responses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("index")
    p.add_argument("-t", "--threshold", type=float, default=0.8)
    p.add_argument("-l", "--limit", type=int, default=100)
    p.add_argument("-b", "--batch", type=int, default=1024)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--queries", type=int, default=8192)
    p.add_argument("--kmers", type=int, default=1000)
    p.add_argument("--warmup", type=int, default=256)
    p.add_argument("--linger-ms", type=float, default=5.0)
    p.add_argument("--streamed", action="store_true")
    p.add_argument("--pin-clients", action="store_true",
                   help="also run a served pass with every client pinned "
                        "to the last CPU core")
    p.add_argument("--skip-direct", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run(args)
    return 0


def run(args, search=None, keep: bool = False) -> dict:
    """The harness on parsed arguments (on `search` when given, else on
    args.index); returns the measured values (direct, served,
    served_pinned q/s; p50, p99; overhead_pct) and, with `keep`, the
    served pass's results in query order ("responses")."""
    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.settings import settings

    queries = random_queries(args.queries, args.kmers)
    # enough to form full multi-batch groups, so every group size is
    # warm before the clock
    warm = queries[:min(max(args.warmup,
                            args.batch * 2 * settings.mega_batches),
                        len(queries))]
    base = (f"batch={args.batch} limit={args.limit} kmers={args.kmers} "
            f"queries={args.queries} "
            f"backend={'streamed' if args.streamed else 'device'}")
    # one Search for both modes: the index loads once
    s = search if search is not None else Search(
        args.index, device=args.device, streamed=bool(args.streamed))
    for _ in s.search_stream(warm, args.threshold, args.limit,
                             batch_size=args.batch):
        pass
    out = {}
    if not args.skip_direct:
        s.timer_.reset()
        out["direct"] = drive_direct(s, queries, args.threshold,
                                     args.limit, args.batch)
        t = s.timer_
        print(f"DIAG direct t_hashes={t.get('hashes'):.2f} "
              f"t_io={t.get('io'):.2f} t_fetch={t.get('add rows'):.2f} "
              f"t_sort={t.get('sort results'):.2f}", flush=True)
        print(f"RESULT mode=direct {base} "
              f"queries_per_s={out['direct']:.1f}", flush=True)
    s.timer_.reset()
    out["served"], out["p50"], out["p99"], out["responses"] = drive_served(
        s, queries, args.threshold, args.limit, args.batch, args.clients,
        args.linger_ms, warm, keep=keep)
    extra = ""
    if out.get("direct"):
        out["overhead_pct"] = 100 * (1 - out["served"] / out["direct"])
        extra = f" overhead_pct={out['overhead_pct']:.1f}"
    if args.pin_clients:
        s.timer_.reset()
        pq, pp50, pp99, _ = drive_served(
            s, queries, args.threshold, args.limit, args.batch, args.clients,
            args.linger_ms, warm, pin_clients=True)
        out["served_pinned"] = pq
        print(f"RESULT mode=served_pinned {base} clients={args.clients} "
              f"queries_per_s={pq:.1f} lat_p50_ms={pp50} lat_p99_ms={pp99}",
              flush=True)
    print(f"RESULT mode=served {base} clients={args.clients} "
          f"linger_ms={args.linger_ms} queries_per_s={out['served']:.1f} "
          f"lat_p50_ms={out['p50']} lat_p99_ms={out['p99']}{extra}",
          flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
