"""Served q/s with the clients in their own processes, on one CUDA card.

The index and queries of chip_smoke.py's phase 3 (the reference's default
scale: 2^21 + 1 rows x 384 words of random bits made on the card,
10,000 documents, h=1, k=31; random 1,030 bp queries, top 100), served
by a `QueryServer` in this process (B=64, linger 2 ms, floor 0) to 8
spawned client processes that each pipeline 512 queries through
`QueryClient.search_batch`, as a deployment's clients would (chip_smoke.py's
phase 11 runs the same load from client threads of the server's
process). The variants:

- `mega 16` / `mega 1`: multi-batch dispatch on (settings.mega_batches)
  or off;
- `switch 5 ms`: the interpreter's own thread switch interval kept
  instead of the server's 0.5 ms.

The variants take turns, RUNS rounds of one load each; every response
is checked against `Search.search_batch`. Prints per variant the median
q/s and the spread, the server's latency p50/p99 and batch counts of
the last load, the gather-and-count launches per batch and the `Timer`
phases per batch.

    python -m cobs_tpu_torch.experiments.serve_load
"""

import statistics
import sys
import time

import numpy as np


def _client_loop(tasks, out, go):
    """A client process: per task, connect, say ready, wait for `go`,
    pipeline the queries and put the timed answers."""
    from cobs_tpu_torch.query.client import QueryClient

    while (task := tasks.get()) is not None:
        address, queries = task
        with QueryClient(address, timeout=120) as c:
            c.ping()
            out.put(None)
            go.wait()
            t0 = time.monotonic()
            res = c.search_batch(queries, strict=True)
            t1 = time.monotonic()
        out.put((t0, t1, [[(r.doc_name, r.score) for r in rl]
                          for rl in res]))


class ProcessClients:
    """Persistent spawned client processes."""

    def __init__(self, n: int):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.go = ctx.Event()
        self.out = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.procs = [ctx.Process(target=_client_loop,
                                  args=(q, self.out, self.go), daemon=True)
                      for q in self.tasks]
        for p in self.procs:
            p.start()

    def run(self, address, chunks) -> tuple[float, list]:
        self.go.clear()
        for q, chunk in zip(self.tasks, chunks):
            q.put((address, chunk))
        for _ in chunks:
            self.out.get(timeout=300)   # every client connected
        self.go.set()
        done = [self.out.get(timeout=300) for _ in chunks]
        t0 = min(d[0] for d in done)
        t1 = max(d[1] for d in done)
        return t1 - t0, done

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)


CLIENTS, PER_CLIENT, RUNS = 8, 512, 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serve_load: no CUDA card", file=sys.stderr)
        return 1
    from cobs_tpu_torch.experiments.dma_gather_bench import random_matrix
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.query import engine
    from cobs_tpu_torch.query.client import QueryClient
    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.query.server import QueryServer
    from cobs_tpu_torch.settings import settings

    rows, W, docs, B, k, L = 1 << 21, 384, 10_000, 64, 100, 1030
    m = random_matrix(torch, rows + 1, W, seed=1)
    m[rows] = 0
    ix = engine.DeviceIndex.from_arrays(
        m, [0], [rows], W, term_size=31, canonicalize=1, num_hashes=1,
        page_size=docs // 8, file_names=[f"doc{i:05d}" for i in range(docs)],
        device="cuda")
    s = Search(ix)
    n = CLIENTS * PER_CLIENT
    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    queries = [acgt[rng.integers(0, 4, L)].tobytes().decode()
               for _ in range(n)]
    chunks = [queries[i * PER_CLIENT:(i + 1) * PER_CLIENT]
              for i in range(CLIENTS)]
    want = [[(r.doc_name, r.score) for r in rl]
            for i in range(0, n, B) for rl in s.search_batch(
                queries[i:i + B], 0.0, k)]
    procs = ProcessClients(CLIENTS)
    mega = settings.mega_batches
    variants = {f"mega {mega}": (mega, None), "mega 1": (1, None),
                f"mega {mega} switch 5 ms": (mega, 0.005)}
    runs = {name: [] for name in variants}
    try:
        for _ in range(RUNS):
            for name, (groups, switch) in variants.items():
                settings.mega_batches = groups
                srv = QueryServer(s, port=0, batch_size=B, linger_ms=2.0,
                                  threshold=0.0, num_results=k)
                settings.mega_batches = mega
                srv.warmup(L)
                with srv:
                    if switch is not None:
                        sys.setswitchinterval(switch)
                    s.timer_.reset()
                    qk.LAUNCHES = 0
                    wall, done = procs.run(srv.address, chunks)
                    launches = qk.LAUNCHES
                    with QueryClient(srv.address) as c:
                        st = c.stats()
                got = sorted(pairs for _, _, pairs in done)
                if got != sorted(want[i * PER_CLIENT:(i + 1) * PER_CLIENT]
                                 for i in range(CLIENTS)):
                    raise RuntimeError(f"{name}: a served response differs")
                batches = st["batches"]
                runs[name].append((wall, st, batches, launches, {
                    ph: s.timer_.get(ph) / batches * 1e3
                    for ph in ("hashes", "io", "add rows", "sort results")}))
    finally:
        settings.mega_batches = mega
        procs.close()
    for name, rs in runs.items():
        walls = [r[0] for r in rs]
        _, st, batches, launches, phases = rs[-1]
        wall = statistics.median(walls)
        print(f"serve_load processes {name}: {n / wall:.0f} q/s (runs "
              + ", ".join(f"{n / w:.0f}" for w in walls) + "); last run: "
              f"p50 {st.get('lat_p50_ms')} ms p99 {st.get('lat_p99_ms')} "
              f"ms (rolling), {batches} batches, {st['mega_dispatches']} "
              f"groups, K1 {launches / batches:.3f} launches per batch; "
              "ms per batch: " + " ".join(
                  f"{ph}={v:.3f}" for ph, v in phases.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
