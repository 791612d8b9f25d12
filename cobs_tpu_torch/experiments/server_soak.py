"""Serving soak on the port: sustained exact traffic, live reloads and
protocol chaos against one QueryServer.

The port of cobs_tpu's experiments/server_soak.py, with its clients and
its exit rule. It builds the golden corpus's classic index
(tests/data/fasta) with the port and serves it from a `QueryServer` on
`--device` (the card by default) for `--seconds`, with, all at once:

- `--clients` pipelining clients, each sending bursts of 1-64 requests
  and checking EVERY response (its id, and its results against the
  embedded `Search` at the request's threshold);
- a reload client sending {"cmd": "reload"} once a second;
- a chaos client opening connections, sending garbage, partial lines and
  oversized ids, and abandoning sockets mid-burst.

Exit code 0 = zero wrong responses, zero batch failures, zero connections
left open once every client has gone, and at least one exact response
and one reload. With COBS_TPU_SERVER_DEBUG set, the server's `stats`
carry its scorer's phase seconds, printed per batch on a second RESULT
line.

    python -m cobs_tpu_torch.experiments.server_soak [--seconds 60] \\
        [--clients 4] [--device cuda]
"""

import argparse
import json
import random
import socket
import sys
import tempfile
import threading
import time
from pathlib import Path

GOLDEN = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
FASTA = Path(__file__).resolve().parents[2] / "tests" / "data" / "fasta"
#: the scorer's phase timers (COBS_TPU_SERVER_DEBUG)
PHASES = ("t_assemble", "t_drain_idle", "t_group", "t_hash", "t_dispatch",
          "t_drain")


def _connect(path: str, timeout: float) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    s.connect(path)
    return s


def soak(seconds: float, clients: int, device: str) -> dict:
    """Run the soak; returns the counts, the server's stats, the
    connections still open after the clients left, the errors and `ok`
    (the exit rule)."""
    import numpy as np

    import cobs_tpu_torch as ct
    from cobs_tpu_torch.query.server import QueryServer

    with tempfile.TemporaryDirectory(prefix="cobs_soak_") as tmp:
        idx = str(Path(tmp) / "soak.cobs_classic")
        old_cache = ct.settings.disable_cache
        ct.settings.disable_cache = True
        try:
            ct.classic_construct(
                ct.DocumentList(FASTA), idx,
                index_params=ct.ClassicIndexParameters(clobber=True,
                                                       device=device))
        finally:
            ct.settings.disable_cache = old_cache
        direct = ct.Search(idx, device=device)
        # a query pool with known-exact expectations at several thresholds
        rng = np.random.default_rng(7)
        bases = np.frombuffer(b"ACGT", np.uint8)
        pool = [GOLDEN] + [bytes(bases[rng.integers(0, 4, size=60)]).decode()
                           for _ in range(15)]
        thresholds = [0.0, 0.3, 0.8]
        want = {(q, t): [[r.doc_name, r.score]
                         for r in direct.search(q, t)]
                for q in pool for t in thresholds}

        sock = str(Path(tmp) / "soak.sock")
        srv = QueryServer(
            ct.Search(idx, device=device), unix_path=sock, threshold=0.0,
            linger_ms=1.0,
            search_factory=lambda paths: ct.Search(
                [str(p) for p in paths] if paths else idx, device=device))
        stop = threading.Event()
        errs: list[str] = []
        counts = {"exact": 0, "reloads": 0, "chaos_conns": 0}
        lock = threading.Lock()

        def pipeliner(tag):
            r = random.Random(tag)
            try:
                with _connect(sock, 60) as s, s.makefile("rb") as f:
                    while not stop.is_set():
                        burst = [(i, r.choice(pool), r.choice(thresholds))
                                 for i in range(r.randint(1, 64))]
                        s.sendall(b"".join(
                            json.dumps({"id": [tag, i], "query": q,
                                        "threshold": t}).encode() + b"\n"
                            for i, q, t in burst))
                        for i, q, t in burst:
                            resp = json.loads(f.readline())
                            if resp.get("id") != [tag, i] or \
                                    resp.get("results") != want[(q, t)]:
                                errs.append(f"mismatch {tag}/{i}: {resp}")
                                stop.set()
                                return
                        with lock:
                            counts["exact"] += len(burst)
            except Exception as e:  # noqa: BLE001 - the soak reports all
                if not stop.is_set():
                    errs.append(f"pipeliner {tag}: {e!r}")
                    stop.set()

        def reloader():
            try:
                with _connect(sock, 60) as s, s.makefile("rb") as f:
                    while not stop.is_set():
                        s.sendall(b'{"cmd": "reload", "id": "r"}\n')
                        resp = json.loads(f.readline())
                        if not resp.get("ok"):
                            errs.append(f"reload failed: {resp}")
                            stop.set()
                            return
                        with lock:
                            counts["reloads"] += 1
                        stop.wait(1.0)
            except Exception as e:  # noqa: BLE001
                if not stop.is_set():
                    errs.append(f"reloader: {e!r}")
                    stop.set()

        def chaos():
            r = random.Random(99)
            garbage = [b"not json\n", b'{"query": 5}\n', b"\n",
                       b'{"cmd": "nope"}\n', b'{"query": ""}\n',
                       b'{"id": ' + b"9" * 100 + b', "query": "ACGT"}\n',
                       b'{"query": "' + b"Z" * 80 + b'"}\n']
            while not stop.is_set():
                try:
                    with _connect(sock, 5) as s:
                        for _ in range(r.randint(1, 5)):
                            s.sendall(r.choice(garbage))
                        if r.random() >= 0.5:
                            s.recv(4096)
                        # else: abandoned mid-conversation
                    with lock:
                        counts["chaos_conns"] += 1
                except OSError:
                    pass
                time.sleep(0.01)

        with srv:
            threads = ([threading.Thread(target=pipeliner, args=(t,))
                        for t in range(clients)]
                       + [threading.Thread(target=reloader),
                          threading.Thread(target=chaos)])
            for t in threads:
                t.start()
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline and not stop.is_set():
                time.sleep(0.25)
            stop.set()
            for t in threads:
                t.join(timeout=90)
            # every client has closed its socket: the server's readers
            # drop each connection once they read its end
            deadline = time.monotonic() + 30
            while srv._conns and time.monotonic() < deadline:
                time.sleep(0.05)
            with srv._lock:
                stats = dict(srv._stats)
                conns = len(srv._conns)
            alive = [t.name for t in threads if t.is_alive()]
            if alive:
                errs.append(f"threads still running: {alive}")

    ok = (not errs and stats.get("batch_failures", 0) == 0 and conns == 0
          and counts["exact"] > 0 and counts["reloads"] > 0)
    return {**counts, "stats": stats, "open_conns": conns, "errors": errs,
            "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cobs_tpu_torch.experiments.server_soak")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index (default: cuda)")
    args = ap.parse_args(argv)
    res = soak(args.seconds, args.clients, args.device)
    stats = res["stats"]
    print(f"RESULT name=server_soak seconds={args.seconds} "
          f"exact_queries={res['exact']} "
          f"reloads={res['reloads']} "
          f"chaos_conns={res['chaos_conns']} "
          f"bad_requests={stats.get('bad_requests', 0)} "
          f"query_errors={stats.get('query_errors', 0)} "
          f"batch_failures={stats.get('batch_failures', 0)} "
          f"overflowed={stats.get('overflowed_connections', 0)} "
          f"open_conns_at_close={res['open_conns']} ok={res['ok']}",
          flush=True)
    if any(k in stats for k in PHASES):
        batches = max(1, stats.get("batches", 0))
        print(f"RESULT name=server_soak_phases batches={batches} "
              + " ".join(f"{k}_ms_per_batch="
                         f"{1e3 * stats.get(k, 0.0) / batches:.4f}"
                         for k in PHASES), flush=True)
    for e in res["errors"][:10]:
        print("ERR:", e, file=sys.stderr)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
