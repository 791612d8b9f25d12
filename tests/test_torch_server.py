"""cobs_tpu_torch QueryServer, QueryClient and `cobs serve` against
cobs_tpu's Search, on the CPU.

The counterpart of tests/test_server.py, test for test: every protocol
path of the port's server, over device-held, streamed and mesh-sharded
indexes, answers exactly what cobs_tpu's embedded `Search` returns on the
same file, tie order included. Indexes are built by cobs_tpu as tests/test_server.py builds
them. Servers here score on the CPU (`Search(..., device="cpu")`,
`serve --device cpu`), where each kernel wrapper runs its plain version.
Every socket read times out within 30 s and every wait is bounded.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import cobs_tpu
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import Search, settings
from cobs_tpu_torch.query.client import QueryClient, ServerError
from cobs_tpu_torch.query.search import QueryError, ResultList
from cobs_tpu_torch.query.server import QueryServer

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    """cobs_tpu hashes on the host (its results equal its device
    hashing's, without a device-hash compile on the CPU) and writes no
    document caches; every setting is restored after the test."""
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    monkeypatch.setattr(jax_settings, "disable_cache", True)
    monkeypatch.setattr(settings, "mega_batches", settings.mega_batches)
    monkeypatch.setattr(settings, "streamed_host_score",
                        settings.streamed_host_score)


def _classic(docs, out, **params):
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(docs), out,
        index_params=cobs_tpu.ClassicIndexParameters(clobber=True,
                                                     **params))
    return str(out)


@pytest.fixture(scope="module")
def index_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server_idx")
    fasta = tmp / "fasta"
    shutil.copytree(DATA / "fasta", fasta)
    old = jax_settings.disable_cache
    jax_settings.disable_cache = True
    try:
        return _classic(fasta, tmp / "idx.cobs_classic")
    finally:
        jax_settings.disable_cache = old


class Client:
    """Line-level JSON client; requests may be pipelined."""

    def __init__(self, address):
        family = socket.AF_UNIX if isinstance(address, str) \
            else socket.AF_INET
        self.sock = socket.socket(family, socket.SOCK_STREAM)
        self.sock.settimeout(TIMEOUT)
        self.sock.connect(address)
        self._rfile = self.sock.makefile("rb")

    def send(self, obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def recv(self):
        line = self._rfile.readline()
        assert line, "server closed the connection"
        return json.loads(line)

    def ask(self, obj):
        self.send(obj)
        return self.recv()

    def close(self):
        self._rfile.close()
        self.sock.close()


def expected(search, query, threshold=0.0, num_results=0):
    """cobs_tpu's answer as the server's JSON shape."""
    return [[r.doc_name, r.score]
            for r in search.search(query, threshold, num_results)]


def _pairs(results):
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def _server(search, tmp_path, name, **kw):
    kw.setdefault("threshold", 0.0)
    kw.setdefault("linger_ms", 1.0)
    return QueryServer(search, unix_path=str(tmp_path / name), **kw)


@pytest.fixture()
def served(index_file, tmp_path):
    """A running port server at floor 0 and cobs_tpu's Search."""
    with _server(Search(index_file, device="cpu"), tmp_path,
                 "cobs.sock") as srv:
        yield srv, cobs_tpu.Search(index_file)


def test_golden_query_through_socket(served):
    srv, direct = served
    c = Client(srv.address)
    r = c.ask({"id": 7, "query": GOLDEN_QUERY})
    assert r["id"] == 7
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    assert r["results"][0] == ["sample1", 20]
    c.close()


def test_per_request_threshold_and_limit(served):
    srv, direct = served
    c = Client(srv.address)
    r = c.ask({"id": 1, "query": GOLDEN_QUERY, "threshold": 0.8})
    assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
    assert r["results"] == [["sample1", 20]]
    r = c.ask({"id": 2, "query": GOLDEN_QUERY, "num_results": 3})
    assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0, 3)
    assert len(r["results"]) == 3
    r = c.ask({"id": 3, "query": GOLDEN_QUERY, "threshold": 0.5,
               "num_results": 2})
    assert r["results"] == expected(direct, GOLDEN_QUERY, 0.5, 2)
    c.close()


def test_pipelined_requests_one_connection(served):
    srv, direct = served
    c = Client(srv.address)
    n = 10
    for i in range(n):
        c.send({"id": i, "query": GOLDEN_QUERY})
    got = [c.recv() for _ in range(n)]
    want = expected(direct, GOLDEN_QUERY)
    assert [r["id"] for r in got] == list(range(n))
    assert all(r["results"] == want for r in got)
    c.close()


def test_concurrent_clients(served):
    srv, direct = served
    want = expected(direct, GOLDEN_QUERY)
    errors = []

    def worker(tag):
        try:
            c = Client(srv.address)
            for i in range(8):
                r = c.ask({"id": [tag, i], "query": GOLDEN_QUERY})
                assert r["id"] == [tag, i]
                assert r["results"] == want
            c.close()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_bad_query_isolated(served):
    srv, direct = served
    c = Client(srv.address)
    c.send({"id": "short", "query": "ACGT"})         # too short
    c.send({"id": "bad", "query": "NNNNOTDNA" * 8})  # non-ACGT
    c.send({"id": "ok", "query": GOLDEN_QUERY})
    by_id = {}
    for _ in range(3):
        r = c.recv()
        by_id[r["id"]] = r
    assert "too short" in by_id["short"]["error"]
    assert "Invalid DNA" in by_id["bad"]["error"]
    assert by_id["ok"]["results"] == expected(direct, GOLDEN_QUERY)
    c.close()


def test_protocol_errors_and_control(served):
    srv, _ = served
    c = Client(srv.address)
    assert c.ask({"cmd": "ping", "id": 0}) == {"id": 0, "ok": True}
    assert "error" in c.ask({"id": 1})                 # no query
    c.sock.sendall(b"this is not json\n")
    assert "error" in c.recv()
    r = c.ask({"id": 2, "query": GOLDEN_QUERY, "threshold": -0.5})
    assert "must be in [0, 1]" in r["error"]
    r = c.ask({"id": "2b", "query": GOLDEN_QUERY, "threshold": 1.5})
    assert "must be in [0, 1]" in r["error"]
    st = c.ask({"cmd": "stats", "id": 3})
    assert st["queries"] == 0 and st["batches"] == 0   # none scored
    assert st["bad_requests"] >= 2
    assert "lat_p50_ms" not in st                      # no samples yet
    assert c.ask({"id": 4, "query": GOLDEN_QUERY})["results"]
    st = c.ask({"cmd": "stats", "id": 5})
    assert st["lat_p50_ms"] > 0 and st["lat_p99_ms"] >= st["lat_p50_ms"]
    c.close()


def test_subfloor_request_served_exactly(index_file, tmp_path):
    """A request below the floor re-ranks its batch at its threshold
    (the slow path) and equals cobs_tpu's answer; requests at or above
    the floor stay on the fast path."""
    direct = cobs_tpu.Search(index_file)
    with _server(Search(index_file, device="cpu"), tmp_path, "floor.sock",
                 threshold=0.8) as srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
        r = c.ask({"id": 1, "query": GOLDEN_QUERY, "threshold": 0.9})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.9)
        r = c.ask({"id": 2, "query": GOLDEN_QUERY, "threshold": 0.0})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0)
        assert len(r["results"]) == 7
        r = c.ask({"id": 3, "query": GOLDEN_QUERY, "threshold": 0.05,
                   "num_results": 3})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.05, 3)
        r = c.ask({"id": 4, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8)
        st = c.ask({"cmd": "stats", "id": 5})
        assert 1 <= st["subfloor_batches"] < st["batches"]
        c.close()


@pytest.fixture(scope="module")
def hetero_indices(tmp_path_factory):
    """Two indexes over the golden corpus with term sizes 31 and 21."""
    tmp = tmp_path_factory.mktemp("hetero_idx")
    fasta = tmp / "fasta"
    shutil.copytree(DATA / "fasta", fasta)
    old = jax_settings.disable_cache
    jax_settings.disable_cache = True
    try:
        return [_classic(fasta, tmp / f"idx{k}.cobs_classic", term_size=k)
                for k in (31, 21)]
    finally:
        jax_settings.disable_cache = old


def test_heterogeneous_federation_per_request_threshold(hetero_indices,
                                                        tmp_path):
    """On a mixed-term-size federation a per-request threshold is a
    score floor per index; above and below the floor the server equals
    cobs_tpu."""
    direct = cobs_tpu.Search(hetero_indices)
    with _server(Search(hetero_indices, device="cpu"), tmp_path,
                 "het.sock", threshold=0.5) as srv:
        c = Client(srv.address)
        for i, thr in enumerate([0.5, 0.8, 0.95, 0.2, 0.0]):
            r = c.ask({"id": i, "query": GOLDEN_QUERY, "threshold": thr})
            assert r["results"] == expected(direct, GOLDEN_QUERY, thr), thr
        r = c.ask({"id": "cap", "query": GOLDEN_QUERY, "threshold": 0.7,
                   "num_results": 4})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.7, 4)
        c.close()


def test_cut_per_index_matches_filter():
    """ResultList.cut_per_index == filtering each entry by its source
    index's floor, order kept, and equal to cobs_tpu's."""
    from cobs_tpu.query.search import ResultList as JaxResultList

    rng = np.random.default_rng(5)
    names = [f"d{i}" for i in range(30)]
    bounds = np.asarray([10, 18, 30])   # three indexes
    gidx = rng.permutation(30)
    scores = np.sort(rng.integers(0, 50, size=30))[::-1]
    order = np.lexsort((gidx, -scores))  # a validly ranked list
    rl = ResultList(names, gidx[order], scores[order].astype(np.int64))
    mins = [10, 25, 40]
    got = rl.cut_per_index(bounds, mins)
    want = [(n, s) for n, s in
            zip([names[g] for g in rl._gidx], rl._scores.tolist())
            if s >= mins[int(np.searchsorted(bounds, int(n[1:]),
                                             side="right"))]]
    assert [(r.doc_name, r.score) for r in got] == want
    jax = JaxResultList(names, gidx[order], scores[order].astype(np.int64))
    assert got.pairs() == jax.cut_per_index(bounds, mins).pairs()


def test_serve_forever_log_interval(index_file, tmp_path, capsys):
    srv = _server(Search(index_file, device="cpu"), tmp_path, "lg.sock")
    t = threading.Thread(target=lambda: srv.serve_forever(log_interval=0.2),
                         daemon=True)
    t.start()
    c = Client(srv.address)
    assert c.ask({"id": 0, "query": GOLDEN_QUERY})["results"]
    time.sleep(0.5)
    c.close()
    srv.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    out = capsys.readouterr().out   # stdout: the RESULT line protocol
    assert "RESULT queries_per_s=" in out and "queries=1" in out


def test_warmup_precompiles(index_file, tmp_path, monkeypatch):
    """warmup() runs one batch of the server's size, before start() and
    only then; no multi-batch group (the kernels take the batch size at
    run time)."""
    direct = cobs_tpu.Search(index_file)
    s = Search(index_file, device="cpu")
    sizes, groups = [], []
    single = s._dispatch_async
    group = s._dispatch_group_async
    monkeypatch.setattr(s, "_dispatch_async",
                        lambda h, n: sizes.append(len(h[0])) or single(h, n))
    monkeypatch.setattr(s, "_dispatch_group_async",
                        lambda g, n: groups.append(len(g)) or group(g, n))
    srv = _server(s, tmp_path, "w.sock")
    srv.warmup(len(GOLDEN_QUERY))
    assert srv._mega == 16 and sizes == [srv.batch_size] and groups == []
    with srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY)
        c.close()
        with pytest.raises(RuntimeError, match="before start"):
            srv.warmup(50)


def test_protocol_fuzz(served, rng):
    """Garbage lines between valid requests: every valid request gets
    its exact answer, and the server never wedges."""
    srv, direct = served
    want = expected(direct, GOLDEN_QUERY)
    c = Client(srv.address)
    garbage = [
        b"\x00\xff\xfe garbage\n",
        b"[1, 2, 3]\n",
        b'"just a string"\n',
        b"{\n",
        b'{"query": 42}\n',
        b'{"query": ""}\n',
        b'{"cmd": "nonsense"}\n',
        b'{"query": "' + b"A" * 40 + b'", "threshold": "high"}\n',
        b'{"query": "' + b"A" * 40 + b'", "num_results": -3}\n',
    ]
    valid_ids = []
    k = 0
    for _ in range(60):
        if rng.random() < 0.5:
            c.sock.sendall(garbage[int(rng.integers(len(garbage)))])
        else:
            c.send({"id": k, "query": GOLDEN_QUERY})
            valid_ids.append(k)
            k += 1
    needed = set(valid_ids)
    for _ in range(70):   # every line sent gets at most one response
        if not needed:
            break
        r = c.recv()
        if r.get("id") in needed and "results" in r:
            assert r["results"] == want
            needed.discard(r["id"])
        else:
            assert "error" in r
    assert not needed
    assert c.ask({"cmd": "ping"})["ok"] is True
    c.close()


def test_topk_serving_mode(index_file, tmp_path):
    direct = cobs_tpu.Search(index_file)
    with _server(Search(index_file, device="cpu"), tmp_path, "k.sock",
                 num_results=5) as srv:
        c = Client(srv.address)
        r = c.ask({"id": 0, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0, 5)
        r = c.ask({"id": 1, "query": GOLDEN_QUERY, "num_results": 2})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.0, 2)
        r = c.ask({"id": 2, "query": GOLDEN_QUERY, "num_results": 99})
        assert "top-k mode" in r["error"]   # k is the ceiling
        r = c.ask({"id": 3, "query": GOLDEN_QUERY, "threshold": 0.8,
                   "num_results": 5})
        assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8, 5)
        assert r["results"] == [["sample1", 20]]
        c.close()


def test_randomized_parity_with_direct(tmp_path, rng):
    """Random corpus, random queries, several thresholds and caps:
    served results equal cobs_tpu's search_batch exactly."""
    from cobs_tpu.construct.classic import classic_construct_random
    from cobs_tpu.utils.misc import random_sequence_rng

    idx = tmp_path / "rand.cobs_classic"
    classic_construct_random(idx, signature_size=4096, num_documents=64,
                             document_size=200, seed=11)
    direct = cobs_tpu.Search(str(idx))
    queries = [random_sequence_rng(int(rng.integers(40, 200)), rng)
               for _ in range(32)]
    with _server(Search(str(idx), device="cpu"), tmp_path, "rp.sock",
                 batch_size=8) as srv:
        with QueryClient(srv.address, timeout=TIMEOUT) as c:
            for thr, lim in ((0.0, 0), (0.0, 7), (0.5, 0), (0.9, 3)):
                got = c.search_batch(queries, threshold=thr,
                                     num_results=lim or None)
                want = direct.search_batch(queries, thr, lim)
                assert _pairs(got) == _pairs(want), (thr, lim)


def test_randomized_hetero_parity_with_direct(tmp_path, rng):
    """Served == cobs_tpu over a mixed-term-size federation, in both
    serving modes, at thresholds above and below the floor."""
    docs = tmp_path / "docs"
    docs.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(24):
        seq = bases[rng.integers(0, 4, size=250 + 17 * i)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idxs = [_classic(docs, tmp_path / f"i{k}.cobs_classic", term_size=k)
            for k in (31, 23)]
    direct = cobs_tpu.Search(idxs)
    queries = [bytes(bases[rng.integers(0, 4, size=n)]).decode()
               for n in rng.integers(40, 150, size=24)]
    for mode_limit in (0, 5):   # full ranking and top-k serving
        with _server(Search(idxs, device="cpu"), tmp_path,
                     f"hr{mode_limit}.sock", threshold=0.3,
                     num_results=mode_limit, batch_size=8) as srv:
            with QueryClient(srv.address, timeout=TIMEOUT) as c:
                for thr in (0.0, 0.1, 0.3, 0.6, 0.9):
                    got = c.search_batch(queries, threshold=thr,
                                         num_results=mode_limit or None)
                    want = direct.search_batch(queries, thr, mode_limit)
                    assert _pairs(got) == _pairs(want), (mode_limit, thr)


def test_tcp_endpoint_and_batching(index_file):
    direct = cobs_tpu.Search(index_file)
    with QueryServer(Search(index_file, device="cpu"), port=0,
                     threshold=0.0, batch_size=8, linger_ms=20.0) as srv:
        c = Client(tuple(srv.address))
        n = 8
        for i in range(n):
            c.send({"id": i, "query": GOLDEN_QUERY})
        want = expected(direct, GOLDEN_QUERY)
        for i in range(n):
            r = c.recv()
            assert r["id"] == i and r["results"] == want
        st = c.ask({"cmd": "stats"})
        assert st["batches"] < st["queries"]   # the linger coalesced
        c.close()


def test_cli_serve_subprocess(index_file, tmp_path):
    """`serve --device cpu` in a subprocess: answers over the socket, and
    SIGTERM drains and exits 0 with the socket file removed. The server's
    standard error goes to a file, printed when an assertion fails."""
    sock = tmp_path / "cli.sock"
    err = tmp_path / "serve.err"
    with open(err, "wb") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cobs_tpu_torch.cli.main", "serve",
             "--device", "cpu", "-i", index_file, "--socket", str(sock),
             "-t", "0", "--linger-ms", "1"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=err_file,
            env=dict(os.environ, COBS_TPU_MEGA_BATCHES="16"))
    try:
        deadline = time.monotonic() + 60
        while not sock.exists():
            assert proc.poll() is None, "serve exited early"
            assert time.monotonic() < deadline, "socket never appeared"
            time.sleep(0.1)
        direct = cobs_tpu.Search(index_file)
        c = Client(str(sock))
        r = c.ask({"id": 0, "query": GOLDEN_QUERY, "threshold": 0.8})
        assert r["results"] == [["sample1", 20]]
        r = c.ask({"id": 1, "query": GOLDEN_QUERY})
        assert r["results"] == expected(direct, GOLDEN_QUERY)
        c.close()
        proc.terminate()
        assert proc.wait(timeout=TIMEOUT) == 0
        assert not sock.exists()
        assert proc.stdout.read().decode().startswith("SERVING ")
    except AssertionError:
        print("serve's standard error:\n"
              + err.read_bytes()[-4000:].decode(errors="replace"))
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        proc.stdout.close()


def test_serve_stop_lets_the_scorer_finish(index_file, tmp_path):
    """stop() (what `cobs serve` calls on SIGTERM and SIGINT) ends
    serve_forever by way of the scorer: the scorer thread has ended, not
    only been marked so (an exception raised into serve_forever's
    Thread.join marks a running thread stopped in CPython 3.12, and the
    interpreter then exits under it); a second stop() enqueues nothing."""
    srv = _server(Search(index_file, device="cpu"), tmp_path, "stop.sock")
    done = threading.Event()
    main = threading.Thread(target=lambda: (srv.serve_forever(),
                                            done.set()))
    main.start()
    try:
        c = Client(srv.address)
        assert c.ask({"id": 0, "query": GOLDEN_QUERY})["id"] == 0
        srv.stop()
        srv.stop()
        assert done.wait(TIMEOUT)
        assert not srv._scorer_thread.is_alive()
        assert srv._rq.qsize() == 0
        c.close()
    finally:
        srv.close()
        main.join(TIMEOUT)
    assert not main.is_alive()
    assert not os.path.exists(srv.address)


def test_serve_stop_gives_up_on_a_stuck_scorer(index_file, tmp_path,
                                               monkeypatch):
    """A scorer that does not end after stop() (a device hang) holds
    serve_forever and close() for STOP_GRACE_S in all, not for good."""
    from cobs_tpu_torch.query import server as server_mod

    monkeypatch.setattr(server_mod, "STOP_GRACE_S", 0.5)
    srv = _server(Search(index_file, device="cpu"), tmp_path, "hang.sock")
    release = threading.Event()
    monkeypatch.setattr(srv, "_scorer", lambda: release.wait(TIMEOUT))
    done = threading.Event()
    main = threading.Thread(target=lambda: (srv.serve_forever(),
                                            done.set()))
    main.start()
    try:
        t0 = time.monotonic()
        srv.stop()
        assert done.wait(TIMEOUT)
        srv.close()
        waited = time.monotonic() - t0
        assert 0.5 <= waited < 5.0, waited
        assert srv._scorer_thread.is_alive()
    finally:
        release.set()
        srv.close()
        main.join(TIMEOUT)
    assert not main.is_alive()

PHASES = ("t_assemble", "t_drain_idle", "t_group", "t_hash", "t_dispatch",
          "t_drain")


def _stats_after_one_query(srv, debug):
    """`stats` keys after one answered query; with the phase timers on,
    once the scorer has drained its window (its last timer)."""
    c = Client(srv.address)
    try:
        assert c.ask({"id": 0, "query": GOLDEN_QUERY})["results"]
        deadline = time.monotonic() + TIMEOUT
        while True:
            st = c.ask({"cmd": "stats", "id": 1})
            if not debug or "t_drain_idle" in st:
                return st
            assert time.monotonic() < deadline, sorted(st)
            time.sleep(0.01)
    finally:
        c.close()


@pytest.mark.parametrize("debug", [False, True])
def test_debug_phase_timers_match_cobs_tpu(index_file, tmp_path, monkeypatch,
                                           debug):
    """With COBS_TPU_SERVER_DEBUG set, `stats` carries cobs_tpu's six
    scorer phase timers (seconds, summed); unset, neither server has
    them: the key sets are equal either way."""
    if debug:
        monkeypatch.setenv("COBS_TPU_SERVER_DEBUG", "1")
    else:
        monkeypatch.delenv("COBS_TPU_SERVER_DEBUG", raising=False)
    from cobs_tpu.query.server import QueryServer as JaxServer

    with _server(Search(index_file, device="cpu"), tmp_path,
                 "t.sock") as srv:
        mine = _stats_after_one_query(srv, debug)
    with JaxServer(cobs_tpu.Search(index_file),
                   unix_path=str(tmp_path / "j.sock"), threshold=0.0,
                   linger_ms=1.0) as srv:
        theirs = _stats_after_one_query(srv, debug)
    assert set(mine) == set(theirs)
    assert (set(PHASES) <= set(mine)) == debug
    if debug:
        assert all(isinstance(mine[k], float) and mine[k] >= 0
                   for k in PHASES)


@pytest.mark.parametrize("debug", [False, True])
def test_server_soak_harness(tmp_path, debug):
    """cobs_tpu_torch/experiments/server_soak.py on the CPU for 3 s: exit
    0 (no wrong response, no batch failure, no connection left open),
    exact responses and reloads counted; with COBS_TPU_SERVER_DEBUG its
    phase line carries the six timers."""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("COBS_TPU_SERVER_DEBUG", None)
    if debug:
        env["COBS_TPU_SERVER_DEBUG"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "cobs_tpu_torch.experiments.server_soak",
         "--device", "cpu", "--seconds", "3"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = {}
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT name="):
            fields = dict(f.split("=", 1) for f in line.split()[1:])
            result[fields.pop("name")] = fields
    soak = result["server_soak"]
    assert soak["ok"] == "True" and soak["open_conns_at_close"] == "0"
    assert soak["batch_failures"] == "0"
    assert int(soak["exact_queries"]) > 0 and int(soak["reloads"]) > 0
    assert int(soak["chaos_conns"]) > 0 and int(soak["bad_requests"]) > 0
    phases = result.get("server_soak_phases")
    assert (phases is not None) == debug
    if debug:
        assert {f"{k}_ms_per_batch" for k in PHASES} <= set(phases)


def test_query_client(served):
    srv, direct = served
    with QueryClient(srv.address, timeout=TIMEOUT) as c:
        assert c.ping()
        hits = c.search(GOLDEN_QUERY, threshold=0.8)
        assert [(r.doc_name, r.score) for r in hits] == [("sample1", 20)]
        assert _pairs([hits]) == _pairs([direct.search(GOLDEN_QUERY, 0.8)])
        batch = c.search_batch([GOLDEN_QUERY, "ACGT", GOLDEN_QUERY],
                               num_results=2)
        assert _pairs(batch[:1]) == _pairs([direct.search(GOLDEN_QUERY,
                                                          0.0, 2)])
        assert isinstance(batch[1], QueryError)
        assert batch[2] == batch[0]
        with pytest.raises(ServerError):
            c.search("ACGT")
        assert c.stats()["queries"] >= 4


def test_connection_cleanup(served):
    """Closed clients leave no fd, thread or _conns entry behind."""
    srv, _ = served
    for _ in range(5):
        c = Client(srv.address)
        assert c.ask({"cmd": "ping"})["ok"] is True
        c.close()
    deadline = time.monotonic() + 10
    while srv._conns and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not srv._conns


def test_scorer_survives_internal_error(served, monkeypatch):
    """A scoring exception answers its batch and the server lives on."""
    srv, direct = served
    orig = srv.search._dispatch_async
    state = {"boomed": False}

    def boom(hashed, num_results):
        if not state["boomed"]:
            state["boomed"] = True
            raise RuntimeError("induced failure")
        return orig(hashed, num_results)

    monkeypatch.setattr(srv.search, "_dispatch_async", boom)
    c = Client(srv.address)
    assert "internal error" in c.ask({"id": 0, "query": GOLDEN_QUERY})[
        "error"]
    r = c.ask({"id": 1, "query": GOLDEN_QUERY})
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    assert c.ask({"cmd": "stats"})["batch_failures"] == 1
    c.close()


def test_shared_client_across_threads(served):
    """One QueryClient shared by threads: calls serialize and stay
    exact."""
    srv, direct = served
    want = _pairs([direct.search(GOLDEN_QUERY, 0.8)])
    errors = []

    def worker(c):
        try:
            for _ in range(5):
                assert _pairs([c.search(GOLDEN_QUERY, threshold=0.8)]) \
                    == want
        except Exception as e:
            errors.append(e)

    with QueryClient(srv.address, timeout=TIMEOUT) as c:
        ts = [threading.Thread(target=worker, args=(c,)) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errors


@pytest.mark.parametrize("score", ["host", "device"])
def test_server_streamed_backend(index_file, tmp_path, score):
    """The server over the host-mmap backend, host and device scoring
    (the latter runs the plain gather-and-count here): one dispatch per
    batch, answers equal cobs_tpu's."""
    settings.streamed_host_score = score
    direct = cobs_tpu.Search(index_file)
    s = Search(index_file, device="cpu", streamed=True)
    assert s.index_files[0].scores_on_host() == (score == "host")
    with _server(s, tmp_path, "st.sock", batch_size=4) as srv:
        assert srv._mega == 1
        c = Client(srv.address)
        for i in range(12):
            c.send({"id": i, "query": GOLDEN_QUERY,
                    "threshold": (0.0, 0.8)[i % 2]})
        for i in range(12):
            r = c.recv()
            assert r["id"] == i
            assert r["results"] == expected(direct, GOLDEN_QUERY,
                                            (0.0, 0.8)[i % 2])
        assert c.ask({"cmd": "stats"})["mega_dispatches"] == 0
        c.close()


@pytest.mark.parametrize("n_batch,n_docs,num_results",
                         [(1, 4, 0), (2, 2, 5)])
def test_server_mesh_sharded(index_file, tmp_path, n_batch, n_docs,
                             num_results):
    """tests/test_server.py::test_server_mesh_sharded: the server over a
    Search sharded on a mesh of the CPU device, full ranking and top-k:
    single requests, then a pipelined burst that forms multi-batch groups
    over the mesh; every answer equals cobs_tpu's."""
    from cobs_tpu_torch.parallel.sharded import make_mesh

    mesh = make_mesh(n_batch, n_docs, ["cpu"] * (n_batch * n_docs))
    s = Search(index_file, mesh=mesh)
    direct = cobs_tpu.Search(index_file)
    with _server(s, tmp_path, "m.sock", batch_size=4,
                 num_results=num_results) as srv:
        assert srv._mega > 1
        c = Client(srv.address)
        for i in range(3):
            r = c.ask({"id": i, "query": GOLDEN_QUERY, "threshold": 0.8})
            assert r["results"] == expected(direct, GOLDEN_QUERY, 0.8,
                                            num_results)
        queries = [GOLDEN_QUERY[j:] for j in range(12)] * 4
        for i, q in enumerate(queries):
            c.send({"id": i, "query": q, "threshold": (0.0, 0.8)[i % 2]})
        for i, q in enumerate(queries):
            r = c.recv()
            assert r["id"] == i
            assert r["results"] == expected(direct, q, (0.0, 0.8)[i % 2],
                                            num_results)
        c.close()


def test_reload_swaps_index_without_restart(tmp_path):
    """{"cmd": "reload"}: the new index answers; a failed reload leaves
    the old one serving."""
    full = tmp_path / "full"
    shutil.copytree(DATA / "fasta", full)
    small = tmp_path / "small"
    small.mkdir()
    shutil.copy(full / "sample1.fasta", small / "sample1.fasta")
    idx_full = _classic(full, tmp_path / "full.cobs_classic")
    idx_small = _classic(small, tmp_path / "small.cobs_classic")

    def factory(paths=None):
        return Search(list(paths) if paths else [idx_full], device="cpu")

    with _server(factory(), tmp_path, "r.sock",
                 search_factory=factory) as srv:
        with QueryClient(srv.address, timeout=TIMEOUT) as c:
            assert _pairs([c.search(GOLDEN_QUERY)]) == _pairs(
                [cobs_tpu.Search(idx_full).search(GOLDEN_QUERY)])
            assert c.reload([idx_small]) == {"documents": 1, "indices": 1}
            assert [(r.doc_name, r.score)
                    for r in c.search(GOLDEN_QUERY)] == [("sample1", 20)]
            with pytest.raises(ServerError, match="reload failed"):
                c.reload([str(tmp_path / "missing.cobs_classic")])
            assert len(c.search(GOLDEN_QUERY)) == 1
            with pytest.raises(ServerError, match="non-empty"):
                c.reload([])
            assert c.reload()["documents"] == 7
            assert len(c.search(GOLDEN_QUERY)) == 7
            st = c.stats()
            assert st["reloads"] == 2 and st["failed_reloads"] == 1


def test_reload_unconfigured_is_an_error(served):
    srv, _ = served
    with QueryClient(srv.address, timeout=TIMEOUT) as c:
        with pytest.raises(ServerError, match="not configured"):
            c.reload()


def test_server_on_compact_and_federation(tmp_path):
    fasta = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", fasta)
    compact = tmp_path / "idx.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(fasta), compact,
        index_params=cobs_tpu.CompactIndexParameters(clobber=True))
    direct = cobs_tpu.Search(str(compact))
    with _server(Search(str(compact), device="cpu"), tmp_path,
                 "c.sock") as srv:
        c = Client(srv.address)
        for thr in (0.0, 0.8):
            r = c.ask({"id": thr, "query": GOLDEN_QUERY, "threshold": thr})
            assert r["results"] == expected(direct, GOLDEN_QUERY, thr)
        c.close()

    d1, d2 = tmp_path / "d1", tmp_path / "d2"
    d1.mkdir()
    d2.mkdir()
    samples = sorted(fasta.iterdir())
    for p in samples[:3]:
        shutil.copy(p, d1 / p.name)
    for p in samples[3:]:
        shutil.copy(p, d2 / p.name)
    fed = [_classic(d1, tmp_path / "s1.cobs_classic"),
           _classic(d2, tmp_path / "s2.cobs_classic")]
    fed_direct = cobs_tpu.Search(fed)
    with _server(Search(fed, device="cpu"), tmp_path, "f.sock") as srv:
        c = Client(srv.address)
        for thr in (0.0, 0.5, 0.8):
            r = c.ask({"id": thr, "query": GOLDEN_QUERY, "threshold": thr})
            assert r["results"] == expected(fed_direct, GOLDEN_QUERY, thr)
        c.close()


def test_stall_breaker_rejects_new_queries(served, monkeypatch):
    """While the scorer is blocked past stall_timeout, NEW queries get
    an immediate 'server stalled' error; the blocked request completes
    once the scorer moves, and the flag clears."""
    srv, direct = served
    srv.stall_timeout_s = 0.3
    c = Client(srv.address)
    assert c.ask({"id": "warm", "query": GOLDEN_QUERY})["results"]

    gate = threading.Event()
    orig = srv.search._finish_batch

    def blocked_finish(*a, **kw):
        assert gate.wait(TIMEOUT), "test gate never released"
        return orig(*a, **kw)

    monkeypatch.setattr(srv.search, "_finish_batch", blocked_finish)
    c.send({"id": "slow", "query": GOLDEN_QUERY})   # wedges the scorer
    time.sleep(0.8)   # > stall_timeout past the scorer's last progress

    c2 = Client(srv.address)
    r = c2.ask({"id": "rejected", "query": GOLDEN_QUERY})
    assert r["id"] == "rejected" and "stalled" in r["error"]
    st = c2.ask({"cmd": "stats"})   # the control plane stays live
    assert st["stalled"] is True and st["stalled_rejects"] == 1

    gate.set()
    r = c.recv()
    assert r["id"] == "slow"
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    deadline = time.monotonic() + TIMEOUT
    while c2.ask({"cmd": "stats"})["stalled"]:
        assert time.monotonic() < deadline, "stall flag never cleared"
        time.sleep(0.02)
    r = c2.ask({"id": "after", "query": GOLDEN_QUERY})
    assert r["results"] == expected(direct, GOLDEN_QUERY)
    c.close()
    c2.close()


def test_large_pipelined_burst_single_connection(index_file, tmp_path):
    """One connection pipelining more requests than its send queue holds
    gets every response (the queue absorbs a whole multi-batch group of
    back-to-back responses)."""
    with _server(Search(index_file, device="cpu"), tmp_path, "burst.sock",
                 batch_size=8) as srv:
        assert srv._send_queue >= 2 * 8 * srv._mega
        c = Client(srv.address)
        n = srv._send_queue + 256
        for i in range(n):
            c.send({"id": i, "query": GOLDEN_QUERY})
        got = [c.recv() for _ in range(n)]
        assert [r["id"] for r in got] == list(range(n))
        assert all(r["results"][0] == ["sample1", 20] for r in got)
        st = c.ask({"cmd": "stats", "id": "s"})
        assert st["overflowed_connections"] == 0
        assert st["mega_dispatches"] > 0
        c.close()


def test_heterogeneous_topk_mode_per_request_threshold(tmp_path):
    """Top-k mode on a mixed-term-size federation: the per-index
    refinement must not lose entries to a merged floor-k cut (the server
    ranks with n_indices * k candidates and caps after refining). The
    corpus and seed are tests/test_server.py's, where capping first
    provably diverges on query 8 at threshold 0.5."""
    rng = np.random.default_rng(42)
    docs = tmp_path / "docs"
    docs.mkdir()
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(32):
        seq = bases[rng.integers(0, 4, size=400)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idxs = [_classic(docs, tmp_path / f"i{k}.cobs_classic", term_size=k)
            for k in (31, 21)]
    direct = cobs_tpu.Search(idxs)
    queries = [bytes(bases[rng.integers(0, 4, size=70)]).decode()
               for _ in range(20)]
    assert [(r.doc_name, r.score)
            for r in direct.search(queries[8], 0.5, 4)] == [("d15", 21)]
    with _server(Search(idxs, device="cpu"), tmp_path, "hetk.sock",
                 num_results=4) as srv:
        c = Client(srv.address)
        for qi, q in enumerate(queries):
            for thr in (0.0, 0.2, 0.35, 0.5):
                r = c.ask({"id": [qi, thr], "query": q, "threshold": thr})
                assert r["results"] == expected(direct, q, thr, 4), (qi,
                                                                     thr)
        r = c.ask({"id": "k2", "query": queries[8], "threshold": 0.5,
                   "num_results": 2})
        assert r["results"] == expected(direct, queries[8], 0.5, 2)
        c.close()


def test_switch_interval_restored_on_close(index_file, tmp_path):
    before = sys.getswitchinterval()
    with _server(Search(index_file, device="cpu"), tmp_path, "si.sock"):
        assert sys.getswitchinterval() <= 0.0005
    assert sys.getswitchinterval() == before


def test_slo_adaptive_mega_ceiling(index_file, tmp_path):
    """A violated p99 target shrinks the multi-batch ceiling toward one
    dispatch per batch and caps the linger; lifting the target restores
    the static ceiling. Results stay exact."""
    direct = cobs_tpu.Search(index_file)
    with _server(Search(index_file, device="cpu"), tmp_path, "slo.sock",
                 linger_ms=50.0, batch_size=4, slo_ms=0.001) as srv:
        assert srv._mega > 1, "multi-batch dispatch must be on here"
        assert srv._linger_eff() <= srv.slo_ms / 8e3 + 1e-12
        c = Client(srv.address)
        want = expected(direct, GOLDEN_QUERY)
        deadline = time.monotonic() + 60
        shrunk = False
        while time.monotonic() < deadline and not shrunk:
            for i in range(64):
                c.send({"id": i, "query": GOLDEN_QUERY})
            for _ in range(64):
                assert c.recv()["results"] == want
            st = c.ask({"cmd": "stats"})
            shrunk = st["slo_shrinks"] >= 1 and st["mega_effective"] == 1
        assert shrunk, "the SLO violation never shrank the ceiling"
        srv.slo_ms = 0.0
        assert c.ask({"cmd": "stats"})["mega_effective"] == srv._mega
        c.close()


def test_slo_aimd_growth_and_shrink(index_file, tmp_path):
    """_slo_adjust: a p99 well under the target grows the ceiling one
    step at a time to the static cap; a violating window halves it, and
    the same stale window does not halve it twice."""
    with _server(Search(index_file, device="cpu"), tmp_path, "slo2.sock",
                 slo_ms=1000.0) as srv:   # idle: the scorer never adjusts
        srv._mega_eff = 1

        def feed(samples):   # what _emit_ranked records
            srv._lat.extend(samples)
            srv._lat_count += len(samples)

        feed([1.0] * 64)
        for step in range(1, srv._mega):
            srv._slo_last = 0.0
            feed([1.0] * 32)
            srv._slo_adjust()
            assert srv._mega_eff == 1 + step
        assert srv._mega_eff == srv._mega
        srv._slo_last = 0.0
        srv._slo_adjust()                 # no fresh samples: no change
        assert srv._mega_eff == srv._mega
        feed([5000.0] * 256)
        srv._slo_last = 0.0
        srv._slo_adjust()
        assert srv._mega_eff == max(1, srv._mega // 2)
        srv._slo_last = 0.0
        srv._slo_adjust()
        assert srv._mega_eff == max(1, srv._mega // 2)
