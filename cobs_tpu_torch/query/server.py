"""Resident query server: dynamic batching over a socket.

The port of `cobs_tpu/query/server.py`. The reference's query loop lives
and dies inside one process invocation (reference: src/cobs.cpp:471-527);
a serving deployment keeps the index on the card, coalesces concurrent
client queries into device batches and keeps a bounded window of
batches in flight, so ranking batch k overlaps scoring batch k+1.

`QueryServer` speaks newline-delimited JSON on a Unix domain socket or
TCP:

  request : {"query": "ACGT...", "id": <any>, "threshold": <float>,
             "num_results": <int>}            (id/threshold/limit optional)
  response: {"id": ..., "results": [[doc_name, score], ...]}
          | {"id": ..., "error": "message"}
  control : {"cmd": "ping"}   -> {"id": ..., "ok": true}
            {"cmd": "stats"}  -> {"queries": N, "batches": N, ...}
            {"cmd": "reload", "indices": [...]}  (optional list)

Batching: requests arriving within `linger_ms` of the first one coalesce
into a batch of up to `batch_size` queries. When the queue runs deeper
than one batch, up to `settings.mega_batches` full batches go to the
card as one payload (multi-batch dispatch: one upload and one launch of
the hash kernel, the gather-and-count kernel and the top-k,
`Search._dispatch_group_async`), which divides the host's per-batch
dispatch and fetch cost; shallow queues keep one dispatch per batch for
bounded latency. The scorer ranks every batch once at the server's floor
(threshold `t_floor`, result cap `limit`); a request may RAISE the
threshold or LOWER the cap, both prefix cuts of the (score desc, doc
asc) list (`ResultList.cut`). A request BELOW the floor lowers its whole
batch's rank threshold instead (the slow path: a longer ranked list, the
same dispatch), and on mixed-term-size federations a raised threshold
refines with a per-index score floor (`ResultList.cut_per_index`), so
every answer equals what the embedded `Search` returns.

Threads: each connection has a reader thread and a bounded outbound
queue drained by a writer thread, so one slow client stalls only itself.
One scorer thread does all device work (hashing, upload, launches,
fetch, the streamed backend's staging ring); readers and writers touch
no tensor, since a `ResultList` holds numpy arrays only. An invalid
query gets an error in its own slot; the rest of its batch scores
(`Search._hash_batch_lenient`).
"""

import collections
import json
import math
import os
import queue
import socket
import sys
import threading
import time

import numpy as np
import torch

from cobs_tpu_torch import native
from cobs_tpu_torch.query.search import QueryError, Search
from cobs_tpu_torch.utils.misc import random_sequence_rng
from cobs_tpu_torch.utils.timer import Timer

_STOP = object()


class _LazyResult:
    """A result response rendered on the connection's writer thread, so
    serialization (the native `ResultFormatter`) overlaps the scorer's
    device work instead of taking scorer time."""

    __slots__ = ("rid", "res", "fmt")

    def __init__(self, rid, res, fmt):
        self.rid = rid
        self.res = res
        self.fmt = fmt

    def render(self) -> bytes:
        return (b'{"id": %s, "results": %s}\n'
                % (json.dumps(self.rid).encode(),
                   self.res.serialize_with(self.fmt)))


class _Reload:
    """Control item: swap the index set between batches."""

    __slots__ = ("conn", "rid", "paths")

    def __init__(self, conn, rid, paths):
        self.conn = conn
        self.rid = rid
        self.paths = paths


class _Conn:
    """One client connection: a bounded outbound queue and its writer
    thread.

    The scorer never blocks on a client socket: `send` enqueues objects
    (serialized on the writer thread), and a full queue (a client that
    pipelines faster than it reads) closes that connection rather than
    dropping single responses: the protocol is one response per request,
    so a gap would desync the client for good, while a closed socket is
    an error the client sees.
    """

    def __init__(self, sock, server):
        self.sock = sock
        self.server = server
        self.alive = True
        # sized for a whole multi-batch group of responses enqueued back
        # to back by the scorer: a smaller queue would close healthy
        # pipelining clients
        self._outq = queue.Queue(server._send_queue)
        self._writer = threading.Thread(target=self._write_loop,
                                        daemon=True)
        self._writer.start()

    def send(self, obj) -> None:
        if not self.alive:
            return
        try:
            self._outq.put_nowait(obj)
        except queue.Full:
            self.server._count("overflowed_connections")
            self.close()

    def _write_loop(self):
        stop = False
        while not stop:
            obj = self._outq.get()
            if obj is _STOP:
                break
            # everything already queued goes out in one write: a scored
            # batch enqueues its responses back to back
            batch = [obj]
            while len(batch) < 512:
                try:
                    nxt = self._outq.get_nowait()
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            if not self.alive:
                continue  # drain without sending; producers never block
            try:
                payload = b"".join(
                    o.render() if isinstance(o, _LazyResult)
                    else (json.dumps(o) + "\n").encode()
                    for o in batch)
            except Exception:
                # a render failure must not kill the writer silently (a
                # dead writer is a hung connection): shut the socket so
                # the client sees it
                self.server._count("batch_failures")
                try:
                    self.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.alive = False
                continue
            try:
                self.sock.sendall(payload)
            except OSError:
                self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass

    def finish(self, timeout: float = 10.0) -> None:
        """Graceful close: flush the queued responses, then close; the
        abortive close() if the writer cannot drain in time."""
        try:
            self._outq.put_nowait(_STOP)
        except queue.Full:
            self.close()
            return
        self._writer.join(timeout)
        if self._writer.is_alive():
            self.close()
        else:
            self.alive = False

    def close(self):
        self.alive = False
        # a full shutdown unblocks a writer stuck in sendall() to a
        # stalled client, so close() never hangs behind it
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        while True:
            try:
                self._outq.put_nowait(_STOP)
                return
            except queue.Full:
                try:
                    self._outq.get_nowait()
                except queue.Empty:
                    pass


class QueryServer:
    """Serve one or more indexes over a socket with dynamic batching.

    Parameters
    ----------
    search : Search | index path(s)
        An open `Search` (device-held, streamed or mesh-sharded
        indexes) or what its
        constructor takes (then opened on settings.device, CUDA by
        default).
    unix_path : str | None
        Serve on a Unix domain socket at this path...
    host, port : ...else on this TCP endpoint; port=0 picks a free port
        (see `.address`).
    batch_size : most queries coalesced into one device batch.
    linger_ms : how long the batcher waits for more queries after the
        first of a batch arrives; 0 scores singletons at once.
    threshold : the server's score floor (reference default 0.8), the
        threshold batches are ranked at. Per-request thresholds above it
        are prefix cuts; below it, the request's batch ranks at the
        lower threshold (the slow path, exact).
    num_results : 0 = full ranking; k > 0 = top-k serving (per-request
        caps must be <= k).
    depth : batches kept dispatched ahead while the oldest is fetched.
    search_factory : callable(paths | None) -> Search, optional. Enables
        `{"cmd": "reload"}`: build the index set again (the same paths,
        or the request's "indices") and swap it in without dropping the
        process, the sockets or a queued request. The scorer thread
        builds it between batches while the old set is still bound, so
        a failed build leaves the old set serving; the card then holds
        both sets for the length of the load (2x the device memory of
        the index set).
    stall_timeout : liveness breaker, seconds (0 disables). Once the
        scoring pipeline has made no progress for this long (a device
        wait or a reload that does not return), NEW queries are
        answered at once with a "server stalled" error instead of
        queueing; queries accepted before stay queued, and ping/stats
        keep working. Must exceed the slowest legitimate pause (the
        first kernel build with nvcc, a full reload).
    slo_ms : optional p99 latency target, ms (0 disables). Multi-batch
        dispatch trades latency for throughput: every response of a
        group waits for the whole group. With a target, the group
        ceiling adapts (AIMD on the rolling p99, `_slo_adjust`) and the
        linger is capped at slo/8.

    The scorer thread makes the index set's CUDA device current before
    its first device call. `start()` lowers the interpreter's thread
    switch interval for the scorer's sake and `close()` restores it.
    """

    def __init__(self, search, *, unix_path=None, host="127.0.0.1",
                 port=0, batch_size=64, linger_ms=2.0, threshold=0.8,
                 num_results=0, depth=2, search_factory=None,
                 stall_timeout=300.0, slo_ms=0.0):
        if not (0.0 <= threshold <= 1.0):
            raise ValueError("threshold must be in [0, 1]")
        if slo_ms < 0:
            raise ValueError("slo_ms must be >= 0")
        self.t_floor = float(threshold)
        self.limit = int(num_results)
        self.batch_size = int(batch_size)
        self.linger_s = float(linger_ms) / 1e3
        self.depth = int(depth)
        self.stall_timeout_s = float(stall_timeout)
        # latency SLO (p99 target, ms; 0 = throughput mode): the
        # multi-batch ceiling adapts to the rolling p99 (_slo_adjust)
        self.slo_ms = float(slo_ms)
        self._slo_last = 0.0
        self._lat_count = 0     # cumulative samples (AIMD freshness)
        self._slo_seen = 0      # _lat_count at the last adjustment
        # monotonic stamp of the scorer's latest progress; None = idle.
        # Stale while the scorer is blocked inside device work (a float
        # read or write is atomic: intake reads it without the lock)
        self._busy_since = None
        self._factory = search_factory
        self._bind_search(search if isinstance(search, Search)
                          else Search(search))

        self.unix_path = unix_path
        if unix_path is not None:
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            if os.path.exists(unix_path):
                os.unlink(unix_path)
            self._listener.bind(unix_path)
        else:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
        self._listener.listen(64)

        self._rq = queue.Queue()
        self._conns: list[_Conn] = []
        self._lock = threading.Lock()
        self._stats = collections.Counter()
        # rolling end-to-end (intake -> response enqueue) latencies, ms
        self._lat = collections.deque(maxlen=4096)
        self._started = False
        self._closed = False

    def _bind_search(self, search: Search) -> None:
        """Adopt `search` as the serving index set (init and reload)."""
        if not search.index_files:
            raise ValueError("QueryServer needs at least one index")
        term_sizes = {ix.term_size for ix in search.index_files}
        # one term size: a per-request threshold is one prefix cut; mixed
        # federations refine with a per-index floor (cut_per_index)
        self._uniform_ts = (term_sizes.pop()
                            if len(term_sizes) == 1 else None)
        self._term_sizes = [ix.term_size for ix in search.index_files]
        self._doc_bounds = np.cumsum(
            [len(ix.file_names) for ix in search.index_files])
        self._total_docs = int(self._doc_bounds[-1])
        # the multi-batch ceiling (1 = a dispatch per batch), capped for
        # full ranking by the device budget; recomputed on reload since
        # the backend may change, and computed by Search, so serving and
        # search_stream never diverge
        self._mega = search._mega_k_capped(self.batch_size, self.limit)
        # the ceiling under an SLO (scorer thread only; starts at the
        # static one and halves on p99 violations)
        self._mega_eff = self._mega
        self._send_queue = max(1024,
                               2 * self.batch_size * self._mega + 64)
        # a reload may raise the burst size (streamed -> device-held):
        # live connections grow their queues, or the first group's burst
        # would close them as overflowed
        conns = getattr(self, "_conns", None)
        if conns is not None:
            with self._lock:
                for c in conns:
                    c._outq.maxsize = max(c._outq.maxsize,
                                          self._send_queue)
        self._fmt = native.ResultFormatter(search._names)
        # the card the scorer makes current: a streamed index may name
        # "cuda" without an index, which means the binding thread's card;
        # on a mesh, the first cell's (each launch then makes its own
        # cell's device current)
        dev = (search.mesh.devices[0][0] if search.mesh is not None
               else search.index_files[0].device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        self.search = search

    def _use_device(self) -> None:
        """Make the index set's CUDA device current on this thread."""
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)

    # ------------------------------------------------------------ public

    @property
    def address(self):
        """The bound endpoint: unix path or (host, port)."""
        return self.unix_path if self.unix_path is not None \
            else self._listener.getsockname()

    def start(self) -> None:
        """Start the accept loop and the scorer thread (non-blocking)."""
        if self._started:
            return
        # the scorer's dispatch path is many short GIL-held steps; with
        # reader and writer threads busy too, the default 5 ms switch
        # interval convoys each handoff into milliseconds (cobs_tpu's
        # server measured it). Serving favours the scorer; close()
        # restores the process-wide interval.
        if sys.getswitchinterval() > 0.0005:
            self._prev_switchinterval = sys.getswitchinterval()
            sys.setswitchinterval(0.0005)
        self._started = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._scorer_thread = threading.Thread(target=self._scorer,
                                               daemon=True)
        self._accept_thread.start()
        self._scorer_thread.start()

    def warmup(self, query_len: int) -> None:
        """Build and load the kernels (on a card the first use of a
        kernel compiles it with nvcc, tens of seconds) by running one
        batch of this server's size with `query_len`-character queries,
        so the first clients meet no build. A multi-batch group needs
        nothing more: the kernels take the batch size at run time. Call
        before `start()`."""
        if self._started:
            raise RuntimeError("warmup() must run before start()")
        ts = max(ix.term_size for ix in self.search.index_files)
        query_len = max(int(query_len), ts)
        rng = np.random.default_rng(0xC0B5)
        qs = [random_sequence_rng(query_len, rng)
              for _ in range(self.batch_size)]
        self.search.search_batch(qs, self.t_floor, self.limit)

    def serve_forever(self, log_interval: float = 0.0) -> None:
        """start() and block until close() (for the CLI).

        log_interval > 0 prints a RESULT line (the reference's benchmark
        line protocol, reference: src/cobs.cpp:647-662) every that many
        seconds with the interval's throughput and the counters.
        """
        self.start()
        if log_interval <= 0:
            self._scorer_thread.join()
            return
        last_q = 0
        last_t = time.monotonic()
        while self._scorer_thread.is_alive():
            self._scorer_thread.join(timeout=log_interval)
            if not self._scorer_thread.is_alive():
                break
            with self._lock:
                st = dict(self._stats)
            now = time.monotonic()
            q = st.get("queries", 0)
            qps = (q - last_q) / max(now - last_t, 1e-9)
            p50, p99 = self._latency_ms()
            lat = (f"lat_p50_ms={p50} lat_p99_ms={p99} "
                   if p50 is not None else "")
            print(f"RESULT queries_per_s={qps:.1f} {lat}queries={q} "
                  f"batches={st.get('batches', 0)} "
                  f"conns={len(self._conns)} "
                  f"query_errors={st.get('query_errors', 0)} "
                  f"bad_requests={st.get('bad_requests', 0)} "
                  f"batch_failures={st.get('batch_failures', 0)} "
                  f"stalled={int(self._stall_seconds() > 0)}",
                  flush=True)
            last_q, last_t = q, now

    def close(self) -> None:
        """Stop accepting, flush the batches in flight, shut down."""
        if self._closed:
            return
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        if self._started:
            self._rq.put(_STOP)
            self._scorer_thread.join(timeout=60)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # responses the scorer already enqueued reach their clients
            c.finish()
        if self.unix_path is not None and os.path.exists(self.unix_path):
            os.unlink(self.unix_path)
        prev = getattr(self, "_prev_switchinterval", None)
        if prev is not None:
            sys.setswitchinterval(prev)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- intake

    def _count(self, key, n=1):
        with self._lock:
            self._stats[key] += n

    def _stall_seconds(self) -> float:
        """Seconds the scorer has been blocked without progress, once
        past the stall timeout; 0.0 while healthy, idle or disabled."""
        if self.stall_timeout_s <= 0:
            return 0.0
        busy = self._busy_since
        if busy is None:
            return 0.0
        blocked = time.monotonic() - busy
        return blocked if blocked > self.stall_timeout_s else 0.0

    def _mega_ceiling(self) -> int:
        """This pass's multi-batch group cap: the static ceiling, or the
        adaptive one under an SLO."""
        return self._mega_eff if self.slo_ms > 0 else self._mega

    def _linger_eff(self) -> float:
        """The batch linger, capped to 1/8 of the SLO target when one is
        set (on a shallow queue lingering is pure added latency)."""
        if self.slo_ms <= 0:
            return self.linger_s
        return min(self.linger_s, self.slo_ms / 8e3)

    def _slo_adjust(self) -> None:
        """AIMD control of the group ceiling from the rolling p99
        (scorer thread only): a p99 above the SLO halves the cap (a
        response waits for its whole group), a p99 under 70 % of it
        grows the cap back one step. Each adjustment needs fresh
        evidence: at most one per 250 ms and >= 32 new samples since the
        last, judged over only those samples, so one slow group cannot
        cascade several halvings at low request rates."""
        if self.slo_ms <= 0:
            return
        now = time.monotonic()
        if now - self._slo_last < 0.25:
            return
        with self._lock:
            fresh = self._lat_count - self._slo_seen
            if fresh < 32:
                return
            recent = list(self._lat)[-min(256, fresh):]
        self._slo_last = now
        self._slo_seen = self._lat_count
        if not recent:
            return
        recent.sort()
        p99 = recent[min(len(recent) - 1, int(len(recent) * 0.99))]
        if p99 > self.slo_ms and self._mega_eff > 1:
            self._mega_eff = max(1, self._mega_eff // 2)
            self._count("slo_shrinks")
        elif p99 < 0.7 * self.slo_ms and self._mega_eff < self._mega:
            self._mega_eff += 1
            self._count("slo_grows")

    def _latency_ms(self):
        """(p50, p99) over the rolling window, or (None, None)."""
        with self._lock:  # the scorer extends it concurrently
            samples = sorted(self._lat)
        if not samples:
            return None, None
        n = len(samples)
        return (round(samples[n // 2], 2),
                round(samples[min(n - 1, int(n * 0.99))], 2))

    def _accept_loop(self):
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            conn = _Conn(sock, self)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    MAX_LINE = 64 << 20  # a 100k-term query is ~100 KB

    def _read_loop(self, conn):
        f = conn.sock.makefile("rb")
        try:
            while True:
                line = f.readline(self.MAX_LINE + 1)
                if not line:
                    break
                if len(line) > self.MAX_LINE:
                    conn.send({"id": None,
                               "error": "request line too long"})
                    break
                if not line.strip():
                    continue
                self._handle_line(conn, line)
        except OSError:
            pass
        finally:
            # a finished client must not leak its fd, writer thread or
            # _conns entry over a long-running server's life
            conn.close()
            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    def _handle_line(self, conn, line):
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            self._count("bad_requests")
            conn.send({"id": None, "error": f"bad request: {e}"})
            return
        rid = req.get("id")
        cmd = req.get("cmd")
        if cmd == "ping":
            conn.send({"id": rid, "ok": True})
            return
        if cmd == "stats":
            st = {k: 0 for k in ("queries", "batches", "query_errors",
                                 "bad_requests", "batch_failures",
                                 "overflowed_connections", "reloads",
                                 "failed_reloads", "stalled_rejects",
                                 "mega_dispatches",
                                 "subfloor_batches", "slo_shrinks",
                                 "slo_grows")}
            with self._lock:
                st.update(self._stats)
            st["stalled"] = self._stall_seconds() > 0
            st["mega_effective"] = self._mega_ceiling()
            p50, p99 = self._latency_ms()
            if p50 is not None:
                st["lat_p50_ms"] = p50
                st["lat_p99_ms"] = p99
            st["id"] = rid
            conn.send(st)
            return
        if cmd == "reload":
            if self._factory is None:
                conn.send({"id": rid, "error":
                           "server not configured for reload (no "
                           "search_factory; `cobs serve` sets one)"})
                return
            paths = req.get("indices")
            if paths is not None and (
                    not isinstance(paths, list) or not paths
                    or not all(isinstance(p, str) for p in paths)):
                conn.send({"id": rid, "error":
                           "'indices' must be a non-empty list of "
                           "paths (omit it to reload the original "
                           "set)"})
                return
            self._rq.put(_Reload(conn, rid, paths))
            return
        if cmd is not None:
            conn.send({"id": rid, "error": f"unknown cmd {cmd!r}"})
            return

        query = req.get("query")
        if not isinstance(query, str) or not query:
            self._count("bad_requests")
            conn.send({"id": rid,
                       "error": "request needs a non-empty "
                                "string 'query'"})
            return
        thr = req.get("threshold", self.t_floor)
        lim = req.get("num_results", self.limit)
        try:
            thr = float(thr)
            lim = int(lim)
        except (TypeError, ValueError):
            conn.send({"id": rid, "error": "threshold must be a "
                       "number, num_results an integer"})
            return
        if not (0.0 <= thr <= 1.0):
            conn.send({"id": rid, "error":
                       "threshold must be in [0, 1]"})
            return
        if self.limit > 0 and (lim <= 0 or lim > self.limit):
            conn.send({"id": rid, "error":
                       f"num_results must be in 1..{self.limit} "
                       "(server runs in top-k mode)"})
            return
        if lim < 0:
            conn.send({"id": rid, "error": "num_results must be >= 0"})
            return
        stall = self._stall_seconds()
        if stall > 0:
            self._count("stalled_rejects")
            conn.send({"id": rid, "error":
                       f"server stalled: scoring pipeline blocked for "
                       f"{stall:.0f}s (device stall or index reload); "
                       "retry later"})
            return
        self._rq.put((conn, rid, query, thr, lim, time.monotonic()))

    # ----------------------------------------------------------- scorer

    def _next_batch(self, block):
        """Assemble one batch: the first item per `block`, then linger.

        Returns (items, stopping, reload): items may be empty when not
        blocking on an idle queue; stopping=True once _STOP is seen; a
        _Reload ends the batch (it applies once this batch and the
        window have drained).
        """
        items = []
        try:
            first = self._rq.get(block=block)
        except queue.Empty:
            return items, False, None
        if first is _STOP:
            return items, True, None
        if isinstance(first, _Reload):
            return items, False, first
        items.append(first)
        deadline = time.monotonic() + self._linger_eff()
        while len(items) < self.batch_size:
            wait = deadline - time.monotonic()
            try:
                nxt = self._rq.get(block=wait > 0,
                                   timeout=wait if wait > 0 else None)
            except queue.Empty:
                break
            if nxt is _STOP:
                return items, True, None
            if isinstance(nxt, _Reload):
                return items, False, nxt
            items.append(nxt)
        return items, False, None

    def _scorer(self):
        """The serving loop: batch -> hash -> dispatch ahead -> rank.

        All device work happens on this thread, with a bounded window of
        dispatched batches as in `Search.search_stream`; an idle request
        queue drains the window at once instead of waiting for the next
        batch, so sparse traffic sees the device's latency, not the
        window's depth.
        """
        self._use_device()
        inflight = collections.deque()
        stopping = False
        reload_req = None
        while True:
            items = []
            if not stopping and reload_req is None:
                block = not inflight
                if block:
                    self._busy_since = None  # idle: nothing in flight
                items, stopping, reload_req = \
                    self._next_batch(block=block)
            # every pass through here is progress; a scorer blocked in
            # device work below lets the stamp go stale, which intake
            # reads as a stall (_stall_seconds)
            self._busy_since = time.monotonic()
            if not items:
                if inflight:
                    self._emit_safe(inflight.popleft())
                    continue
                if reload_req is not None:
                    # the window is empty: no pending batch holds the old
                    # index set
                    self._do_reload(reload_req)
                    reload_req = None
                    continue
                if stopping:
                    return
                continue
            # a deep queue: up to the ceiling of further FULL batches
            # that need no linger go out with this one as one group
            groups = [items]
            while (not stopping and reload_req is None
                   and len(groups) < self._mega_ceiling()
                   and len(groups[-1]) == self.batch_size
                   and self._rq.qsize() >= self.batch_size):
                more, stopping, reload_req = \
                    self._next_batch(block=False)
                if more:
                    groups.append(more)
                else:
                    break
            try:
                s = self.search
                hashed_group, metas = [], []
                for g_items in groups:
                    qbytes = [it[2].encode() for it in g_items]
                    t = Timer()
                    hashed, errors = s._hash_batch_lenient(qbytes, t)
                    s.timer_.merge(t)
                    hashed_group.append(hashed)
                    metas.append((g_items, qbytes, errors))
                self._count("batches", len(groups))
                self._count("queries",
                            sum(len(g) for g in groups))
                if len(groups) > 1:
                    self._count("mega_dispatches")
                pendings = s._dispatch_group_async(hashed_group,
                                                   self.limit)
                for (g_items, qbytes, errors), pd in zip(metas,
                                                         pendings):
                    # sub-floor requests lower their batch's rank
                    # threshold (the slow path: a longer ranked list)
                    t_rank = min([self.t_floor]
                                 + [it[3] for it in g_items])
                    if t_rank < self.t_floor:
                        self._count("subfloor_batches")
                    inflight.append((g_items, qbytes, errors, pd,
                                     t_rank))
                del hashed_group, metas, pendings, s
            except Exception as e:  # a resident server lives on
                for g_items in groups:
                    self._fail_batch(g_items, e)
                continue
            # two whole groups stay dispatched ahead, so the device does
            # not idle through this thread's fetch, rank and dispatch;
            # sparse traffic still drains at once by the idle branch
            while len(inflight) > max(self.depth, 2 * len(groups)):
                self._emit_safe(inflight.popleft())
            self._slo_adjust()

    def _do_reload(self, req: _Reload):
        """Build the index set again and swap it in (scorer thread, empty
        window). Serving pauses for the load (queued requests wait, none
        drop); the old set stays bound, and on the card, until the new
        one is built, so a failed build leaves it serving."""
        try:
            self._bind_search(self._factory(req.paths))
            self._use_device()
        except Exception as e:
            self._count("failed_reloads")
            req.conn.send({"id": req.rid,
                           "error": f"reload failed: {e}"})
            return
        self._count("reloads")
        req.conn.send({"id": req.rid, "ok": True,
                       "documents": self._total_docs,
                       "indices": len(self.search.index_files)})

    def _fail_batch(self, items, exc):
        """Answer a batch whose scoring raised; the server lives on."""
        self._count("batch_failures")
        for conn, rid, *_ in items:
            conn.send({"id": rid, "error": f"internal error: {exc!r}"})

    def _emit_safe(self, entry):
        try:
            self._emit(*entry)
        except Exception as e:
            self._fail_batch(entry[0], e)

    def _emit(self, items, qbytes, errors, pending, t_rank):
        """Fetch and rank one batch at its rank threshold (the floor, or
        lower for a batch with sub-floor requests), refine per request."""
        # a mixed-term-size federation in top-k mode ranks with the FULL
        # per-index candidate budget (n_indices * k): capping the merged
        # list at k before the per-index refinement would drop entries
        # of one index that pass their own floor (the embedded Search
        # filters per index first); _emit_ranked caps at k afterwards
        rank_limit = self.limit
        if self.limit > 0 and self._uniform_ts is None:
            rank_limit = self.limit * len(self.search.index_files)
        self._emit_ranked(items, qbytes, self.search._finish_batch(
            qbytes, errors, pending, t_rank, rank_limit), t_rank)

    def _emit_ranked(self, items, qbytes, ranked, t_rank):
        """Refine and send per item. A failure here answers only its own
        item: retrying the batch would answer items twice and desync the
        one-response-per-request protocol of every pipelined client."""
        now = time.monotonic()
        with self._lock:
            self._lat.extend((now - it[5]) * 1e3 for it in items)
            self._lat_count += len(items)
        for (conn, rid, _q, thr, lim, _t0), qb, res in zip(
                items, qbytes, ranked):
            try:
                if isinstance(res, QueryError):
                    self._count("query_errors")
                    conn.send({"id": rid, "error": res.message})
                    continue
                if thr > t_rank:
                    if self._uniform_ts is not None:
                        # terms from the scored BYTES (len(str) differs
                        # for non-ASCII text)
                        num_terms = len(qb) - self._uniform_ts + 1
                        res = res.cut(
                            min_score=math.ceil(thr * num_terms))
                    else:
                        # mixed term sizes: one fraction is a score floor
                        # per index (Search._finish_batch's per-index
                        # thresholds)
                        res = res.cut_per_index(
                            self._doc_bounds,
                            [math.ceil(thr * max(len(qb) - ts + 1, 0))
                             for ts in self._term_sizes])
                if lim > 0:
                    res = res.cut(limit=lim)
                conn.send(_LazyResult(rid, res, self._fmt))
            except Exception as e:
                self._count("batch_failures")
                conn.send({"id": rid,
                           "error": f"internal error: {e!r}"})
