"""Client of the query server (query/server.py), the port of
`cobs_tpu/query/client.py`.

Speaks the newline-delimited JSON protocol over a Unix domain socket
or TCP and returns the same `SearchResult` lists the in-process
`Search.search` API returns, so code can switch between embedded and
served search without changes:

    with QueryClient("/run/cobs.sock") as c:
        hits = c.search("ACGT...", threshold=0.9, num_results=10)

`search_batch` pipelines many requests over the connection — on the
server side consecutive requests coalesce into one device batch, so a
pipelined client sees near-`search_batch` throughput through the
socket. Thread-safe in the serialized sense: a lock makes each call
atomic on the shared connection; for concurrent in-flight calls use
one client per thread (connections are cheap, and the server batches
across them). The client is pure Python and touches no device.
"""

import itertools
import json
import socket
import threading

from cobs_tpu_torch.query.search import QueryError, SearchResult


class ServerError(RuntimeError):
    """The server rejected a request (protocol/parameter error)."""


class QueryClient:
    """Connect to a `QueryServer` at a Unix-socket path or (host, port)."""

    def __init__(self, address, timeout=300.0):
        if isinstance(address, str):
            self._sock = socket.socket(socket.AF_UNIX,
                                       socket.SOCK_STREAM)
        else:
            self._sock = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
            address = tuple(address)
        self._sock.settimeout(timeout)
        self._sock.connect(address)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.RLock()  # one request/response cycle
        # at a time: responses come back on the one shared socket
        self._ids = itertools.count()

    # ------------------------------------------------------------ core

    def _send(self, obj) -> None:
        self._sock.sendall((json.dumps(obj) + "\n").encode())

    def _recv(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    @staticmethod
    def _to_results(resp, query, strict):
        if "error" in resp:
            if strict:
                raise ServerError(resp["error"])
            return QueryError(query, resp["error"])
        return [SearchResult(name, score)
                for name, score in resp["results"]]

    # ------------------------------------------------------------- api

    def search(self, query: str, threshold: float | None = None,
               num_results: int | None = None) -> list[SearchResult]:
        """One query; raises ServerError if the server rejects it.

        threshold/num_results omitted = the server's configured
        defaults. Raising the threshold / lowering the cap is a fast
        prefix cut on the server's floor-ranked batch; a threshold
        below the floor re-ranks the batch (slower, still exact).
        """
        return self.search_batch([query], threshold, num_results,
                                 strict=True)[0]

    def search_batch(self, queries, threshold=None, num_results=None,
                     strict: bool = False) -> list:
        """Pipeline many queries; results return in query order.

        strict=False mirrors `Search.search_stream`: a rejected query
        yields a `QueryError` in its slot instead of raising.
        """
        queries = list(queries)  # may be a generator; read it once
        req = {}
        if threshold is not None:
            req["threshold"] = threshold
        if num_results is not None:
            req["num_results"] = num_results
        with self._lock:
            ids = []
            lines = []
            for q in queries:
                rid = next(self._ids)
                lines.append(json.dumps({"id": rid, "query": q, **req}))
                ids.append(rid)
            if lines:
                # one write for the whole pipeline burst: per-request
                # sendall syscalls measurably bound served throughput
                # once scoring is fast (the server reads line-by-line
                # regardless, so the bytes are identical)
                self._sock.sendall(("\n".join(lines) + "\n").encode())
            by_id = {}
            for _ in ids:
                resp = self._recv()
                by_id[resp["id"]] = resp
        return [self._to_results(by_id[rid], q, strict)
                for rid, q in zip(ids, queries)]

    def ping(self) -> bool:
        with self._lock:
            rid = next(self._ids)
            self._send({"cmd": "ping", "id": rid})
            resp = self._recv()
        return resp.get("id") == rid and resp.get("ok") is True

    def reload(self, indices=None) -> dict:
        """Ask the server to build its index set again and swap it in
        without a restart (needs a server with a search_factory, as
        `cobs serve` starts it). Returns {"documents": N, "indices": K};
        raises ServerError on failure (the old index set stays live)."""
        req = {"cmd": "reload", "id": None}
        if indices is not None:
            req["indices"] = list(indices)
        with self._lock:
            req["id"] = next(self._ids)
            self._send(req)
            resp = self._recv()
        if "error" in resp:
            raise ServerError(resp["error"])
        return {"documents": resp["documents"],
                "indices": resp["indices"]}

    def stats(self) -> dict:
        with self._lock:
            self._send({"cmd": "stats", "id": next(self._ids)})
            resp = self._recv()
        resp.pop("id", None)
        return resp

    def close(self) -> None:
        try:
            # the makefile wrapper holds its own reference to the fd;
            # closing only the socket would leave the connection open
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
