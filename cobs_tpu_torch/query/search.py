"""Search API: thresholding, ranking, multi-index federation.

The port of `cobs_tpu/query/search.py` for indexes held on a torch
device. Mirrors the observable semantics of the reference `ClassicSearch`
(reference: cobs/query/classic_search.cpp:109-202, 403-505):

- per index threshold = ceil(threshold * (|q| - term_size_i + 1));
- results sorted by (score desc, doc index asc), multi-index ties by
  (index id, doc id) ascending;
- num_results == 0 means all documents;
- auto-detects classic vs compact files from the header.

`search_batch` scores many queries in one kernel launch per index;
`search_stream` is the serving loop over an iterable of queries, which
packs groups of batches into one launch of each kernel on device-held
indexes (multi-batch dispatch; `query/server.py` serves the same way).
Query hashing runs on the index's device by default
(settings.device_hash).
Index files above settings.max_device_index_bytes are served by the
streamed backend (`StreamedIndex`), which a federation may mix with
device-held indexes. With a mesh (`Search(..., mesh=...)`) every index is
document-sharded over the mesh's devices (`parallel/sharded.py`) and
scored cell by cell.
"""

import collections
import concurrent.futures
import dataclasses
import itertools
import math

import numpy as np
import torch

from cobs_tpu_torch.fmt.magic import FileIOError
from cobs_tpu_torch.ops.device_hash import (
    invalid_query_mask,
    validate_queries,
)
from cobs_tpu_torch.parallel.sharded import ShardedIndex
from cobs_tpu_torch.query.engine import (
    DeviceIndex,
    QueryBytes,
    StreamedIndex,
    create_hashes,
    device_index_bytes,
    int32_row_ids,
    prepack_query_bytes,
    resolve_device,
    score_batch_async,
    score_batch_multi_async,
    score_topk_async,
    score_topk_multi_async,
)
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.timer import Timer


#: search_stream's fixed depths; cobs_tpu tunes both (settings.hash_ahead,
#: dispatch_groups) for a remote chip behind a slow link.
#: Batches a worker thread hashes ahead of the dispatching thread, by where
#: hashing runs. With host hashing the worker overlaps tens of ms of numpy
#: hashing per batch with the device and the ranking. With device hashing
#: the host stage is ~0.1 ms of padding and checks, and handing it to a
#: thread cost ~0.7 ms per 64-query batch of GIL and wake-up waits on the
#: H100 machine (experiments/stream_overlap.py), so it runs inline (0).
_HASH_AHEAD = {"host": 2, "device": 0}
#: batches (groups of batches under multi-batch dispatch) kept dispatched
#: on the device while the oldest is fetched and ranked
_DEPTH = 2
#: device bytes one full-ranking multi-batch group may hold in scores
#: until it is fetched ([K * B, slots] int32; search_stream keeps _DEPTH
#: groups and the next one in flight)
_MEGA_FULLRANK_BYTES = 256 << 20


def _open_index(path, device, streamed=None):
    """Open an index file for `device`. streamed=True serves it from a
    host mmap (StreamedIndex), False loads it onto the device
    (DeviceIndex, the reference's --load-complete), None picks: the
    device unless the bytes it would hold there (rows padded to whole
    word tiles, `device_index_bytes`) exceed
    settings.max_device_index_bytes (settings.load_complete_index
    forces the device)."""
    if streamed is None:
        if settings.load_complete_index:
            streamed = False
        else:
            try:
                size = device_index_bytes(path)
            except OSError:
                raise FileIOError(
                    f'Could not open index path "{path}"') from None
            streamed = size > settings.max_device_index_bytes
    return (StreamedIndex(path, device) if streamed
            else DeviceIndex.from_file(path, device))


def _score_async(ix, payload, num_results: int, timer):
    """Enqueue one batch on one index (top-k when num_results > 0); `ix`
    may be a ShardedIndex."""
    if isinstance(ix, ShardedIndex):
        if timer:
            timer.active("io")
        pending = (ix.score_topk_async(payload, num_results)
                   if num_results > 0 else ix.score_batch_async(payload))
        if timer:
            timer.stop()
        return pending
    if isinstance(ix, StreamedIndex):
        return (ix.score_topk_async(payload, num_results, timer)
                if num_results > 0 else ix.score_batch_async(payload, timer))
    return (score_topk_async(ix, payload, num_results, timer)
            if num_results > 0 else score_batch_async(ix, payload, timer))


class QueryError(Exception):
    """Per-query failure marker yielded by `search_stream`: the reference
    dies process-wide on an invalid query (reference:
    cobs/query/classic_search.cpp:66-107); a serving loop yields this in
    the query's slot and ranks the rest of its batch. Truthiness is False
    so `if results:` skips it like an empty hit list."""

    def __init__(self, query, message: str):
        super().__init__(message)
        self.query = query
        self.message = message

    def __bool__(self):
        return False

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())

    def __repr__(self):
        return f"QueryError({self.message!r})"


@dataclasses.dataclass
class SearchResult:
    doc_name: str
    score: int

    def __iter__(self):
        return iter((self.doc_name, self.score))

    def __repr__(self):
        return f"SearchResult({self.doc_name!r}, {self.score})"


class ResultList:
    """Lazy ranked-result sequence (list[SearchResult] semantics): keeps
    the sorted (doc, score) arrays and builds SearchResult objects only
    on access, since a full ranking of a large index returns every
    document per query."""

    __slots__ = ("_names", "_gidx", "_scores")

    def __init__(self, names, gidx, scores):
        self._names = names
        self._gidx = gidx
        self._scores = scores

    def __len__(self):
        return len(self._gidx)

    def __bool__(self):
        return len(self._gidx) > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            rng = range(*i.indices(len(self._gidx)))
            return [self[j] for j in rng]
        return SearchResult(self._names[self._gidx[i]],
                            int(self._scores[i]))

    def __iter__(self):
        names = self._names
        for g, s in zip(self._gidx.tolist(), self._scores.tolist()):
            yield SearchResult(names[g], s)

    def __eq__(self, other):
        if isinstance(other, (ResultList, list, tuple)):
            return (len(self) == len(other)
                    and all(a == b for a, b in zip(self, other)))
        return NotImplemented

    def __repr__(self):
        return repr(list(self))

    def pairs(self) -> list:
        """[[doc_name, score], ...] (the serving JSON shape) without a
        SearchResult per document."""
        names = self._names
        return [[names[g], s] for g, s in
                zip(self._gidx.tolist(), self._scores.tolist())]

    def cut(self, min_score=None, limit=None) -> "ResultList":
        """Prefix-refine an already-ranked list: scores descend in the
        reference's tie order, so a higher score floor and a smaller cap
        are both prefix cuts (the server ranks a batch once at its floor
        and refines per request)."""
        n = len(self._gidx)
        if min_score is not None and n:
            n = int(np.searchsorted(-self._scores.astype(np.int64),
                                    -int(min_score), side="right"))
        if limit is not None:
            n = min(n, int(limit))
        return ResultList(self._names, self._gidx[:n], self._scores[:n])

    def serialize_with(self, formatter) -> bytes:
        """The JSON fragment [["name",score],...] from a native
        `ResultFormatter` of the same names."""
        return formatter(self._gidx, self._scores)

    def cut_per_index(self, doc_bounds, min_scores) -> "ResultList":
        """Refine with a score floor per source index: a federation of
        mixed term sizes turns one fractional threshold into a different
        minimum score per index (the per-index ceil(t * num_terms) of
        `Search._finish_batch`). `doc_bounds` is the cumulative document
        count per index; the filter keeps the order, so the reference's
        tie order survives."""
        if not len(self._gidx):
            return self
        idx_of = np.searchsorted(doc_bounds, self._gidx, side="right")
        keep = self._scores >= np.asarray(min_scores, dtype=np.int64)[idx_of]
        return ResultList(self._names, self._gidx[keep], self._scores[keep])


class Search:
    """Query one or more indices, device-held or streamed.

    Accepts an index path (auto-detect classic/compact), a DeviceIndex, a
    StreamedIndex, or a list of them (multi-index federation, reference:
    cobs/query/classic_search.cpp:413-435).
    """

    def __init__(self, indices, device=None, streamed=None, mesh=None):
        """device: where index paths are loaded or scored (None =
        settings.device). Raises when it names CUDA and CUDA is absent.
        Index objects are used on the device they were made for.
        streamed: True = serve index paths from host mmap
        (StreamedIndex), False = load them onto the device, None = by
        file size (`_open_index`).

        mesh: a parallel.sharded.Mesh; every index is then document-
        sharded over its devices (`ShardedIndex`) and `device` is unused.
        Index paths are read on the host first: streamed=True maps them
        (each shard's word columns are read from the mmap and uploaded to
        its own device, so the whole matrix never exists in one buffer),
        otherwise they load into host memory."""
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        opened = (DeviceIndex, StreamedIndex)
        paths = [ix for ix in indices if not isinstance(ix, opened)]
        if mesh is not None:
            dev = torch.device("cpu")
        else:
            dev = resolve_device(device) if device is not None or paths \
                else None
        self.index_files = [
            ix if isinstance(ix, opened) else _open_index(ix, dev, streamed)
            for ix in indices]
        self.mesh = mesh
        #: per index: its ShardedIndex on the mesh, or the index itself
        self._scorers = ([ShardedIndex(ix, mesh) for ix in self.index_files]
                         if mesh is not None else list(self.index_files))
        self.timer_ = Timer()

    def timer(self) -> Timer:
        return self.timer_

    def search(self, query, threshold: float = 0.0,
               num_results: int = 0) -> list[SearchResult]:
        return self.search_batch([query], threshold, num_results)[0]

    @staticmethod
    def _use_device_hash(ix, sharded: bool = False) -> bool:
        """Whether queries for index `ix` are hashed on its device:
        settings.device_hash "auto" or "device", row ids that fit the
        hash kernel's int32, and, for a StreamedIndex, device scoring
        (host scoring needs host row ids) unless it is `sharded` over a
        mesh, whose devices hold it. Decided per index, so a federation
        may hash some indexes on the host."""
        if str(settings.device_hash).lower() not in (
                "auto", "device", "1", "true"):
            return False
        if not int32_row_ids(ix):
            return False
        return sharded or not (isinstance(ix, StreamedIndex)
                               and ix.scores_on_host())

    def _device_hashed(self, ix, qbytes=None) -> bool:
        """`_use_device_hash` for this Search's batch `qbytes`: on a mesh
        of more than one "batch" row, a batch that runs the sequence
        split (a query of at least settings.seq_split_terms terms)
        hashes on the host, as in cobs_tpu."""
        if not self._use_device_hash(ix, self.mesh is not None):
            return False
        if self.mesh is not None and self.mesh.shape["batch"] > 1 \
                and qbytes:
            t_max = max(len(q) for q in qbytes) - ix.term_size + 1
            return t_max < settings.seq_split_terms
        return True

    def _hash_batch(self, qbytes) -> list:
        """Host stage: per index, a QueryBytes payload (validated and
        padded; hashed later on the device) or per-query host hashes."""
        max_term_size = max(ix.term_size for ix in self.index_files)
        for q in qbytes:
            if len(q) < max_term_size:
                raise ValueError(
                    f"query too short, needs to be at least "
                    f"{max_term_size} characters long")
        self.timer_.active("hashes")
        hashed = []
        for ix in self.index_files:
            if self._device_hashed(ix, qbytes):
                qb, bad = self._query_bytes(ix, qbytes)
                # raises the reference's error for the first bad query
                validate_queries([qbytes[b] for b in np.flatnonzero(bad)],
                                 ix.term_size, ix.canonicalize)
                hashed.append(qb)
            else:
                hashed.append(create_hashes(qbytes, ix.term_size,
                                            ix.num_hashes, ix.canonicalize))
        self.timer_.stop()
        return hashed

    @staticmethod
    def _query_bytes(ix, qbytes) -> tuple[QueryBytes, np.ndarray]:
        """The padded QueryBytes payload of a batch for index `ix`, and
        bool [B]: which queries hold a byte the index rejects (one
        vectorized check over the padded rows, whose padding is valid)."""
        qb = QueryBytes(qbytes)
        prepack_query_bytes(ix, qb)
        return qb, invalid_query_mask(qb.packed, ix.canonicalize)

    def _hash_batch_lenient(self, qbytes, timer):
        """Like _hash_batch, but an invalid query flags its own slot
        instead of aborting the batch (the reference's per-query die is
        classic_search.cpp:66-107).

        Returns (hashed, errors): errors[b] is None or the message;
        flagged slots are scored as queries without terms (device
        hashing) or with a one-term dummy (host hashing), and the caller
        discards their scores."""
        max_term_size = max(ix.term_size for ix in self.index_files)
        errors: list[str | None] = [
            f"query too short, needs to be at least {max_term_size} "
            "characters long" if len(q) < max_term_size else None
            for q in qbytes]
        timer.active("hashes")
        hashed = []
        for ix in self.index_files:
            if self._device_hashed(ix, qbytes):
                qb, bad = self._query_bytes(ix, qbytes)
                for b in np.flatnonzero(bad):
                    if errors[b] is None:
                        try:
                            validate_queries([qbytes[b]], ix.term_size,
                                             ix.canonicalize)
                        except ValueError as e:
                            errors[b] = str(e)
                for b, e in enumerate(errors):
                    if e is not None:
                        qb.lens[b] = 0   # every term at the zero row
                hashed.append(qb)
                continue
            dummy = np.zeros((1, ix.num_hashes), dtype=np.uint64)
            per_q = []
            for b, q in enumerate(qbytes):
                if errors[b] is None:
                    try:
                        per_q.append(create_hashes(
                            [q], ix.term_size, ix.num_hashes,
                            ix.canonicalize)[0])
                        continue
                    except ValueError as e:
                        errors[b] = str(e)
                per_q.append(dummy)
            hashed.append(per_q)
        timer.stop()
        return hashed, errors

    def search_batch(self, queries, threshold: float = 0.0,
                     num_results: int = 0) -> list[list[SearchResult]]:
        """Score a batch of queries in one kernel launch per index."""
        if not self.index_files or not queries:
            return [[] for _ in queries]
        qbytes = [q.encode() if isinstance(q, str) else bytes(q)
                  for q in queries]
        pending = self._dispatch_async(self._hash_batch(qbytes),
                                       num_results)
        return self._finish_batch(qbytes, [None] * len(qbytes), pending,
                                  threshold, num_results)

    def _dispatch_async(self, hashed, num_results) -> list:
        """Enqueue one pre-hashed batch on every index without waiting
        for the device (a streamed index in host mode scores on its own
        worker thread); one pending handle per index."""
        return [_score_async(ix, hashed[k], num_results, self.timer_)
                for k, ix in enumerate(self._scorers)]

    def _mega_k(self) -> int:
        """Batches per multi-batch dispatch when the queue is deep
        (settings.mega_batches; 1 = one dispatch per batch). Only when
        every index is a DeviceIndex, or on a mesh (where every index is
        held on the devices): a streamed batch's cost is its host gather,
        which packing does not divide."""
        if self.mesh is None and not all(isinstance(ix, DeviceIndex)
                                         for ix in self.index_files):
            return 1
        return max(1, int(settings.mega_batches))

    def _mega_k_capped(self, batch_size: int, num_results: int) -> int:
        """_mega_k with the full-ranking device budget: a full-ranking
        group holds [K * B, slots] scores per index until it is fetched,
        so the cap divides _MEGA_FULLRANK_BYTES by the sum of the
        indexes' slot widths. The scores are int32, 4 bytes a slot
        (cobs_tpu shrinks them to u16 for its slow link; the port does
        not). Top-k groups hold only [K * B, k] and are never capped.
        The one formula serves search_stream and QueryServer."""
        mega = self._mega_k()
        if mega > 1 and num_results == 0:
            slots = sum(ix.word_width * 32 * ix.num_pages
                        for ix in self.index_files)
            mega = max(1, min(mega, _MEGA_FULLRANK_BYTES
                              // max(1, slots * 4 * batch_size)))
        return mega

    def _dispatch_group_async(self, hashed_group, num_results) -> list:
        """Multi-batch dispatch: K pre-hashed batches with one upload and
        one launch of each kernel per index (engine.score_*_multi_async).
        cobs_tpu splits a group into power-of-two runs to bound its
        compiled shapes; the kernels here take the batch size at run
        time, so a group goes whole. A group of one is `_dispatch_async`
        (a streamed index only meets those: `_mega_k`). Returns one
        pending list per batch, the contract of `_dispatch_async`, so
        `_finish_batch` takes each unchanged."""
        if len(hashed_group) == 1:
            return [self._dispatch_async(hashed_group[0], num_results)]
        per_index = []
        for kx, ix in enumerate(self._scorers):
            payloads = [hashed[kx] for hashed in hashed_group]
            if isinstance(ix, ShardedIndex):
                self.timer_.active("io")
                per_index.append(
                    ix.score_topk_multi_async(payloads, num_results)
                    if num_results > 0
                    else ix.score_batch_multi_async(payloads))
                self.timer_.stop()
                continue
            per_index.append(
                score_topk_multi_async(ix, payloads, num_results,
                                       self.timer_) if num_results > 0
                else score_batch_multi_async(ix, payloads, self.timer_))
        return [[pi[g] for pi in per_index]
                for g in range(len(hashed_group))]

    def _finish_batch(self, qbytes, errors, pending, threshold,
                      num_results) -> list:
        """Fetch and rank one dispatched batch (pairs `_dispatch_async`).

        Returns one ResultList (or QueryError) per query, in the
        reference's (score desc, doc asc) order."""
        self.timer_.active("add rows")
        fetched = [p.fetch() for p in pending]
        self.timer_.active("sort results")
        ranked = None
        if num_results > 0:
            if len(self.index_files) == 1:
                v, d = fetched[0]
                ranked = self._rank_sparse_batch(
                    v, d, self._sparse_lims(qbytes, threshold), num_results)
            else:
                ranked = self._rank_sparse_multi(
                    fetched, self._sparse_lims_multi(qbytes, threshold),
                    num_results)
        total_docs = len(self._names)
        out = []
        for b in range(len(qbytes)):
            if errors[b] is not None:
                out.append(QueryError(qbytes[b], errors[b]))
            elif ranked is not None:
                out.append(ranked[b])
            else:
                thr = [math.ceil(threshold *
                                 (len(qbytes[b]) - ix.term_size + 1))
                       for ix in self.index_files]
                out.append(self._rank([s[b] for s in fetched], thr,
                                      total_docs))
        self.timer_.stop()
        return out

    def search_stream(self, queries, threshold: float = 0.0,
                      num_results: int = 0, batch_size: int = 64):
        """Stream ranked results for an iterable of queries: the serving
        loop.

        Queries are cut into batches of `batch_size`, in order. The host
        stage (validation and padding, or numpy hashing) runs on one
        worker thread ahead of the calling thread when any index hashes
        on the host, and inline when all hash on the device
        (_HASH_AHEAD); the worker makes no CUDA call. The calling thread uploads,
        launches, fetches and ranks, and keeps a bounded window of
        dispatched batches on the device, so batch k's fetch and ranking
        overlap batch k+1's kernels. When every index is a DeviceIndex,
        groups of up to `settings.mega_batches` consecutive batches
        (`_mega_k_capped`) go to the device with one upload and one launch
        of each kernel (`_dispatch_group_async`), and the window holds
        whole groups. Full ranking and top-k (num_results > 0), one index
        or a federation.

        Yields one ranked list per query, in order. An invalid query (too
        short, non-ACGT) yields a `QueryError` in its slot instead of
        aborting the stream.
        """
        it = iter(queries)
        ahead = _HASH_AHEAD["device" if all(
            self._device_hashed(ix) for ix in self.index_files)
            else "host"]

        def hash_next():
            batch = list(itertools.islice(it, batch_size))
            if not batch:
                return None
            qbytes = [q.encode() if isinstance(q, str) else bytes(q)
                      for q in batch]
            # a private timer: a worker must not race the calling
            # thread's phases on the shared one
            t = Timer()
            hashed, errors = self._hash_batch_lenient(qbytes, t)
            return qbytes, hashed, errors, t

        def hashed_batches():
            if not ahead:
                while (got := hash_next()) is not None:
                    yield got
                return
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                # one worker runs hash_next calls in FIFO order, so
                # batches keep the queries' order
                hash_q = collections.deque(pool.submit(hash_next)
                                           for _ in range(ahead))
                while (got := hash_q.popleft().result()) is not None:
                    hash_q.append(pool.submit(hash_next))
                    yield got

        mega = self._mega_k_capped(batch_size, num_results)
        inflight = collections.deque()
        ready = []   # hashed batches waiting for their group's dispatch

        def flush():
            pendings = self._dispatch_group_async([h for _, h, _ in ready],
                                                  num_results)
            for (qbytes, _, errors), pending in zip(ready, pendings):
                inflight.append((qbytes, errors, pending))
            ready.clear()

        for qbytes, hashed, errors, t in hashed_batches():
            self.timer_.merge(t)
            ready.append((qbytes, hashed, errors))
            if len(ready) >= mega:
                flush()
            while len(inflight) > _DEPTH * mega:
                yield from self._finish_batch(*inflight.popleft(),
                                              threshold, num_results)
        if ready:
            flush()
        while inflight:
            yield from self._finish_batch(*inflight.popleft(), threshold,
                                          num_results)

    def _rank_sparse_multi(self, fetched, lims, num_results
                           ) -> list[ResultList]:
        """Vectorized federation top-k ranking.

        fetched: per-index (scores [B, k_i], docs [B, k_i]) device top-k
        pairs (padding slots carry score -1). lims: int64 [n_indices, B]
        per-index per-query score floors (>= 0). One composed-key argsort
        ranks the whole batch: (score << 40) - global_doc is unique per
        row and orders exactly by (score desc, doc asc); every excluded
        entry (score forced to -1) sorts after every kept one, so the
        per-query prefix cut is exact. Reference ordering contract:
        cobs/query/classic_search.cpp:140-144, 166-201."""
        B = lims.shape[1]
        Vs, Gs = [], []
        base = 0
        for k, ix in enumerate(self.index_files):
            v, d = fetched[k]
            v = np.asarray(v).astype(np.int64)
            d = np.asarray(d).astype(np.int64)
            keep = v >= lims[k][:, None]   # lims >= 0 excludes padding
            Vs.append(np.where(keep, v, -1))
            Gs.append(d + base)
            base += len(ix.file_names)
        V = np.concatenate(Vs, axis=1)
        G = np.concatenate(Gs, axis=1)
        n = (V >= 0).sum(axis=1)
        if num_results:
            n = np.minimum(n, num_results)
        names = self._names
        if V.size and (int(V.max()) >= 1 << 23 or base >= 1 << 40):
            # the composed key would overflow (8M+-term queries or 1T+
            # docs): exact 2-key sort for that regime
            out = []
            for b in range(B):
                order = np.lexsort((G[b], -V[b]))[:n[b]]
                out.append(ResultList(names, G[b][order], V[b][order]))
            return out
        order = np.argsort(G - (V << 40), axis=1)
        V = np.take_along_axis(V, order, axis=1)
        G = np.take_along_axis(G, order, axis=1)
        return [ResultList(names, G[b, :n[b]], V[b, :n[b]])
                for b in range(B)]

    def _sparse_lims_multi(self, qbytes, threshold) -> np.ndarray:
        """Per-index per-query score floors, int64 [n_indices, B]."""
        return np.array(
            [[max(0, math.ceil(threshold *
                               (len(qb) - ix.term_size + 1)))
              for qb in qbytes] for ix in self.index_files],
            dtype=np.int64)

    def _rank_sparse_batch(self, v, d, lims, num_results):
        """Vectorized single-index top-k ranking.

        score_topk rows are already in the reference result order (score
        descending, ties by lower slot, and slot numbering is monotone in
        document number), so per-query ranking is a PREFIX LENGTH: the
        entries >= the query's score floor (the -1 padding sorts last and
        is excluded by lims >= 0).
        """
        n = (v >= lims[:, None]).sum(axis=1)
        if num_results:
            n = np.minimum(n, num_results)
        names = self._names
        return [ResultList(names, d[b, :n[b]],
                           v[b, :n[b]].astype(np.int64))
                for b in range(v.shape[0])]

    def _sparse_lims(self, qbytes, threshold) -> np.ndarray:
        ts = self.index_files[0].term_size
        return np.fromiter(
            (max(0, math.ceil(threshold * (len(qb) - ts + 1)))
             for qb in qbytes), np.int64, len(qbytes))

    @property
    def _names(self) -> list[str]:
        names = getattr(self, "_names_cache", None)
        if names is None:
            names = []
            for ix in self.index_files:
                names.extend(ix.file_names)
            self._names_cache = names
        return names

    def _rank(self, scores_list, thresholds, num_results) -> ResultList:
        """Threshold + exact reference tie ordering."""
        kept_scores: list[np.ndarray] = []
        kept_global: list[np.ndarray] = []
        order_base = 0
        for k, ix in enumerate(self.index_files):
            n = len(ix.file_names)
            s = scores_list[k][:n]
            idx = np.nonzero(s >= thresholds[k])[0]
            kept_scores.append(s[idx])
            # global tie key: (index id, doc id) ascending
            kept_global.append(idx + order_base)
            order_base += n
        scores = np.concatenate(kept_scores)
        gidx = np.concatenate(kept_global)
        # gidx ascends by construction, so a STABLE sort on the score
        # alone breaks ties by (index id, doc id): the reference order
        order = np.argsort(-scores.astype(np.int64),
                           kind="stable")[:num_results]
        return ResultList(self._names, gidx[order],
                          scores[order].astype(np.int64))
