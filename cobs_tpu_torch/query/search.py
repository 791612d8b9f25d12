"""Search API: thresholding, ranking, multi-index federation.

The port of `cobs_tpu/query/search.py` for indexes held on a torch
device. Mirrors the observable semantics of the reference `ClassicSearch`
(reference: cobs/query/classic_search.cpp:109-202, 403-505):

- per index threshold = ceil(threshold * (|q| - term_size_i + 1));
- results sorted by (score desc, doc index asc), multi-index ties by
  (index id, doc id) ascending;
- num_results == 0 means all documents;
- auto-detects classic vs compact files from the header.

`search_batch` scores many queries in one kernel launch per index.
"""

import dataclasses
import math
import os

import numpy as np

from cobs_tpu_torch.fmt.magic import FileIOError
from cobs_tpu_torch.query.engine import (
    DeviceIndex,
    create_hashes,
    resolve_device,
    score_batch,
    score_topk,
)
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.timer import Timer


def _open_index(path, device) -> DeviceIndex:
    """Load an index file onto `device`. Files above
    settings.max_device_index_bytes are refused: cobs_tpu streams them
    from host mmap (StreamedIndex), a backend not ported yet."""
    try:
        size = os.path.getsize(path)
    except OSError:
        raise FileIOError(f'Could not open index path "{path}"') from None
    if size > settings.max_device_index_bytes:
        raise NotImplementedError(
            f'index "{path}" is {size} bytes, above '
            f"settings.max_device_index_bytes="
            f"{settings.max_device_index_bytes}; the streamed (host-mmap) "
            "backend for such indexes is not ported to cobs_tpu_torch yet")
    return DeviceIndex.from_file(path, device)


class QueryError(Exception):
    """Per-query failure marker (the reference dies process-wide on an
    invalid query, reference: cobs/query/classic_search.cpp:66-107).
    Truthiness is False so `if results:` skips it like an empty hit
    list."""

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


class Search:
    """Query one or more device-resident indices.

    Accepts an index path (auto-detect classic/compact), a DeviceIndex, or
    a list of either (multi-index federation, reference:
    cobs/query/classic_search.cpp:413-435).
    """

    def __init__(self, indices, device=None):
        """device: where index paths are loaded (None = settings.device).
        Raises when it names CUDA and CUDA is absent. DeviceIndex inputs
        are used on the device they lie on."""
        if not isinstance(indices, (list, tuple)):
            indices = [indices]
        paths = [ix for ix in indices if not isinstance(ix, DeviceIndex)]
        dev = resolve_device(device) if device is not None or paths \
            else None
        self.index_files = [
            ix if isinstance(ix, DeviceIndex) else _open_index(ix, dev)
            for ix in indices]
        self.timer_ = Timer()

    def timer(self) -> Timer:
        return self.timer_

    def search(self, query, threshold: float = 0.0,
               num_results: int = 0) -> list[SearchResult]:
        return self.search_batch([query], threshold, num_results)[0]

    def _hash_batch(self, qbytes) -> list:
        """Host stage: per-index hash tensors for a query batch."""
        max_term_size = max(ix.term_size for ix in self.index_files)
        for q in qbytes:
            if len(q) < max_term_size:
                raise ValueError(
                    f"query too short, needs to be at least "
                    f"{max_term_size} characters long")
        self.timer_.active("hashes")
        hashed = [create_hashes(qbytes, ix.term_size, ix.num_hashes,
                                ix.canonicalize)
                  for ix in self.index_files]
        self.timer_.stop()
        return hashed

    def search_batch(self, queries, threshold: float = 0.0,
                     num_results: int = 0) -> list[list[SearchResult]]:
        """Score a batch of queries in one kernel launch per index."""
        if not self.index_files or not queries:
            return [[] for _ in queries]
        qbytes = [q.encode() if isinstance(q, str) else bytes(q)
                  for q in queries]
        return self._score_ranked(qbytes, self._hash_batch(qbytes),
                                  threshold, num_results)

    def _score_ranked(self, qbytes, hashed, threshold,
                      num_results) -> list[list[SearchResult]]:
        """Device stage + ranking for a pre-hashed batch."""
        B = len(qbytes)
        if num_results > 0:
            # top-k path: only [B, k] (score, doc) pairs leave the device
            per_index = [score_topk(ix, hashed[k], num_results, self.timer_)
                         for k, ix in enumerate(self.index_files)]
            self.timer_.active("sort results")
            if len(self.index_files) == 1:
                v, d = per_index[0]
                out = self._rank_sparse_batch(
                    v, d, self._sparse_lims(qbytes, threshold), num_results)
            else:
                out = self._rank_sparse_multi(
                    per_index, self._sparse_lims_multi(qbytes, threshold),
                    num_results)
            self.timer_.stop()
            return out
        per_index_scores = []
        thresholds = []
        for k, ix in enumerate(self.index_files):
            per_index_scores.append(score_batch(ix, hashed[k], self.timer_))
            thresholds.append([
                math.ceil(threshold * (len(q) - ix.term_size + 1))
                for q in qbytes])

        self.timer_.active("sort results")
        total_docs = sum(len(ix.file_names) for ix in self.index_files)
        out = [self._rank([s[b] for s in per_index_scores],
                          [t[b] for t in thresholds], total_docs)
               for b in range(B)]
        self.timer_.stop()
        return out

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
