"""Document-axis sharding of the bit-sliced signature index over a grid of
torch devices.

The port of `cobs_tpu/parallel/sharded.py`. The reference is single-node
(a pthread pool over score batches, reference:
cobs/util/parallel_for.hpp:24-63); cobs_tpu adds the distributed layer
along the two axes of the problem, and so does this module:

- **"docs"**: the signature matrix ``[rows, W]`` (W u32 words, 32
  documents each) is cut on the word axis. Each docs shard holds every
  row for a contiguous slice of documents, so the per-term row gather,
  the AND over the hashes and the count are all local: the gather-and-
  count kernel runs on each shard and no data crosses devices while it
  does. A document's full score lives on one shard, so each shard ranks
  its own documents for top-k and only k candidates per shard leave it.
- **"batch"**: a batch's queries are cut into one slice per "batch" row;
  cell (b, d) scores slice b against docs shard d. A query too long to
  fill the grid instead has its terms cut over the "batch" rows (the
  sequence split) and the partial counts summed.

Every cell's kernels run on the cell's device, under
`torch.cuda.device(...)`, with no wait between cells; the outputs are
copied to pinned host memory as they finish and the fetch waits once, on
one CUDA event per device. The host merges the shards' candidates
(`_merge_topk_host`, as cobs_tpu) or concatenates their counts
(`assemble_scores`). On a mesh that spans processes
(`parallel.distributed.global_mesh`) a process uploads and scores only
its own cells, and each fetch makes one exchange of the fetched host
arrays with every other process (`torch.distributed.all_gather_object`),
after which every process holds the whole answer. cobs_tpu reshards to
a replicated layout for that (`_replicator`); the exchange takes its
place.

Construction's step is the same layout: `scatter_step` sets bits in the
word-major shards with the construction scatter kernel, each shard taking
the updates that fall in its documents (`construct/device.py` builds an
index batch the same way).
"""

import concurrent.futures
import contextlib
import dataclasses

import numpy as np
import torch

from cobs_tpu_torch.ops.construct_scatter import construct_scatter
from cobs_tpu_torch.ops.device_hash import page_tables as device_hash_tables
from cobs_tpu_torch.ops.device_hash import rows_from_queries
from cobs_tpu_torch.ops.query_kernel import gather_and_count
from cobs_tpu_torch.query.engine import (
    QueryBytes,
    _concat_payloads,
    _doc_valid_mask,
    _offsets,
    _upload,
    int32_row_ids,
    prepack_query_bytes,
    resolve_device,
    topk_slots,
)
from cobs_tpu_torch.settings import settings

#: exchanges between processes made by sharded scoring (one
#: all_gather_object per fetched batch or group on a mesh that spans
#: processes, none in one process); a run resets it to count its own
EXCHANGES = 0
#: device-to-device copies made by sharded scoring: only the sequence
#: split's sum of partial counts makes them, and only between distinct
#: devices; per-shard scoring makes none
CROSS_DEVICE_COPIES = 0
#: host bytes staged per upload of a streamed shard's rows
STAGE_BYTES = 64 << 20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("batch", "docs") grid of torch devices: devices[b][d] runs cell
    (b, d). On a mesh that spans processes, ranks[b][d] is the rank that
    owns cell (b, d) and rank is this process's; ranks is None in one
    process."""

    devices: tuple
    ranks: tuple | None = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {"batch": len(self.devices), "docs": len(self.devices[0])}

    def is_local(self, b: int, d: int) -> bool:
        return self.ranks is None or self.ranks[b][d] == self.rank

    def local_cells(self) -> list[tuple[int, int]]:
        return [(b, d) for b in range(self.shape["batch"])
                for d in range(self.shape["docs"]) if self.is_local(b, d)]


def visible_devices(device=None) -> list[torch.device]:
    """The devices a mesh may take: every visible CUDA card for "cuda"
    without an index (settings.device by default), else the one device
    named. Raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_batch: int = 1, n_docs: int | None = None,
              devices=None) -> Mesh:
    """A ("batch", "docs") mesh of n_batch x n_docs cells, row by row over
    `devices` (default: every visible CUDA card). n_docs defaults to
    len(devices) // n_batch: the docs axis is the one that grows with
    the corpus. A mesh needing more devices than given raises; it never
    goes on with fewer, and never on the CPU.

    `devices` may name a device more than once: [cuda:0] * 4 is four
    shards on one card, and [cpu] * 8 what the CPU tests use. This is the
    counterpart of cobs_tpu's tests' virtual CPU devices
    (--xla_force_host_platform_device_count), which share one host the
    same way; shards that share a device share its memory and its rate."""
    if devices is None:
        devices = visible_devices("cuda")
    devices = [resolve_device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if n_docs is None:
        n_docs = len(devices) // max(1, n_batch)
    need = max(1, n_batch) * max(1, n_docs)
    if n_batch < 1 or n_docs < 1 or need > len(devices):
        raise ValueError(f"mesh needs {need} devices, only {len(devices)} "
                         "available")
    return Mesh(tuple(tuple(devices[b * n_docs:(b + 1) * n_docs])
                      for b in range(n_batch)))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _on(device: torch.device):
    """The context that makes `device` current for a launch: on several
    cards, whether a kernel sees its tensors."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """t on `device`, counted in CROSS_DEVICE_COPIES when it moves."""
    global CROSS_DEVICE_COPIES
    if t.device == device:
        return t
    CROSS_DEVICE_COPIES += 1
    return t.to(device)


class PendingSharded:
    """A dispatched sharded batch; fetch() waits for it and gives the
    engine's score_batch or score_topk contract."""

    __slots__ = ("_finish",)

    def __init__(self, finish):
        self._finish = finish

    def fetch(self):
        return self._finish()


class _SharedMeshFetch:
    """The host copies of one dispatch's cell outputs, shared by the
    pending handles of its batches: each output is copied to pinned host
    memory as soon as its kernels finish, and the first get() waits once
    (one CUDA event per device), exchanges with the other processes of
    the mesh, and combines the cells into the dispatch's whole answer;
    the others reuse it."""

    __slots__ = ("_sharded", "_host", "_events", "_combine", "_out")

    def __init__(self, sharded: "ShardedIndex", outs: dict, combine):
        self._sharded = sharded
        self._combine = combine
        self._out = None
        self._host = {}
        for key, t in outs.items():
            if t.device.type == "cuda":
                with torch.cuda.device(t.device):
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    t = h.copy_(t, non_blocking=True)
            self._host[key] = t
        self._events = []
        for dev in {t.device for t in outs.values()
                    if t.device.type == "cuda"}:
            with torch.cuda.device(dev):
                self._events.append(torch.cuda.Event())
                self._events[-1].record()

    def get(self):
        if self._out is None:
            for ev in self._events:
                ev.synchronize()
            host = {k: h.numpy() for k, h in self._host.items()}
            self._out = self._combine(self._sharded._exchange(host))
            self._host = self._events = self._combine = None
        return self._out


class ShardedIndex:
    """An index laid out over a ("batch", "docs") mesh.

    Takes a DeviceIndex (on any device; each shard's word columns are
    copied from its matrix) or a StreamedIndex (each shard's word columns
    are read from the memory-mapped payload in row chunks and uploaded to
    the shard's device, so an index larger than one card's memory becomes
    queryable as long as it fits the mesh's combined memory). The shards
    of distinct devices are made at once, one thread per device.

    The word axis is padded to `word_align` x n_docs words, so every
    docs shard gets an equal slice of word_width / n_docs words (the
    default 128 keeps the padded layout and the flat candidate numbering
    equal to cobs_tpu's); padding words read as zero and their phantom
    documents are stripped when scores are assembled. Each docs shard is
    its own contiguous int32 [R + 1, word_width / n_docs] tensor (a column
    slice of the row-major matrix would be a strided view, which the
    gather-and-count kernel's bulk copies cannot take), made once per
    (docs column, device): cells of one column on one device share it.
    Only the cells of this process are made.
    """

    def __init__(self, index, mesh: Mesh, word_align: int = 128):
        self.mesh = mesh
        self.index = index
        n_docs = mesh.shape["docs"]
        W = index.word_width
        self.word_width = _round_up(W, max(1, word_align) * n_docs)
        self.shard_width = self.word_width // n_docs
        self.rows = int(index.zero_row) + 1
        self._shards = {}
        self._tables = {}
        self._masks = {}
        by_dev = {}
        for b, d in mesh.local_cells():
            dev = mesh.devices[b][d]
            if d not in by_dev.setdefault(dev, []):
                by_dev[dev].append(d)
            if dev not in self._tables:
                self._tables[dev] = device_hash_tables(
                    index.sig_sizes, index.row_offsets, dev)
        make = (self._shard_from_matrix if hasattr(index, "matrix")
                else self._shard_from_streamed)

        def upload(dev):
            return {(d, dev): make(d, dev) for d in by_dev[dev]}

        # one thread per distinct device: the shards of several cards
        # copy and upload at once (the host copy out of a mapped file
        # runs without the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(max(1, len(by_dev))) \
                as pool:
            for made in pool.map(upload, by_dev):
                self._shards.update(made)

    @property
    def zero_row(self) -> int:
        return self.rows - 1

    def shard(self, b: int, d: int) -> torch.Tensor:
        """Cell (b, d)'s docs shard: int32 [R + 1, word_width / n_docs]."""
        return self._shards[d, self.mesh.devices[b][d]]

    def _shard_from_matrix(self, d: int, dev: torch.device) -> torch.Tensor:
        m = self.index.matrix
        c0 = d * self.shard_width
        n = max(0, min(self.shard_width, m.shape[1] - c0))
        out = torch.zeros((self.rows, self.shard_width), dtype=torch.int32,
                          device=dev)
        if n:
            with _on(dev):
                out[:, :n].copy_(m[:, c0:c0 + n])
        return out

    def _shard_from_streamed(self, d: int, dev: torch.device
                             ) -> torch.Tensor:
        """Docs shard d read from the mapped payload into `dev`, in row
        chunks of about STAGE_BYTES through two host buffers (pinned for
        CUDA): one is filled from the mmap while the other uploads, so a
        shard of tens of GB needs no host buffer of its size."""
        st = self.index
        Wl = self.shard_width
        out = torch.zeros((self.rows, Wl), dtype=torch.int32, device=dev)
        b0 = d * Wl * 4
        b1 = min(b0 + Wl * 4, st.page_size)
        if b1 <= b0:
            return out
        R = st.total_rows
        step = max(1, min(R, STAGE_BYTES // (Wl * 4)))
        cuda = dev.type == "cuda"
        bufs = [torch.zeros((step, Wl), dtype=torch.int32, pin_memory=cuda)
                for _ in range(2)]
        events = [None, None]
        with _on(dev):
            for i, r0 in enumerate(range(0, R, step)):
                n = min(step, R - r0)
                j = i % 2
                if events[j] is not None:
                    events[j].synchronize()
                bufs[j].numpy().view(np.uint8)[:n, :b1 - b0] = \
                    st._payload[r0:r0 + n, b0:b1]
                out[r0:r0 + n].copy_(bufs[j][:n], non_blocking=cuda)
                if cuda:
                    events[j] = torch.cuda.Event()
                    events[j].record()
            for ev in events:
                if ev is not None:
                    ev.synchronize()
        return out

    def _mask(self, d: int, dev: torch.device) -> torch.Tensor:
        """bool [P * Wl * 32] on `dev`: the real-document slots of docs
        shard d."""
        if (d, dev) not in self._masks:
            ix = self.index
            full = _doc_valid_mask(
                ix.doc_layout.with_w32(self.word_width * 32),
                len(ix.file_names)).reshape(ix.num_pages, self.word_width,
                                            32)
            Wl = self.shard_width
            self._masks[d, dev] = torch.from_numpy(np.ascontiguousarray(
                full[:, d * Wl:(d + 1) * Wl]).reshape(-1)).to(dev)
        return self._masks[d, dev]

    # ------------------------------------------------------------ payloads

    def _rows_idx(self, hashes_list, n_pad: int,
                  t_multiple: int = 1) -> np.ndarray:
        """int32 [n_pad, T, h, P] row ids of per-query host hashes, T the
        longest query's terms rounded up to `t_multiple` (the sequence
        split cuts T over the "batch" axis); padding terms and padding
        queries point at the zero row."""
        ix = self.index
        T = _round_up(max(h.shape[0] for h in hashes_list), t_multiple)
        rows = np.full((n_pad, T, ix.num_hashes, ix.num_pages),
                       self.zero_row, dtype=np.int32)
        for b, hs in enumerate(hashes_list):
            rows[b, :hs.shape[0]] = ix.row_indices(hs)
        return rows

    def _pack_queries(self, qb: QueryBytes, n_pad: int):
        """(uint8 [n_pad, L], int32 [n_pad]): the padded query bytes; a
        padding query has length 0, so all its terms hit the zero row."""
        if not int32_row_ids(self.index):
            raise ValueError("index too large for int32 row addressing")
        if qb.packed is None:
            prepack_query_bytes(self.index, qb)
        n, L = qb.packed.shape
        if n == n_pad:
            return qb.packed, qb.lens
        packed = np.full((n_pad, L), ord("A"), dtype=np.uint8)
        packed[:n] = qb.packed
        lens = np.zeros(n_pad, dtype=np.int32)
        lens[:n] = qb.lens
        return packed, lens

    def _seq_split(self, payload) -> bool:
        """Whether this (host-hashed) batch runs the sequence split: a
        "batch" axis of more than one row would otherwise idle on a long
        query padded to the grid."""
        if isinstance(payload, QueryBytes):
            return False
        return (self.mesh.shape["batch"] > 1
                and max(h.shape[0] for h in payload)
                >= settings.seq_split_terms)

    # ------------------------------------------------------------- kernels

    def _cell_rows(self, b: int, d: int, rows: np.ndarray) -> torch.Tensor:
        """Cell (b, d)'s counts int32 [n, P * Wl * 32] for host row ids."""
        dev = self.mesh.devices[b][d]
        with _on(dev):
            return gather_and_count(
                self.shard(b, d),
                _upload(np.ascontiguousarray(rows), dev),
                self.index.num_hashes)

    def _cell_bytes(self, b: int, d: int, qdata: np.ndarray,
                    qlens: np.ndarray) -> torch.Tensor:
        """Cell (b, d)'s counts for query bytes, hashed on its device."""
        ix = self.index
        dev = self.mesh.devices[b][d]
        sig, off, mag = self._tables[dev]
        with _on(dev):
            rows = rows_from_queries(_upload(qdata, dev), _upload(qlens, dev),
                                     ix.term_size, ix.num_hashes,
                                     ix.canonicalize, sig, off,
                                     self.zero_row, mag)
            return gather_and_count(self.shard(b, d), rows, ix.num_hashes)

    def _k_eff(self, k: int) -> int:
        return min(k, self.shard_width * 32 * self.index.num_pages)

    def _topk_cell(self, scores: torch.Tensor, d: int, k: int
                   ) -> torch.Tensor:
        """Docs shard d's top k of its counts, (score desc, slot asc) as
        engine.topk_slots ranks them, with its slots mapped to the flat
        index over the page-major [P, word_width, 32] layout of the whole
        mesh (cobs_tpu's _local_topk): int64 [2, n, k] (scores, flat
        index)."""
        Wl32 = self.shard_width * 32
        with _on(scores.device):
            vals, slots = topk_slots(scores, self._mask(d, scores.device),
                                     self._k_eff(k))
            g = (slots // Wl32 * (self.word_width * 32) + d * Wl32
                 + slots % Wl32)
            return torch.stack((vals, g))

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, payload, k: int) -> _SharedMeshFetch:
        """Every local cell's share of one payload (a QueryBytes or per-
        query host hashes, one batch or a group's concatenation): its
        slice of the queries, padded to a multiple of the "batch" axis,
        against its docs shard, ranked per shard when k > 0."""
        n_batch = self.mesh.shape["batch"]
        n_pad = _round_up(max(len(payload), n_batch), n_batch)
        nl = n_pad // n_batch
        if isinstance(payload, QueryBytes):
            qdata, qlens = self._pack_queries(payload, n_pad)
        else:
            rows = self._rows_idx(payload, n_pad)
        outs = {}
        for b, d in self.mesh.local_cells():
            s = slice(b * nl, (b + 1) * nl)
            scores = (self._cell_bytes(b, d, qdata[s], qlens[s])
                      if isinstance(payload, QueryBytes)
                      else self._cell_rows(b, d, rows[s]))
            outs[b, d] = self._topk_cell(scores, d, k) if k else scores
        return _SharedMeshFetch(self, outs,
                                lambda host: self._assemble(host, k))

    def _seq_reduce(self, parts: list, d: int, k: int) -> torch.Tensor:
        """Docs column d's partial counts summed in int32 on the first
        part's device (cobs_tpu's psum over "batch"), then ranked there
        when k > 0."""
        total = parts[0]
        with _on(total.device):
            for p in parts[1:]:
                total.add_(_to(p, total.device))
        return self._topk_cell(total, d, k) if k else total

    def _dispatch_seq(self, hashes_list, k: int) -> _SharedMeshFetch:
        """The sequence split: "batch" row b counts terms
        [b * T / n_batch, (b + 1) * T / n_batch) of every query against
        its docs shard; each docs column's partial counts are summed, on
        the device of its first cell in one process, on the host after
        the exchange on a mesh that spans processes."""
        n_batch, n_docs = self.mesh.shape["batch"], self.mesh.shape["docs"]
        rows = self._rows_idx(hashes_list, len(hashes_list), n_batch)
        tl = rows.shape[1] // n_batch
        parts = {(b, d): self._cell_rows(b, d, rows[:, b * tl:(b + 1) * tl])
                 for b, d in self.mesh.local_cells()}
        if self.mesh.ranks is None:
            outs = {(0, d): self._seq_reduce(
                [parts[b, d] for b in range(n_batch)], d, k)
                for d in range(n_docs)}
            return _SharedMeshFetch(self, outs,
                                    lambda host: self._assemble(host, k))

        def combine(host):
            outs = {(0, d): self._seq_reduce(
                [torch.from_numpy(host[b, d]).clone()
                 for b in range(n_batch)], d, k).numpy()
                for d in range(n_docs)}
            return self._assemble(outs, k)

        return _SharedMeshFetch(self, parts, combine)

    def _exchange(self, host: dict) -> dict:
        """Every process's fetched cell outputs, on a mesh that spans
        processes (one all_gather_object); this process's otherwise."""
        global EXCHANGES
        if self.mesh.ranks is None:
            return host
        import torch.distributed as dist

        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, host)
        EXCHANGES += 1
        merged = {}
        for g in got:
            merged.update(g)
        return merged

    def _assemble(self, host: dict, k: int):
        """The cells' host outputs as one answer: counts int32 [n, P,
        word_width * 32] (each "batch" row's docs shards side by side on
        the word axis, the rows one after another), or the top-k
        candidates (scores int64 [n, n_docs * k], flat index int64 [n,
        n_docs * k]), each row's shards in docs order."""
        n_docs = self.mesh.shape["docs"]
        P = self.index.num_pages
        rows = sorted({b for b, _ in host})
        if k:
            cat = np.concatenate([np.concatenate(
                [host[b, d] for d in range(n_docs)], axis=2)
                for b in rows], axis=1)
            return cat[0], cat[1]
        return np.concatenate([np.concatenate(
            [host[b, d].reshape(host[b, d].shape[0], P, -1)
             for d in range(n_docs)], axis=2) for b in rows], axis=0)

    def _multi(self, payloads: list, k: int) -> list[PendingSharded]:
        if len(payloads) > 1 and any(self._seq_split(p) for p in payloads):
            return [self._multi([p], k)[0] for p in payloads]
        if self._seq_split(payloads[0]):
            shared = self._dispatch_seq(payloads[0], k)
        else:
            shared = self._dispatch(_concat_payloads(self.index, payloads),
                                    k)
        W32, lay = self.word_width * 32, self.index.doc_layout

        def finish_for(lo: int, B: int):
            def finish():
                out = shared.get()
                if k:
                    v, g = out
                    return _merge_topk_host(v[lo:], g[lo:], W32, lay, B, k)
                return assemble_scores(out[lo:lo + B], lay)
            return finish

        return [PendingSharded(finish_for(lo, len(p)))
                for lo, p in zip(_offsets(payloads), payloads)]

    # -------------------------------------------------------------- public

    def score_batch(self, payload) -> np.ndarray:
        """Score a batch of queries (per-query uint64 [T, h] host hashes,
        or a QueryBytes payload hashed on each cell's device) across the
        mesh: int32 [B, counts_size], exactly the single-device
        engine.score_batch. A host-hashed batch whose longest query has
        at least settings.seq_split_terms terms runs the sequence split
        on a mesh of more than one "batch" row."""
        return self.score_batch_async(payload).fetch()

    def score_batch_async(self, payload) -> PendingSharded:
        """Dispatch `score_batch` without waiting; fetch() waits."""
        return self._multi([payload], 0)[0]

    def score_topk(self, payload, k: int):
        """Sharded top-k: each docs shard ranks its own documents and only
        [B, n_docs * k] candidate pairs leave the devices, merged on the
        host in the reference's (score desc, doc asc) order (reference:
        cobs/query/classic_search.cpp:140-144). Returns (scores i32
        [B, k'], doc numbers i64 [B, k']) in engine.score_topk's slot
        numbering; padding slots carry score -1."""
        return self.score_topk_async(payload, k).fetch()

    def score_topk_async(self, payload, k: int) -> PendingSharded:
        return self._multi([payload], k)[0]

    def score_batch_multi_async(self, payloads: list) -> list:
        """K batches as one dispatch: each cell gets its share of the K
        batches' concatenated queries (engine._concat_payloads), so one
        launch of the hash kernel and of the gather-and-count kernel per
        cell; one PendingSharded per batch, sharing one fetch. A group
        holding a batch that runs the sequence split goes batch by
        batch."""
        return self._multi(payloads, 0)

    def score_topk_multi_async(self, payloads: list, k: int) -> list:
        """score_batch_multi_async with each shard's top k of every row."""
        return self._multi(payloads, k)


def _merge_topk_host(v, g, W32: int, lay, B: int, k: int):
    """Merge one batch's per-shard top-k candidates [B_pad, shards*k]
    into the engine.score_topk contract: (scores i32 [B, k'],
    doc_numbers i64 [B, k']), reference (score desc, doc asc) order.

    Vectorized over the batch with one composed-key argsort: documents
    partition across shards, so doc numbers are unique per row and the
    int64 key (score << 40) - doc orders exactly by (score desc, doc
    asc) with no stability requirement. Replaces a per-query
    np.lexsort that measured 0.49 s per 32k queries (BASELINE r4) —
    on a real mesh at B=1024 that sort was the serving bottleneck."""
    v = v[:B].astype(np.int64)
    g = g[:B]
    kk = min(k, v.shape[1])
    page, local = g.astype(np.int64) // W32, g.astype(np.int64) % W32
    dpp = lay.uniform_docs
    doc = (page * dpp + local if dpp is not None
           else lay.doc_offsets[page] + local)
    if v.size and (int(v.max()) >= 1 << 23 or int(doc.max()) >= 1 << 40):
        # composed key would overflow (queries beyond 8M terms or >1T
        # doc slots); keep the exact 2-key path for that regime
        out_v = np.empty((B, kk), dtype=np.int32)
        out_d = np.empty((B, kk), dtype=np.int64)
        for b in range(B):
            order = np.lexsort((doc[b], -v[b]))[:kk]
            out_v[b] = v[b][order]
            out_d[b] = doc[b][order]
        return out_v, out_d
    # keys are unique per row (docs partition across shards), so an
    # unstable sort is exact; selecting the k winners first
    # (argpartition, O(S)) and sorting only those measured 2.7x over
    # the full row argsort at [1024, 800] -> 100
    key = doc - (v << 40)
    if kk < key.shape[1]:
        part = np.argpartition(key, kk - 1, axis=1)[:, :kk]
        pkey = np.take_along_axis(key, part, axis=1)
        order = np.take_along_axis(part, np.argsort(pkey, axis=1),
                                   axis=1)
    else:
        order = np.argsort(key, axis=1)
    out_v = np.take_along_axis(v, order, axis=1).astype(np.int32)
    out_d = np.take_along_axis(doc, order, axis=1)
    return out_v, out_d


def assemble_scores(scores, lay) -> np.ndarray:
    """[B, pages, W, 32] (or [B, pages, W * 32]) host scores -> int32
    [B, counts_size].

    Strips the per-shard word padding, keeping each page's real doc
    slots (page-major layout, matching the reference's 8-aligned score
    offsets, reference: cobs/query/classic_search.cpp:413-429). `lay`
    is the index's engine.DocLayout (or a plain uniform docs-per-page
    int) — uniform pages take the reshape fast path, run-coalesced
    pages concatenate per-page prefixes.
    """
    s = np.asarray(scores).astype(np.int32, copy=False)
    B, Pp = s.shape[0], s.shape[1]
    s = s.reshape(B, Pp, -1)
    if isinstance(lay, (int, np.integer)):   # uniform docs-per-page
        dpp = int(lay)
        return np.ascontiguousarray(
            s[:, :, :dpp].reshape(B, Pp * dpp))
    dpp = lay.uniform_docs
    if dpp is not None:
        return np.ascontiguousarray(
            s[:, :, :dpp].reshape(B, Pp * dpp))
    return np.concatenate(
        [s[:, p, :int(lay.page_docs[p])] for p in range(Pp)], axis=1)


# ------------------------------------------------------- construction step

def shard_words(mesh: Mesh, rows: int, word_width: int) -> list:
    """Zeroed word-major shards of a [rows + 1, word_width] matrix (the
    last row the zero row): one int32 [word_width / n_docs, rows + 1]
    tensor per docs column, on the device of the column's first cell;
    word_width must divide by the docs axis."""
    n_docs = mesh.shape["docs"]
    if word_width % n_docs:
        raise ValueError(f"word_width {word_width} does not divide over "
                         f"{n_docs} docs shards")
    return [torch.zeros((word_width // n_docs, rows + 1), dtype=torch.int32,
                        device=mesh.devices[0][d]) for d in range(n_docs)]


def scatter_step(mesh: Mesh, words: list, rows, docs) -> list:
    """Sharded construction step: set bit docs[i] of row rows[i] in the
    word-major shards `words` (`shard_words`), in place; returns them.

    rows, docs: int32 [n] (host arrays or tensors), global document ids.
    Each shard takes every update with its own base subtracted from the
    document id; the kernel drops the updates outside its documents
    (negative or past its end), so foreign updates need no routing.
    Updates of the zero row are dropped (cobs_tpu zeroes the zero row of
    its delta): it must stay zero. `mesh` is the one the shards were
    made for (cobs_tpu's signature)."""
    rows = torch.as_tensor(rows, dtype=torch.int32)
    docs = torch.as_tensor(docs, dtype=torch.int32)
    for d, w in enumerate(words):
        Wl, R1 = w.shape
        with _on(w.device):
            r = rows.to(w.device)
            r = torch.where(r == R1 - 1, -1, r).contiguous()
            dd = docs.to(w.device)
            if d:
                dd = dd - d * Wl * 32
            construct_scatter(w, r, dd.contiguous())
    return words


def train_step(mesh: Mesh, words: list, rows, docs, rows_idx,
               num_hashes: int):
    """The full sharded step: set a batch of bits in the word-major
    shards (`scatter_step`), then score a query batch against them.

    rows_idx: int32 [B, T, h, P] row ids (B a multiple of the "batch"
    axis). Returns (words, scores): scores int32 [B, P, W, 32] on the
    host, cell (b, d) having scored query slice b against docs shard d.
    """
    words = scatter_step(mesh, words, rows, docs)
    rows_idx = np.asarray(rows_idx, dtype=np.int32)
    n_batch, n_docs = mesh.shape["batch"], mesh.shape["docs"]
    B, P = rows_idx.shape[0], rows_idx.shape[3]
    if B % n_batch:
        raise ValueError(f"batch of {B} does not divide over {n_batch} "
                         "batch rows")
    nl = B // n_batch
    mats, out = {}, []
    for b in range(n_batch):
        row = []
        for d in range(n_docs):
            dev = mesh.devices[b][d]
            with _on(dev):
                if (d, dev) not in mats:
                    mats[d, dev] = _to(words[d], dev).t().contiguous()
                s = gather_and_count(
                    mats[d, dev],
                    _upload(np.ascontiguousarray(
                        rows_idx[b * nl:(b + 1) * nl]), dev), num_hashes)
            row.append(s.cpu().numpy().reshape(nl, P, -1, 32))
        out.append(np.concatenate(row, axis=2))
    return words, np.concatenate(out, axis=0)
