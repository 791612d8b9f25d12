"""PyTorch query engine: an index held in device memory, or streamed from
a host mmap, scored by the fused gather -> AND -> count kernel.

The port of `cobs_tpu/query/engine.py`. A `DeviceIndex` lives on the
device as ONE dense matrix of 32-bit words ``[total_rows + 1, W]``
(torch.int32, bit for bit the u32 words):

- classic index: total_rows = signature_size, W = ceil(row_size/4) words;
- compact index: the per-page sub-matrices are stacked row-wise;
  ``row_offsets[p]`` locates page p's block and every page is padded to
  the same word width (reference: cobs/construction/compact_index.cpp:
  137-150), so classic is the P=1 case of one engine;
- the last row is all zero: padding terms point at it.

A query batch becomes a row-index tensor [B, T, h, P] padded to the
longest query with zero-row terms, then one launch of
`ops.query_kernel.gather_and_count`, then either the full score vector per
query (`score_batch`) or the top k (score, doc) pairs (`score_topk`) in
the reference's (score desc, doc asc) order. The row ids come either from
the device (a `QueryBytes` payload: the raw query bytes are uploaded and
`ops.device_hash.rows_from_queries` hashes them on the index's device) or
from the host (per-query XXH64 from `create_hashes`, turned into
row ids by `DeviceIndex.row_indices` and uploaded).

`score_batch_async` / `score_topk_async` enqueue that work and return a
`PendingScores` / `PendingTopK` whose `fetch()` is the only point that
waits on the device; `score_batch` / `score_topk` fetch at once.
`score_batch_multi_async` / `score_topk_multi_async` enqueue K batches as
one payload (one upload and one launch of each kernel) and return one
pending handle per batch, all sharing one fetch.

A `StreamedIndex` keeps the payload in a host mmap instead, for indexes
larger than the device budget (`settings.max_device_index_bytes`): each
batch reads only the rows it touches, and either the device scores the
gathered rows with the same kernel or the native host scorer scores
them in place (`settings.streamed_host_score`).
"""

import concurrent.futures
import dataclasses
import functools
import os

import numpy as np
import torch

from cobs_tpu_torch import native
from cobs_tpu_torch.fmt import classic as fmt_classic
from cobs_tpu_torch.fmt import compact as fmt_compact
from cobs_tpu_torch.fmt.magic import FileIOError
from cobs_tpu_torch.ingest.util import sliding_windows
from cobs_tpu_torch.ops.device_hash import page_tables as device_hash_tables
from cobs_tpu_torch.ops.device_hash import rows_from_queries
from cobs_tpu_torch.ops.query_kernel import gather_and_count
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.timer import Timer

#: padding of the word axis, kept equal to cobs_tpu's so the padded
#: layout, the run-coalescing decisions and the padded score tensor are
#: identical in both packages (the kernel itself takes any W >= 1)
_WORD_ALIGN = 128


def _pad_words(n: int) -> int:
    return max(_WORD_ALIGN, -(-n // _WORD_ALIGN) * _WORD_ALIGN)


def _bytes_to_words(rows: np.ndarray, word_width: int) -> np.ndarray:
    """uint8 [R, row_bytes] -> uint32 [R, word_width] little-endian.

    LSB-first byte bits + little-endian words mean: document index ==
    word_index * 32 + bit_index, with no bit shuffling.
    """
    R, row_bytes = rows.shape
    out = np.zeros((R, word_width * 4), dtype=np.uint8)
    out[:, :row_bytes] = rows
    return out.view("<u4")


def resolve_device(device=None) -> torch.device:
    """`device` (None = settings.device) as a torch.device; raises when
    CUDA is asked for and absent, so nothing carries on on the CPU."""
    dev = torch.device(settings.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available (torch.cuda.is_available() is "
                           "False)")
    return dev


@dataclasses.dataclass(frozen=True)
class DocLayout:
    """Host-side mapping from device score slots to PUBLIC doc slots.

    The device score tensor is page-major with `w32` slots per page
    (word_width * 32, including per-page word padding); the public
    layout is the reference's 8-aligned slots per ORIGINAL page with
    no word padding (reference: cobs/query/classic_search.cpp:413-429).
    Uniform indexes (classic, and compact merged by a uniform factor)
    have equal `page_docs`; run-coalesced compact indexes carry true
    per-page doc counts and offsets.
    """

    w32: int
    page_docs: np.ndarray     # int64 [P] real doc slots per page
    doc_offsets: np.ndarray   # int64 [P+1] public slot offsets

    @property
    def num_pages(self) -> int:
        return len(self.page_docs)

    @property
    def counts_size(self) -> int:
        return int(self.doc_offsets[-1])

    @property
    def uniform_docs(self) -> int | None:
        """docs-per-page when every page holds the same count."""
        d = self.page_docs
        if len(d) and (d == d[0]).all():
            return int(d[0])
        return None

    def with_w32(self, w32: int) -> "DocLayout":
        """The same doc mapping over another padded page row width (a
        mesh pads word_width to its alignment)."""
        return DocLayout(w32, self.page_docs, self.doc_offsets)


class _PageLayout:
    """The score layout and device tables shared by `DeviceIndex` and
    `StreamedIndex`; both set sig_sizes, row_offsets, word_width,
    page_size, page_docs and file_names, and a `device`."""

    @property
    def num_pages(self) -> int:
        return len(self.sig_sizes)

    @property
    def doc_layout(self) -> DocLayout:
        if self.page_docs is None:
            pd = np.full(self.num_pages, 8 * self.page_size, dtype=np.int64)
        else:
            pd = np.asarray(self.page_docs, dtype=np.int64)
        off = np.zeros(self.num_pages + 1, dtype=np.int64)
        np.cumsum(pd, out=off[1:])
        return DocLayout(self.word_width * 32, pd, off)

    @property
    def counts_size(self) -> int:
        """Score slots including 8-alignment padding
        (reference: cobs/query/classic_index/search_file.cpp:21-23)."""
        return self.doc_layout.counts_size

    @functools.cached_property
    def valid_mask(self) -> torch.Tensor:
        """bool [P*W*32] on the device: True for slots of real documents."""
        return torch.from_numpy(_doc_valid_mask(
            self.doc_layout, len(self.file_names))).to(self.device)

    @functools.cached_property
    def page_tables(self) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
        """(sig_sizes, row_offsets, Barrett factors) as int64 [P] tensors
        on the device: the per-page modulo, offset and modulo factor of
        device hashing (`device_hash.page_tables`)."""
        return device_hash_tables(self.sig_sizes, self.row_offsets,
                                  self.device)


@dataclasses.dataclass
class DeviceIndex(_PageLayout):
    """An index resident in device memory."""

    #: int32 [total_rows + 1, W]: the u32 words bit for bit; the last row
    #: is all zero (gather target for padding terms)
    matrix: torch.Tensor
    #: int64 [P] row offset of each page block
    row_offsets: np.ndarray
    #: uint64 [P] per-page signature sizes
    sig_sizes: np.ndarray
    #: words per page row
    word_width: int
    term_size: int
    canonicalize: int
    num_hashes: int
    page_size: int  # bytes per page row
    file_names: list[str]
    path: str = ""
    #: int64 [P] real doc slots per (merged) page; None = uniform
    #: 8*page_size (set by the run-coalesced compact load)
    page_docs: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    @property
    def zero_row(self) -> int:
        return self.matrix.shape[0] - 1

    @classmethod
    def from_arrays(cls, matrix, row_offsets, sig_sizes, word_width: int,
                    term_size: int, canonicalize: int, num_hashes: int,
                    page_size: int, file_names, page_docs=None, device=None,
                    path: str = "") -> "DeviceIndex":
        """An index over a ready matrix: a numpy uint32 array or a torch
        uint32/int32 tensor [total_rows + 1, word_width] whose last row
        is zero. It is copied or moved to `device` (None =
        settings.device)."""
        dev = resolve_device(device)
        if isinstance(matrix, np.ndarray):
            if matrix.dtype != np.uint32:
                raise TypeError(f"matrix must be uint32, got {matrix.dtype}")
            t = torch.from_numpy(np.array(matrix).view(np.int32))
        else:
            t = matrix.view(torch.int32) if matrix.dtype == torch.uint32 \
                else matrix
            if t.dtype != torch.int32:
                raise TypeError(f"matrix must be uint32 or int32, got "
                                f"{matrix.dtype}")
        if t.dim() != 2 or t.shape[1] != word_width:
            raise ValueError(f"matrix {tuple(t.shape)} is not "
                             f"[rows + 1, word_width={word_width}]")
        return cls(matrix=t.to(dev).contiguous(),
                   row_offsets=np.asarray(row_offsets, dtype=np.int64),
                   sig_sizes=np.asarray(sig_sizes, dtype=np.uint64),
                   word_width=int(word_width), term_size=int(term_size),
                   canonicalize=int(canonicalize),
                   num_hashes=int(num_hashes), page_size=int(page_size),
                   file_names=list(file_names), path=str(path),
                   page_docs=None if page_docs is None
                   else np.asarray(page_docs, dtype=np.int64))

    @classmethod
    def from_reference(cls, ix, device=None) -> "DeviceIndex":
        """The same index as a `cobs_tpu` DeviceIndex `ix`, read by duck
        typing (np.asarray of its matrix), so both packages score one
        matrix."""
        return cls.from_arrays(
            np.asarray(ix.matrix), ix.row_offsets, ix.sig_sizes,
            ix.word_width, ix.term_size, ix.canonicalize, ix.num_hashes,
            ix.page_size, ix.file_names, page_docs=ix.page_docs,
            device=device, path=ix.path)

    @classmethod
    def from_classic(cls, path, device=None) -> "DeviceIndex":
        dev = resolve_device(device)
        with open(path, "rb") as f:
            h = fmt_classic.ClassicIndexHeader.deserialize(f)
            off = f.tell()
        W = _pad_words(-(-h.row_size // 4))
        matrix = _load_matrix_striped(path, off, h.signature_size,
                                      h.row_size, W, dev)
        return cls(matrix=matrix,
                   row_offsets=np.zeros(1, dtype=np.int64),
                   sig_sizes=np.asarray([h.signature_size],
                                        dtype=np.uint64),
                   word_width=W, term_size=h.term_size,
                   canonicalize=h.canonicalize, num_hashes=h.num_hashes,
                   page_size=h.row_size, file_names=h.file_names,
                   path=str(path))

    @classmethod
    def from_compact(cls, path, device=None) -> "DeviceIndex":
        dev = resolve_device(device)
        h, off = fmt_compact.read_compact_header(path)
        if not h.parameters:
            raise FileIOError("compact index has no pages")
        num_hashes = h.parameters[0].num_hashes
        for p in h.parameters:
            if p.num_hashes != num_hashes:
                raise FileIOError(
                    "compact index with non-uniform num_hashes unsupported")
        sig_sizes = [p.signature_size for p in h.parameters]
        page_size = h.page_size
        runs = _compact_runs(sig_sizes, page_size)
        page_docs = None
        if runs is None:
            W = _pad_words(-(-page_size // 4))
            matrix = _load_matrix_striped(path, off, int(sum(sig_sizes)),
                                          page_size, W, dev)
        else:
            if fmt_compact.coalesce_factor(sig_sizes) == 1:
                # equal-Bloom runs: merged pages span variable numbers of
                # original pages, tracked by per-page doc counts
                # (DocLayout)
                page_docs = np.asarray(
                    [8 * page_size * n for _, n in runs], dtype=np.int64)
            matrix, sig_sizes = _load_matrix_coalesced(
                path, off, sig_sizes, page_size, dev, runs)
            page_size *= max(n for _, n in runs)
            W = matrix.shape[1]
        offsets = np.zeros(len(sig_sizes), dtype=np.int64)
        np.cumsum(sig_sizes[:-1], out=offsets[1:])
        return cls(matrix=matrix, row_offsets=offsets,
                   sig_sizes=np.asarray(sig_sizes, dtype=np.uint64),
                   word_width=W, term_size=h.term_size,
                   canonicalize=h.canonicalize, num_hashes=num_hashes,
                   page_size=page_size, file_names=h.file_names,
                   path=str(path), page_docs=page_docs)

    @classmethod
    def from_file(cls, path, device=None) -> "DeviceIndex":
        if fmt_classic.is_classic_file(path):
            return cls.from_classic(path, device)
        if fmt_compact.is_compact_file(path):
            return cls.from_compact(path, device)
        raise FileIOError(f'Could not open index path "{path}"')

    def row_indices(self, hashes: np.ndarray) -> np.ndarray:
        """uint64 hashes [T, h] -> int32 row indices [T, h, P]
        (per-page modulo, reference:
        cobs/query/compact_index/mmap_search_file.cpp:55-66)."""
        idx = (hashes[:, :, None] % self.sig_sizes[None, None, :]
               + self.row_offsets[None, None, :].astype(np.uint64))
        if self.matrix.shape[0] <= np.iinfo(np.int32).max:
            return idx.astype(np.int32)
        raise ValueError("index too large for int32 row addressing")


#: payload bytes per host-to-device copy when loading an index: bounds the
#: extra host memory to one stripe (the reference's analog is the mmap
#: load that never copies twice, reference: cobs/util/query.cpp:38-88)
_UPLOAD_STRIPE_BYTES = 64 << 20


def _load_matrix_striped(path, payload_off: int, total_rows: int,
                         row_bytes: int, W: int,
                         device: torch.device) -> torch.Tensor:
    """Load an index payload into a device int32 [total_rows + 1, W]
    matrix stripe by stripe (the last row stays the all-zero gather
    target)."""
    buf = torch.zeros((total_rows + 1, W), dtype=torch.int32, device=device)
    rows_per = max(1, _UPLOAD_STRIPE_BYTES // (W * 4))
    with open(path, "rb") as f:
        f.seek(payload_off)
        r = 0
        while r < total_rows:
            n = min(rows_per, total_rows - r)
            raw = np.fromfile(f, dtype=np.uint8, count=n * row_bytes)
            if raw.size != n * row_bytes:
                raise FileIOError("index payload truncated")
            words = _bytes_to_words(raw.reshape(n, row_bytes), W)
            buf[r:r + n].copy_(torch.from_numpy(words.view(np.int32)))
            r += n
    return buf


def _compact_runs(sig_sizes, page_size: int):
    """How DeviceIndex lays out a compact index's pages: None keeps one
    padded row per page, else [(start, length), ...] runs of pages merged
    column-wise into wider rows.

    Pages with equal Bloom sizes probe the same row per hash, so they
    merge column-wise bit-exactly (fmt_compact.coalesce_factor): one
    gather per term instead of one per page. The same environment
    switches as cobs_tpu's loader: COBS_TPU_COALESCE_PAGES=0 turns merging
    off, COBS_TPU_RUN_CAP caps merged runs (unset/auto = cost model, 0 =
    uncapped, N = forced cap)."""
    if os.environ.get("COBS_TPU_COALESCE_PAGES", "1") == "0":
        return None
    m = fmt_compact.coalesce_factor(sig_sizes)
    if m > 1:
        return [(i, m) for i in range(0, len(sig_sizes), m)]
    runs = fmt_compact.coalesce_runs(sig_sizes)
    if not any(n > 1 for _, n in runs):
        return None
    cap_env = os.environ.get("COBS_TPU_RUN_CAP", "")
    if cap_env in ("", "auto"):
        cap = _best_run_cap(runs, page_size)
    else:
        cap = int(cap_env)
        if cap < 0:
            raise ValueError(f"COBS_TPU_RUN_CAP must be >= 0 "
                             f"(0 = uncapped), got {cap}")
        cap = cap or max(n for _, n in runs)
    runs = _split_runs(runs, cap)
    if any(n > 1 for _, n in runs) and _runs_worthwhile(
            runs, sig_sizes, page_size):
        return runs
    return None


def device_index_bytes(path) -> int:
    """Bytes that DeviceIndex.from_file(path) holds on the device, from
    the header alone: (rows + 1) x padded word width x 4, rows and width
    after any page merging."""
    if fmt_classic.is_classic_file(path):
        h = fmt_classic.read_classic_header(path)
        rows, W = h.signature_size, _pad_words(-(-h.row_size // 4))
    elif fmt_compact.is_compact_file(path):
        h, _ = fmt_compact.read_compact_header(path)
        sig_sizes = [p.signature_size for p in h.parameters]
        runs = _compact_runs(sig_sizes, h.page_size)
        if runs is None:
            rows, W = sum(sig_sizes), _pad_words(-(-h.page_size // 4))
        else:
            rows = sum(sig_sizes[s] for s, _ in runs)
            W = _pad_words(-(-(h.page_size * max(n for _, n in runs))
                             // 4))
    else:
        raise FileIOError(f'Could not open index path "{path}"')
    return (rows + 1) * W * 4


def _best_run_cap(runs, page_size: int) -> int:
    """Pages-per-merged-page cap minimizing padded gather bytes/term.

    Run-length merging pads every merged page to the WIDEST run, so a
    skewed run profile gathers mostly zero padding. Splitting long runs
    at a cap trades more gathers for narrower rows: per-term gathered
    bytes at cap m are sum(ceil(len_i / m)) * padded_bytes(m * page_size).
    Among caps within 5% of the cheapest, the widest wins (the same rule
    as cobs_tpu, so both packages load the same layout)."""
    def padb(m):
        return _pad_words(-(-(page_size * m) // 4)) * 4

    costs = {m: sum(-(-n // m) for _, n in runs) * padb(m)
             for m in range(1, max(n for _, n in runs) + 1)}
    cmin = min(costs.values())
    return max(m for m, c in costs.items() if c <= 1.05 * cmin)


def _split_runs(runs, cap: int):
    """Split every run into chunks of at most `cap` pages."""
    out = []
    for s, n in runs:
        while n > cap:
            out.append((s, cap))
            s += cap
            n -= cap
        out.append((s, n))
    return out


def _runs_worthwhile(runs, sig_sizes, page_size: int) -> bool:
    """Whether run-length merging pays: merge only when merged gather
    bytes per term <= unmerged and merged device memory <= 1.25x
    unmerged (both on the padded widths the device stores)."""
    max_len = max(n for _, n in runs)
    merged_row = _pad_words(-(-(page_size * max_len) // 4)) * 4
    plain_row = _pad_words(-(-page_size // 4)) * 4
    if merged_row * len(runs) > plain_row * len(sig_sizes):
        return False
    merged_bytes = sum(int(sig_sizes[s]) for s, _ in runs) * merged_row
    plain_bytes = int(sum(sig_sizes)) * plain_row
    return merged_bytes <= 1.25 * plain_bytes


def _load_matrix_coalesced(path, payload_off: int, sig_sizes: list,
                           page_size: int, device: torch.device, runs):
    """Load a compact payload with runs [(start, len), ...] of
    equal-signature pages merged column-wise into wider rows.

    Merged page g row r = concat of member pages' row r (identical row
    id per hash because the signature sizes are equal); every merged
    page is zero-padded to the widest run. Returns
    (matrix int32 [rows' + 1, W'], merged sig_sizes).
    """
    groups = [list(range(s, s + n)) for s, n in runs]
    merged_sigs = [int(sig_sizes[g[0]]) for g in groups]
    max_len = max(n for _, n in runs)
    W = _pad_words(-(-(page_size * max_len) // 4))
    buf = torch.zeros((sum(merged_sigs) + 1, W), dtype=torch.int32,
                      device=device)
    offs = np.zeros(len(sig_sizes) + 1, dtype=np.int64)
    np.cumsum(np.asarray(sig_sizes, dtype=np.int64) * page_size,
              out=offs[1:])
    mm = np.memmap(path, dtype=np.uint8, mode="r", offset=payload_off,
                   shape=(int(offs[-1]),))
    rows_per = max(1, _UPLOAD_STRIPE_BYTES // (W * 4))
    r_out = 0
    for g, sig in zip(groups, merged_sigs):
        r = 0
        while r < sig:
            n = min(rows_per, sig - r)
            stripe = np.zeros((n, W * 4), dtype=np.uint8)
            for j, p in enumerate(g):
                blk = mm[offs[p] + r * page_size:
                         offs[p] + (r + n) * page_size]
                stripe[:, j * page_size:(j + 1) * page_size] = \
                    blk.reshape(n, page_size)
            buf[r_out + r:r_out + r + n].copy_(
                torch.from_numpy(stripe.view(np.int32)))
            r += n
        r_out += sig
    return buf, merged_sigs


def create_hashes(queries: list[bytes], term_size: int, num_hashes: int,
                  canonicalize: int) -> list[np.ndarray]:
    """Per query: uint64 [num_terms, num_hashes] raw (un-modded) XXH64
    (reference: cobs/query/classic_search.cpp:66-107). All windows of the
    batch are canonicalized and hashed in one call of the native library
    (`native.window_hashes`); it raises if the library cannot be built.
    Errors are cobs_tpu's, raised for the first query at fault in batch
    order."""
    if canonicalize not in (0, 1):
        raise ValueError(f"Unknown canonicalize value {canonicalize}")
    windows = []
    for q in queries:
        w = sliding_windows(np.frombuffer(q, dtype=np.uint8), term_size)
        if w.shape[0] == 0:
            # cobs_tpu hashes query by query: an invalid query before this
            # one raises first
            if windows:
                _hash_windows(windows, 1, canonicalize)
            raise ValueError(
                f"query too short, needs to be at least {term_size} "
                "characters long")
        windows.append(w)
    if not windows:
        return []
    hashes = _hash_windows(windows, num_hashes, canonicalize)
    ends = np.cumsum([w.shape[0] for w in windows])
    return np.split(hashes, ends[:-1])


def _hash_windows(windows: list, num_hashes: int,
                  canonicalize: int) -> np.ndarray:
    hashes, good = native.window_hashes(np.concatenate(windows),
                                        num_hashes, canonicalize)
    if canonicalize == 1 and not good:
        raise ValueError("Invalid DNA base pair in query string. "
                         "Only ACGT are allowed.")
    return hashes


def _host_rows(index, hashes_list, dtype) -> np.ndarray:
    """[B, T, h, P] row ids of `dtype` from per-query host hashes; T is
    the longest query's term count and shorter queries pad with zero-row
    terms."""
    B = len(hashes_list)
    T = max(h.shape[0] for h in hashes_list)
    rows = np.full((B, T, index.num_hashes, index.num_pages),
                   index.zero_row, dtype=dtype)
    for b, hs in enumerate(hashes_list):
        rows[b, :hs.shape[0]] = index.row_indices(hs)
    return rows


def _rows_tensor(index: DeviceIndex, hashes_list) -> torch.Tensor:
    """int32 [B, T, h, P] row ids on the index's device from host
    hashes."""
    return _upload(_host_rows(index, hashes_list, np.int32), index.device)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`, without waiting for the
    device's earlier work: CUDA stages a non-blocking copy from pageable
    memory before it returns, so `a` may be freed at once. (Staging in
    pinned memory first measured no faster on the H100:
    experiments/stream_overlap.py.)"""
    return torch.from_numpy(a).to(device, non_blocking=True)


class QueryBytes:
    """Raw (validated) query bytes for device hashing.

    The scorers hash them on the index's device (ops.device_hash: window
    -> canonicalize -> XXH64 -> per-page mod), so the upload is the query
    bytes (~1 KB per query) instead of 4 bytes per (term, hash, page) of
    row ids, and the host computes no hash. Search builds one per index
    for DeviceIndex backends (settings.device_hash)."""

    __slots__ = ("queries", "packed", "lens")

    def __init__(self, queries: list[bytes]):
        self.queries = queries
        #: the host half of the upload (prepack_query_bytes): padded
        #: uint8 [B, L] rows and their int32 [B] lengths. Search fills
        #: them in its host stage, so dispatch only uploads.
        self.packed = None
        self.lens = None

    def __len__(self):
        return len(self.queries)


def _pack_query_bytes(queries: list[bytes], term_size: int):
    """(uint8 [B, L], int32 [B] true lengths): queries padded with 'A'
    to the longest one, and to at least term_size (one term). Terms past
    a query's end point at the zero row, so the padding only has to be
    valid ACGT, which keeps a validity check over the padded rows exact.
    cobs_tpu rounds B and T up to buckets to bound jit recompiles; eager
    PyTorch compiles nothing, so nothing is rounded here."""
    L = max(term_size, max(len(q) for q in queries))
    qb = np.full((len(queries), L), ord("A"), dtype=np.uint8)
    lens = np.zeros(len(queries), dtype=np.int32)
    _fill_query_rows(qb, lens, queries)
    return qb, lens


def _fill_query_rows(qb: np.ndarray, lens: np.ndarray, queries) -> None:
    """Copy query bytes into padded rows: a batch of one length in one
    join + reshape copy, others query by query."""
    n = len(queries)
    L0 = len(queries[0]) if n else 0
    if n and all(len(q) == L0 for q in queries):
        qb[:n, :L0] = np.frombuffer(
            b"".join(queries), dtype=np.uint8).reshape(n, L0)
        lens[:n] = L0
        return
    for b, q in enumerate(queries):
        a = np.frombuffer(q, dtype=np.uint8)
        qb[b, :a.size] = a
        lens[b] = a.size


def prepack_query_bytes(index: DeviceIndex, qb: QueryBytes) -> None:
    """Run the host half of the query upload (padding) ahead of dispatch
    and keep it on the payload: Search's host stage calls this, so its
    dispatch only uploads."""
    qb.packed, qb.lens = _pack_query_bytes(qb.queries, index.term_size)


#: the largest row id the hash kernel can write (int32)
_MAX_ROW_ID = np.iinfo(np.int32).max


def int32_row_ids(index) -> bool:
    """Whether every row id of `index`, its zero row included, fits the
    hash kernel's int32 ids."""
    return index.zero_row < _MAX_ROW_ID


def _device_hash_args(index, qb: QueryBytes):
    """(qdata uint8 [B, L], qlens int32 [B]) on the index's device."""
    if not int32_row_ids(index):
        # the same guard as the host path's row_indices: device hashing
        # must not silently truncate row ids
        raise ValueError("index too large for int32 row addressing")
    if qb.packed is None:
        prepack_query_bytes(index, qb)
    return _upload(qb.packed, index.device), _upload(qb.lens, index.device)


def _device_rows(index, qb: QueryBytes) -> torch.Tensor:
    """int32 [B, T, h, P] row ids of a QueryBytes batch, hashed on the
    index's device."""
    qdata, qlens = _device_hash_args(index, qb)
    sig, off, mag = index.page_tables
    return rows_from_queries(qdata, qlens, index.term_size,
                             index.num_hashes, index.canonicalize, sig, off,
                             index.zero_row, mag)


def _gather_count(index: DeviceIndex, payload) -> torch.Tensor:
    """int32 [B, P*W*32] padded-slot scores on the device; `payload` is a
    QueryBytes (hashed on the device) or per-query host hashes."""
    rows = (_device_rows(index, payload) if isinstance(payload, QueryBytes)
            else _rows_tensor(index, payload))
    return gather_and_count(index.matrix, rows, index.num_hashes)


class _SharedFetch:
    """One device-to-host copy of a dispatched tensor, shared by the
    pending handles of its batches: the first fetch waits for the device
    and copies the whole tensor once, the others slice that copy."""

    __slots__ = ("_dev", "_host")

    def __init__(self, dev: torch.Tensor):
        self._dev = dev
        self._host = None

    def get(self) -> np.ndarray:
        if self._host is None:
            self._host = self._dev.cpu().numpy()
            self._dev = None
        return self._host


class PendingScores:
    """A dispatched score batch: rows lo:lo + B of a shared fetch (all of
    it for a single batch; one batch's slice under multi-batch dispatch).
    fetch() copies it to the host, then runs `after` (a streamed index's
    page-cache eviction) if one is given."""

    __slots__ = ("_src", "_lo", "_B", "_lay", "_after")

    def __init__(self, src: _SharedFetch, lo: int, B: int,
                 layout: DocLayout, after=None):
        self._src = src
        self._lo = lo
        self._B = B
        self._lay = layout
        self._after = after

    def fetch(self) -> np.ndarray:
        """int32 [B, counts_size]: the score_batch contract. Waits for
        the device."""
        out = _strip_word_padding(
            self._src.get()[self._lo:self._lo + self._B], self._B,
            self._lay)
        if self._after is not None:
            self._after()
        return out


class PendingTopK:
    """A dispatched top-k batch: rows lo:lo + B of a shared fetch of
    int64 [2, N, k] (scores, then slots). fetch() copies it to the host,
    then runs `after` if one is given."""

    __slots__ = ("_src", "_lo", "_B", "_lay", "_after")

    def __init__(self, src: _SharedFetch, lo: int, B: int,
                 layout: DocLayout, after=None):
        self._src = src
        self._lo = lo
        self._B = B
        self._lay = layout
        self._after = after

    def fetch(self):
        """(scores i32 [B, k], doc_numbers i64 [B, k]): the score_topk
        contract. Waits for the device."""
        vals, slots = self._src.get()[:, self._lo:self._lo + self._B]
        if self._after is not None:
            self._after()
        return vals.astype(np.int32), _slot_doc_numbers(slots, self._lay)


class PendingHost:
    """A batch scored on a host worker thread (the streamed backend's host
    mode); fetch() waits for it, runs `after` if one is given, and folds
    the worker's private timer into `merge_into` (reference:
    cobs/util/timer.cpp:67-75 merges per-thread timers the same way)."""

    __slots__ = ("_fut", "_after", "_wt", "_into")

    def __init__(self, fut, after, worker_timer: Timer,
                 merge_into: Timer | None):
        self._fut = fut
        self._after = after
        self._wt = worker_timer
        self._into = merge_into

    def fetch(self):
        out = self._fut.result()
        if self._after is not None:
            self._after()
        if self._into is not None:
            self._into.merge(self._wt)
        return out


def _concat_payloads(index, payloads: list):
    """One payload holding the queries of K batches in order: QueryBytes
    rows padded to the longest row (terms past a query's length stay at
    the zero row, so every query scores as it would alone), or the
    per-query host hashes one after another."""
    if len(payloads) == 1:
        return payloads[0]
    if not isinstance(payloads[0], QueryBytes):
        return [hashes for p in payloads for hashes in p]
    for p in payloads:
        if p.packed is None:
            prepack_query_bytes(index, p)
    L = max(p.packed.shape[1] for p in payloads)
    out = QueryBytes([q for p in payloads for q in p.queries])
    if all(p.packed.shape[1] == L for p in payloads):
        out.packed = np.concatenate([p.packed for p in payloads])
    else:
        out.packed = np.full((len(out), L), ord("A"), dtype=np.uint8)
        lo = 0
        for p in payloads:
            out.packed[lo:lo + len(p), :p.packed.shape[1]] = p.packed
            lo += len(p)
    # a flagged query keeps its length 0 (every term at the zero row)
    out.lens = np.concatenate([p.lens for p in payloads])
    return out


def _offsets(payloads: list) -> list[int]:
    """First row of each batch in the concatenated payload."""
    return np.cumsum([0] + [len(p) for p in payloads[:-1]]).tolist()


def score_batch_multi_async(index: DeviceIndex, payloads: list,
                            timer: Timer | None = None
                            ) -> list[PendingScores]:
    """Enqueue the scoring of K batches (each a QueryBytes or per-query
    host hashes, all of one kind) as one: one upload, one launch of the
    hash kernel (device hashing) and one of the gather-and-count kernel
    over the K * B queries. Returns one PendingScores per batch; they
    share one fetch, so the first waits for the whole group and the rest
    slice its copy. cobs_tpu runs a lax.scan over the stacked batches
    instead (cobs_tpu/query/engine.py:2017)."""
    if timer:
        timer.active("io")
    scores = _gather_count(index, _concat_payloads(index, payloads))
    if timer:
        timer.stop()
    src, lay = _SharedFetch(scores), index.doc_layout
    return [PendingScores(src, lo, len(p), lay)
            for lo, p in zip(_offsets(payloads), payloads)]


def score_topk_multi_async(index: DeviceIndex, payloads: list, k: int,
                           timer: Timer | None = None) -> list[PendingTopK]:
    """score_batch_multi_async with one top-k over the K * B score rows:
    one PendingTopK per batch, sharing one fetch of [2, K * B, k]."""
    if timer:
        timer.active("io")
    scores = _gather_count(index, _concat_payloads(index, payloads))
    vals, slots = topk_slots(scores, index.valid_mask,
                             min(k, scores.shape[1]))
    if timer:
        timer.stop()
    src, lay = _SharedFetch(torch.stack((vals, slots))), index.doc_layout
    return [PendingTopK(src, lo, len(p), lay)
            for lo, p in zip(_offsets(payloads), payloads)]


def score_batch_async(index: DeviceIndex, payload,
                      timer: Timer | None = None) -> PendingScores:
    """Enqueue the scoring of a batch (QueryBytes or per-query host
    hashes) without waiting for the device."""
    return score_batch_multi_async(index, [payload], timer)[0]


def score_batch(index: DeviceIndex, payload,
                timer: Timer | None = None) -> np.ndarray:
    """Score a batch of queries against one index.

    Returns int32 [B, counts_size] in document order (page-major,
    page-local doc id = word*32 + bit), matching the reference's 8-aligned
    score layout (reference: cobs/query/classic_search.cpp:413-429).
    """
    pending = score_batch_async(index, payload, timer)
    if timer:
        timer.active("add rows")
    out = pending.fetch()
    if timer:
        timer.stop()
    return out


def _strip_word_padding(scores: np.ndarray, B: int,
                        lay: DocLayout) -> np.ndarray:
    """Device [B, P*W*32] scores -> the public int32 [B, counts_size]
    contract (drops per-page word padding and, on run-coalesced indexes,
    each merged page's phantom tail beyond its real doc count)."""
    scores = scores.astype(np.int32, copy=False)
    P, w32 = lay.num_pages, lay.w32
    dpp = lay.uniform_docs
    if P == 1:
        return scores[:, :int(lay.page_docs[0])]
    if dpp is not None:
        return (scores.reshape(B, P, w32)[:, :, :dpp]
                .reshape(B, P * dpp))
    pages = scores.reshape(B, P, w32)
    return np.concatenate(
        [pages[:, p, :int(lay.page_docs[p])] for p in range(P)],
        axis=1)


def _slot_doc_numbers(idx: np.ndarray, lay: DocLayout) -> np.ndarray:
    """Flat padded score-slot ids -> global document numbers (the
    page-major numbering of score_batch's output)."""
    idx = idx.astype(np.int64, copy=False)
    page, local = idx // lay.w32, idx % lay.w32
    dpp = lay.uniform_docs
    if dpp is not None:
        return page * dpp + local
    return lay.doc_offsets[page] + local


def _doc_valid_mask(lay: DocLayout, n_files: int) -> np.ndarray:
    """bool [P*W*32]: True for score slots of real documents (excludes
    per-page word padding, each merged page's phantom tail on
    run-coalesced indexes, and 8-alignment slots beyond the file count)."""
    W32 = lay.w32
    slots = np.arange(lay.num_pages * W32)
    page, local = slots // W32, slots % W32
    doc_number = lay.doc_offsets[page] + local
    return (local < lay.page_docs[page]) & (doc_number < n_files)


_SLOT_MASK = (1 << 32) - 1


def topk_slots(scores: torch.Tensor, valid_mask: torch.Tensor,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top k of int32 [B, S] scores with invalid slots forced to -1, in
    (score desc, slot asc) order: (scores int64 [B, k], slots int64
    [B, k]).

    torch.topk keeps no tie order, so it ranks the key
    (score + 1) << 32 | (2^32 - 1 - slot), unique per slot, which orders
    exactly as lax.top_k's prefer-lower-index rule in cobs_tpu."""
    if scores.shape[1] > _SLOT_MASK:
        raise ValueError("too many score slots for the int64 top-k key")
    masked = torch.where(valid_mask, scores, -1).long()
    slot = torch.arange(scores.shape[1], device=scores.device)
    key = ((masked + 1) << 32) | (_SLOT_MASK - slot)
    top = torch.topk(key, k, dim=1).values
    return (top >> 32) - 1, _SLOT_MASK - (top & _SLOT_MASK)


def score_topk_async(index: DeviceIndex, payload, k: int,
                     timer: Timer | None = None) -> PendingTopK:
    """Enqueue top-k scoring without waiting for the device; fetch()
    gives the score_topk contract."""
    return score_topk_multi_async(index, [payload], k, timer)[0]


def score_topk(index: DeviceIndex, payload, k: int,
               timer: Timer | None = None):
    """Top-k scoring: only [B, k] (score, document) pairs leave the
    device instead of the full per-document score vector.

    Ties order by (score desc, doc asc), the reference's result order
    (reference: cobs/query/classic_search.cpp:140-144). Padding slots
    (page word padding and 8-alignment beyond the real document count)
    are masked to -1 so they sort last; callers must drop negative
    scores.

    Returns (scores i32 [B, k'], doc_numbers i64 [B, k']) with
    k' = min(k, P*W*32), doc numbers in score_batch's slot numbering.
    """
    pending = score_topk_async(index, payload, k, timer)
    if timer:
        timer.active("io")
    out = pending.fetch()
    if timer:
        timer.stop()
    return out


#: host staging buffers per streamed index: search_stream keeps two
#: batches dispatched (search._DEPTH) while it gathers the next, so a
#: third buffer is free for that one; a buffer is refilled only after the
#: event behind its upload has completed, so any count is correct
STAGING_BUFFERS = 3


class _StagingRing:
    """Host buffers int32 [rows, W] that the streamed backend gathers a
    batch's rows into before their upload: pinned when the index's
    device is CUDA (a non-blocking copy from pinned memory is a true
    async DMA), plain on the CPU (CPU-only torch cannot pin). Each grows
    when a batch needs more rows. Bytes past a row's payload are zero
    from the allocation and are never written."""

    def __init__(self, count: int, words: int, pin: bool):
        self._bufs = [None] * max(1, count)
        self._events = [None] * len(self._bufs)
        self._next = 0
        self._words = words
        self._pin = pin

    def take(self, rows: int) -> tuple[int, torch.Tensor]:
        """(slot, buffer of >= rows rows) once the buffer's last upload
        has completed."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        buf = self._bufs[i]
        if buf is None or buf.shape[0] < rows:
            self._bufs[i] = buf = torch.zeros(
                (rows + rows // 4, self._words), dtype=torch.int32,
                pin_memory=self._pin)
        return i, buf

    def uploaded(self, slot: int, event) -> None:
        """Record the event behind the upload from buffer `slot`."""
        self._events[slot] = event


class StreamedIndex(_PageLayout):
    """Host-resident (memory-mapped) index backend.

    The port of cobs_tpu's StreamedIndex, the analog of the reference's
    mmap search files (reference: cobs/query/classic_index/
    mmap_search_file.cpp:27-40, compact_index/mmap_search_file.cpp:
    34-67): the payload stays on disk and only the Bloom rows a batch
    touches are read, through the OS page cache, so indexes larger than
    device memory stay queryable. Pages are not coalesced: one padded
    page row per page, as in cobs_tpu, so padded score tensors match.

    Two scoring modes (settings.streamed_host_score):

    - device: the batch's row ids (hashed on the device, or on the host
      when the ids exceed int32 or settings.device_hash is "host") are
      reduced to their unique ids on the device; only those cross to the
      host, which gathers the rows into a staging buffer
      int32 [U + 1, W] (row U is zero: the zero row sorts last) and
      uploads it; the gather-and-count kernel then scores the batch
      against the buffer through the inverse ids. One wait per batch.
    - host: the native host scorer gathers, ANDs and counts straight off
      the mmap on a worker thread, with no device work at all.

    drop_cache=True is cold-cache serving, the analog of the reference's
    O_DIRECT AIO backend (reference: cobs/query/compact_index/
    aio_search_file.cpp:23-97): rows are read with io_uring and
    RWF_DONTCACHE, and where the kernel lacks that flag (or io_uring)
    the index's pages are evicted after every batch (posix_fadvise
    DONTNEED).
    """

    def __init__(self, path, device=None, drop_cache: bool = False):
        self.path = path = str(path)
        self.device = resolve_device(device)
        self._drop_cache = drop_cache
        self.page_docs = None
        if fmt_classic.is_classic_file(path):
            with open(path, "rb") as f:
                h = fmt_classic.ClassicIndexHeader.deserialize(f)
                off = f.tell()
            sig_sizes = [h.signature_size]
            self.num_hashes = h.num_hashes
            self.page_size = h.row_size
        elif fmt_compact.is_compact_file(path):
            h, off = fmt_compact.read_compact_header(path)
            if not h.parameters:
                raise FileIOError("compact index has no pages")
            self.num_hashes = h.parameters[0].num_hashes
            if any(p.num_hashes != self.num_hashes for p in h.parameters):
                raise FileIOError("compact index with non-uniform "
                                  "num_hashes unsupported")
            sig_sizes = [p.signature_size for p in h.parameters]
            self.page_size = h.page_size
        else:
            raise FileIOError(f'Could not open index path "{path}"')
        self.term_size = h.term_size
        self.canonicalize = h.canonicalize
        self.file_names = h.file_names
        self._payload_off = off
        self.sig_sizes = np.asarray(sig_sizes, dtype=np.uint64)
        self.row_offsets = np.zeros(len(sig_sizes), dtype=np.int64)
        np.cumsum(np.asarray(sig_sizes[:-1], dtype=np.int64),
                  out=self.row_offsets[1:])
        self.total_rows = int(sum(sig_sizes))
        self.word_width = _pad_words(-(-self.page_size // 4))
        # one contiguous view over all pages (back to back in the file,
        # one row stride), indexed by global row ids; and one per page
        self._payload = np.memmap(path, dtype=np.uint8, mode="r",
                                  offset=off,
                                  shape=(self.total_rows, self.page_size))
        self._mms = [self._payload[o:o + int(n)]
                     for o, n in zip(self.row_offsets, sig_sizes)]
        self._ring = _StagingRing(STAGING_BUFFERS, self.word_width,
                                  self.device.type == "cuda")
        self._host_pool = None
        #: batches, unique rows and bytes uploaded by the device mode
        self.uploaded_batches = self.uploaded_rows = self.uploaded_bytes = 0

    @property
    def zero_row(self) -> int:
        """The virtual all-zero row: the id padding terms carry."""
        return self.total_rows

    def row_indices(self, hashes: np.ndarray) -> np.ndarray:
        """uint64 hashes [T, h] -> global row ids int64 [T, h, P]."""
        return (hashes[:, :, None] % self.sig_sizes[None, None, :]
                + self.row_offsets[None, None, :].astype(np.uint64)) \
            .astype(np.int64)

    def scores_on_host(self) -> bool:
        """Whether batches score in the native host scorer
        (settings.streamed_host_score: "host", "device", or "auto" =
        "device" on a CUDA index, else "host")."""
        mode = str(settings.streamed_host_score).lower()
        if mode in ("host", "1", "true"):
            return True
        if mode in ("device", "0", "false"):
            return False
        if mode == "auto":
            return self.device.type != "cuda"
        raise ValueError(f"settings.streamed_host_score must be auto, "
                         f"device or host, got {mode!r}")

    def drop_cache(self) -> None:
        """Evict this index's file from the OS page cache (no root
        needed, unlike the reference's /proc/sys/vm/drop_caches,
        reference: src/cobs.cpp:616-620); the next access reads disk."""
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)

    def _after_score(self):
        """The per-batch eviction of cold mode, or None. RWF_DONTCACHE
        reads never fill the cache, so there is nothing to evict when
        they worked; the mmap gather (no io_uring, or no flag) needs
        it."""
        if not self._drop_cache:
            return None

        def evict():
            if not native.dontcache_supported():
                self.drop_cache()

        return evict

    def _gather(self, rows: np.ndarray, out: np.ndarray) -> None:
        """out[i, :row_bytes] = payload row rows[i]: io_uring with
        RWF_DONTCACHE in cold mode where io_uring works, else the
        threaded copy from the mmap."""
        if self._drop_cache and native.gather_rows_file(
                self.path, self._payload_off, self.page_size, rows, out,
                dontcache=True):
            return
        native.gather_rows(self._payload, self.page_size, rows, out,
                           settings.threads)

    def stage(self, payload, timer: Timer | None = None):
        """The device mode's host half for one batch (QueryBytes or
        per-query host hashes): row ids, their unique ids on the device,
        the host gather of those rows and their upload. Returns (matrix
        int32 [U + 1, W] on the device, its last row zero; row ids int32
        [B, T, h, P] into it): the gather-and-count kernel's inputs."""
        if timer:
            timer.active("io")
        if isinstance(payload, QueryBytes):
            ids = _device_rows(self, payload)
        else:
            ids = _upload(_host_rows(self, payload, np.int64), self.device)
        uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
        uniq = uniq.cpu().numpy()   # the one wait of the batch
        # the zero row is the largest id: when present it sorts last and
        # its inverse id n is the buffer's zero row
        n = uniq.size - int(uniq[-1] == self.zero_row)
        slot, buf = self._ring.take(n + 1)
        if n:
            self._gather(uniq[:n].astype(np.int64),
                         buf.numpy().view(np.uint8)[:n])
        buf[n] = 0
        staged = buf[:n + 1]
        if self.device.type == "cuda":
            gmat = staged.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._ring.uploaded(slot, event)
        else:
            gmat = staged.clone()
        self.uploaded_batches += 1
        self.uploaded_rows += n
        self.uploaded_bytes += staged.numel() * 4
        return gmat, inv.to(torch.int32)

    def _device_scores(self, payload, timer: Timer | None) -> torch.Tensor:
        """int32 [B, P*W*32] padded-slot scores on the device (the device
        mode): `stage`, then the gather-and-count kernel."""
        gmat, rows = self.stage(payload, timer)
        if timer:
            timer.active("and rows")
        scores = gather_and_count(gmat, rows, self.num_hashes)
        if timer:
            timer.stop()
        return scores

    def _host_scores(self, hashes_list, timer: Timer | None) -> np.ndarray:
        """int32 [B, counts_size] from the native host scorer (the host
        mode). Cold mode first pulls the batch's unique rows with
        io_uring into a compact buffer and scores from it."""
        if isinstance(hashes_list, QueryBytes):
            raise TypeError("host scoring takes per-query host hashes "
                            "(Search hashes on the host for it)")
        rows = _host_rows(self, hashes_list, np.int64)
        payload, zero = self._payload, self.zero_row
        if self._drop_cache:
            if timer:
                timer.active("io")
            uniq, inv = np.unique(rows, return_inverse=True)
            n = int(np.searchsorted(uniq, self.zero_row))
            buf = np.zeros((n + 1, self.page_size), dtype=np.uint8)
            if native.gather_rows_file(self.path, self._payload_off,
                                       self.page_size, uniq[:n], buf[:n],
                                       dontcache=True):
                # uniq is sorted, so a padding id maps to n: the zero row
                payload, rows, zero = buf, inv.reshape(rows.shape), n
        if timer:
            timer.active("and rows")
        scores = native.score_batch_host(payload, self.page_size, rows,
                                         zero, settings.threads)
        if timer:
            timer.stop()
        return scores

    def _host_topk(self, scores: np.ndarray, k: int):
        """Host top-k with the engine contract: the key (score desc, doc
        asc) orders as topk_slots does; -1 pads past the doc count."""
        B = scores.shape[0]
        n = len(self.file_names)
        kk = min(k, n)
        s = scores[:, :n].astype(np.int64)
        key = s * n - np.arange(n, dtype=np.int64)[None, :]
        if kk < n:
            cand = np.argpartition(-key, kk - 1, axis=1)[:, :kk]
        else:
            cand = np.broadcast_to(np.arange(n), (B, n)).copy()
        order = np.argsort(-np.take_along_axis(key, cand, axis=1),
                           axis=1, kind="stable")
        sel = np.take_along_axis(cand, order, axis=1)
        vals = np.full((B, k), -1, dtype=np.int32)
        docs = np.zeros((B, k), dtype=np.int64)
        vals[:, :kk] = np.take_along_axis(s, sel, axis=1)
        docs[:, :kk] = sel
        return vals, docs

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        """The one worker of host scoring: the native scorer is threaded
        itself; one worker keeps batches in order and bounds memory."""
        if self._host_pool is None:
            self._host_pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="cobs-host-score")
        return self._host_pool

    def score_batch_async(self, payload, timer: Timer | None = None):
        """Dispatch a batch (QueryBytes or per-query host hashes) without
        waiting; fetch() gives the score_batch contract."""
        if self.scores_on_host():
            wt = Timer()
            return PendingHost(self._pool().submit(self._host_scores,
                                                   payload, wt),
                               self._after_score(), wt, timer)
        scores = self._device_scores(payload, timer)
        return PendingScores(_SharedFetch(scores), 0, len(payload),
                             self.doc_layout, self._after_score())

    def score_topk_async(self, payload, k: int, timer: Timer | None = None):
        """Dispatch top-k scoring without waiting; fetch() gives the
        score_topk contract."""
        if self.scores_on_host():
            wt = Timer()

            def work():
                return self._host_topk(self._host_scores(payload, wt), k)

            return PendingHost(self._pool().submit(work),
                               self._after_score(), wt, timer)
        scores = self._device_scores(payload, timer)
        vals, slots = topk_slots(scores, self.valid_mask,
                                 min(k, scores.shape[1]))
        return PendingTopK(_SharedFetch(torch.stack((vals, slots))), 0,
                           len(payload), self.doc_layout,
                           self._after_score())

    def score_batch(self, payload, timer: Timer | None = None) -> np.ndarray:
        """int32 [B, counts_size]: the score_batch contract."""
        pending = self.score_batch_async(payload, timer)
        if timer:
            timer.active("add rows")
        out = pending.fetch()
        if timer:
            timer.stop()
        return out

    def score_topk(self, payload, k: int, timer: Timer | None = None):
        """(scores i32 [B, k'], doc_numbers i64 [B, k']): the score_topk
        contract (k' = min(k, P*W*32) on the device, k on the host)."""
        pending = self.score_topk_async(payload, k, timer)
        if timer:
            timer.active("add rows")
        out = pending.fetch()
        if timer:
            timer.stop()
        return out
