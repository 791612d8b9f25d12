"""Classic-index construction of one batch with the bit scatter on a torch
device.

The port of `cobs_tpu/construct/device.py::build_batch_matrix_device` for
one device. Documents are read and hashed on the host by the native
library (`bitmatrix.doc_row_indices`, threaded inside each document) on
settings.threads workers, one document per worker at a time. Each worker
stages its (row, document) updates, cast to int32, into a ring of pinned
buffers under a lock; a full buffer is uploaded and
`ops/construct_scatter.py` sets its bits into the batch's packed word
matrix on the device, held word-major: int32 [ceil(docs / 32),
signature_size + 1], strip c holding word c (documents 32c .. 32c + 31)
of every row, the last row a scratch row as in the JAX package. Documents
are staged in index order, so one upload's updates fall in one or two
strips, which the L2 holds while the kernel's atomics land. At fetch the
first signature_size rows are transposed once on the device to the
file's row-major layout (the copy briefly doubles the words: 359 MB more
for a batch of 1,000 documents at 2.8 M rows, far under the eight times
the words that `classic.py`'s batch rule reserves for cobs_tpu's u8
plane), and row_size bytes of each row are cut there before the fetch.
OR commutes, so the bytes equal the host scatter's
(`bitmatrix.build_batch_matrix`) whatever the chunking and the order in
which workers stage. On a CPU device the scatter is the kernel's plain
version.

On a mesh (`mesh`, cobs_tpu's `_make_scatter_sharded`) the documents
are cut over the "docs" axis as the query side cuts them: the batch's
words are padded to 32 x n_docs documents and docs shard d holds strips
[d Wl, (d + 1) Wl) as its own word-major int32 [Wl, signature_size + 1]
on the device of its column's first cell. Each upload goes once to each
distinct device, and the scatter runs on every shard with the documents
shifted by the shard's base, d x 32 Wl. The kernel drops documents
outside its [0, 32 Wl), so foreign updates need no routing (cobs_tpu
sends them to the scratch row, which here would pile most of every chunk
onto one word). At fetch the shards' strips are concatenated in docs
order, then transposed and cut as on one device: the bytes are the same.
"""

import concurrent.futures
import threading

import numpy as np
import torch

from cobs_tpu_torch.construct.bitmatrix import (
    doc_row_indices,
    invalid_dna_warning,
)
from cobs_tpu_torch.ops.construct_scatter import construct_scatter
from cobs_tpu_torch.query.engine import resolve_device
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.timer import Timer

#: updates per upload and kernel launch (32 MB of rows and documents)
UPDATE_CHUNK = 1 << 22
#: pinned upload buffers: the host fills one while earlier ones upload; a
#: buffer is refilled only after the CUDA event behind its upload, so any
#: count is correct
UPLOAD_BUFFERS = 3


class _UpdateRing:
    """Host buffers of (rows, docs) int32 [chunk] that updates are staged
    in before their upload: pinned on a CUDA device (a non-blocking copy
    from pinned memory is a true asynchronous DMA), plain on the CPU. A
    full buffer is uploaded once to each device of `shards` and scattered
    into each shard, (words, d0) with the documents shifted by -d0, on
    the stream that was current on its device when the ring was made.
    Not thread-safe: callers on several threads hold a lock around `add`
    and `flush`."""

    def __init__(self, shards: list, chunk: int, count: int,
                 timer: Timer | None):
        self.shards = shards
        self.devices = list(dict.fromkeys(w.device for w, _ in shards))
        self.cuda = self.devices[0].type == "cuda"
        self.streams = {dev: torch.cuda.current_stream(dev)
                        for dev in self.devices} if self.cuda else {}
        self.chunk = chunk
        self.bufs = [(torch.empty(chunk, dtype=torch.int32,
                                  pin_memory=self.cuda),
                      torch.empty(chunk, dtype=torch.int32,
                                  pin_memory=self.cuda))
                     for _ in range(max(1, count))]
        self.events = [[] for _ in self.bufs]
        self.slot = 0
        self.fill = 0
        #: (before upload, after upload, after kernels) events per device
        #: per flush, kept when a timer is given
        self.marks = [] if timer is not None and self.cuda else None

    def add(self, rows: np.ndarray, doc: int) -> None:
        """Stage the updates (rows[i], doc), uploading full buffers."""
        pos = 0
        while pos < rows.size:
            if self.fill == 0 and self.events[self.slot]:
                for event in self.events[self.slot]:
                    event.synchronize()
                self.events[self.slot] = []
            take = min(self.chunk - self.fill, rows.size - pos)
            r, d = (b.numpy() for b in self.bufs[self.slot])
            r[self.fill:self.fill + take] = rows[pos:pos + take]
            d[self.fill:self.fill + take] = doc
            self.fill += take
            pos += take
            if self.fill == self.chunk:
                self.flush()

    def _scatter(self, dev, r: torch.Tensor, d: torch.Tensor) -> None:
        """Scatter uploaded updates into every shard on `dev`."""
        for words, d0 in self.shards:
            if words.device == dev:
                construct_scatter(words, r, d - d0 if d0 else d)

    def flush(self) -> None:
        """Upload the current buffer's updates and scatter them."""
        if not self.fill:
            return
        r, d = (b[:self.fill] for b in self.bufs[self.slot])
        if self.cuda:
            for dev in self.devices:
                stream = self.streams[dev]
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)] if self.marks is not None \
                    else None
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    if marks:
                        marks[0].record(stream)
                    rd = r.to(dev, non_blocking=True)
                    dd = d.to(dev, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
                    self.events[self.slot].append(event)
                    if marks:
                        marks[1].record(stream)
                    self._scatter(dev, rd, dd)
                    if marks:
                        marks[2].record(stream)
                        self.marks.append(marks)
        else:
            self._scatter(self.devices[0], r, d)
        self.slot = (self.slot + 1) % len(self.bufs)
        self.fill = 0

    def device_ms(self) -> tuple[float, float]:
        """(upload ms, kernel ms) summed over the launches; call after the
        streams have finished them."""
        if not self.marks:
            return 0.0, 0.0
        return (sum(a.elapsed_time(b) for a, b, _ in self.marks),
                sum(b.elapsed_time(c) for _, b, c in self.marks))


def build_batch_matrix_device(entries, signature_size: int, row_size: int,
                              term_size: int, num_hashes: int,
                              canonicalize: int, warn, device=None,
                              timer: Timer | None = None,
                              chunk: int = UPDATE_CHUNK,
                              mesh=None) -> np.ndarray:
    """The bit matrix of one batch of documents, scattered on `device`
    (None = settings.device; raises when CUDA is asked for and absent),
    or over the docs shards of `mesh` (a single-process
    parallel.sharded.Mesh; `device` is then unused).

    Same contract and bytes as bitmatrix.build_batch_matrix (reference
    pipeline being matched: cobs/construction/classic_index.cpp:36-189).
    `timer`, when given, gets the host phases "read+hash" and "stage"
    (summed over the workers) and "fetch", and on a CUDA device the
    device time of the uploads ("device_upload") and of the kernel
    launches ("device_kernel"). Returns uint8 [signature_size,
    row_size]."""
    if signature_size + 1 > np.iinfo(np.int32).max:
        raise ValueError("signature too large for device construction")
    R1 = signature_size + 1
    if mesh is None:
        shards = [(torch.zeros((max(1, -(-row_size // 4)), R1),
                               dtype=torch.int32,
                               device=resolve_device(device)), 0)]
    else:
        if mesh.ranks is not None:
            raise ValueError("device construction takes a mesh of one "
                             "process (parallel.distributed.construct "
                             "builds one index per process)")
        n_docs = mesh.shape["docs"]
        Wl = -(-max(row_size * 8, 1) // (32 * n_docs))
        shards = [(torch.zeros((Wl, R1), dtype=torch.int32,
                               device=mesh.devices[0][d]), d * 32 * Wl)
                  for d in range(n_docs)]
    ring = _UpdateRing(shards, chunk, UPLOAD_BUFFERS, timer)

    lock = threading.Lock()

    def do_doc(doc_index: int) -> bool:
        """Hash and stage one document; True when it held a letter other
        than ACGT."""
        t = Timer()
        invalid = False
        t.active("read+hash")
        for windows in entries[doc_index].term_windows(term_size):
            rows, good = doc_row_indices(
                windows, signature_size, num_hashes, canonicalize)
            invalid |= not good
            t.active("stage")
            with lock:
                ring.add(rows, doc_index)
            t.active("read+hash")
        t.stop()
        if timer is not None:
            timer.merge(t)
        return invalid

    workers = max(1, settings.threads)
    if workers > 1 and len(entries) > 1:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            invalid = list(pool.map(do_doc, range(len(entries))))
    else:
        invalid = [do_doc(i) for i in range(len(entries))]
    for entry, bad in zip(entries, invalid):
        if bad:
            warn(invalid_dna_warning(entry.path))

    t = Timer()
    t.active("stage")
    ring.flush()
    t.active("fetch")
    # the shards' strips in docs order (on the first shard's device), one
    # transpose there to [signature_size, Wc] rows, then the pad bytes
    # past row_size cut there too; the words are freed before the cut, so
    # the device holds at most twice the words
    words = [w for w, _ in shards]
    ring.shards = shards = None
    dev = words[0].device
    words = words[0] if len(words) == 1 else torch.cat(
        [w.to(dev) for w in words])
    rows = torch.empty((signature_size, words.shape[0]), dtype=torch.int32,
                       device=dev).copy_(words[:, :signature_size].t())
    words = None
    data = rows.view(torch.uint8)[:, :row_size].contiguous().cpu().numpy()
    t.stop()
    if timer is not None:
        timer.merge(t)
        if ring.cuda:
            upload_ms, kernel_ms = ring.device_ms()
            timer.add("device_upload", upload_ms / 1e3)
            timer.add("device_kernel", kernel_ms / 1e3)
    return data
