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
    full buffer is uploaded and scattered into `words` on the stream that
    was current when the ring was made. Not thread-safe: callers on
    several threads hold a lock around `add` and `flush`."""

    def __init__(self, words: torch.Tensor, chunk: int, count: int,
                 timer: Timer | None):
        self.words = words
        self.cuda = words.device.type == "cuda"
        self.stream = (torch.cuda.current_stream(words.device)
                       if self.cuda else None)
        self.chunk = chunk
        self.bufs = [(torch.empty(chunk, dtype=torch.int32,
                                  pin_memory=self.cuda),
                      torch.empty(chunk, dtype=torch.int32,
                                  pin_memory=self.cuda))
                     for _ in range(max(1, count))]
        self.events = [None] * len(self.bufs)
        self.slot = 0
        self.fill = 0
        #: (before upload, after upload, after kernel) events per launch,
        #: kept when a timer is given
        self.marks = [] if timer is not None and self.cuda else None

    def add(self, rows: np.ndarray, doc: int) -> None:
        """Stage the updates (rows[i], doc), uploading full buffers."""
        pos = 0
        while pos < rows.size:
            if self.fill == 0 and self.events[self.slot] is not None:
                self.events[self.slot].synchronize()
                self.events[self.slot] = None
            take = min(self.chunk - self.fill, rows.size - pos)
            r, d = (b.numpy() for b in self.bufs[self.slot])
            r[self.fill:self.fill + take] = rows[pos:pos + take]
            d[self.fill:self.fill + take] = doc
            self.fill += take
            pos += take
            if self.fill == self.chunk:
                self.flush()

    def flush(self) -> None:
        """Upload the current buffer's updates and scatter them."""
        if not self.fill:
            return
        r, d = (b[:self.fill] for b in self.bufs[self.slot])
        if self.cuda:
            stream = self.stream
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(3)] if self.marks is not None else None
            with torch.cuda.stream(stream):
                if marks:
                    marks[0].record(stream)
                r = r.to(self.words.device, non_blocking=True)
                d = d.to(self.words.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
                self.events[self.slot] = event
                if marks:
                    marks[1].record(stream)
                construct_scatter(self.words, r, d)
                if marks:
                    marks[2].record(stream)
                    self.marks.append(marks)
        else:
            construct_scatter(self.words, r, d)
        self.slot = (self.slot + 1) % len(self.bufs)
        self.fill = 0

    def device_ms(self) -> tuple[float, float]:
        """(upload ms, kernel ms) summed over the launches; call after the
        stream has finished them."""
        if not self.marks:
            return 0.0, 0.0
        return (sum(a.elapsed_time(b) for a, b, _ in self.marks),
                sum(b.elapsed_time(c) for _, b, c in self.marks))


def build_batch_matrix_device(entries, signature_size: int, row_size: int,
                              term_size: int, num_hashes: int,
                              canonicalize: int, warn, device=None,
                              timer: Timer | None = None,
                              chunk: int = UPDATE_CHUNK) -> np.ndarray:
    """The bit matrix of one batch of documents, scattered on `device`
    (None = settings.device; raises when CUDA is asked for and absent).

    Same contract and bytes as bitmatrix.build_batch_matrix (reference
    pipeline being matched: cobs/construction/classic_index.cpp:36-189).
    `timer`, when given, gets the host phases "read+hash" and "stage"
    (summed over the workers) and "fetch", and on a CUDA device the
    device time of the uploads ("device_upload") and of the kernel
    launches ("device_kernel"). Returns uint8 [signature_size,
    row_size]."""
    if signature_size + 1 > np.iinfo(np.int32).max:
        raise ValueError("signature too large for device construction")
    dev = resolve_device(device)
    Wc = max(1, -(-row_size // 4))
    words = torch.zeros((Wc, signature_size + 1), dtype=torch.int32,
                        device=dev)
    ring = _UpdateRing(words, chunk, UPLOAD_BUFFERS, timer)

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
    # one transpose on the device to [signature_size, Wc] rows, then the
    # pad bytes past row_size cut there too; the words are freed before
    # the cut, so the device holds at most twice the words
    rows = torch.empty((signature_size, Wc), dtype=torch.int32,
                       device=dev).copy_(words[:, :signature_size].t())
    ring.words = words = None
    data = rows.view(torch.uint8)[:, :row_size].contiguous().cpu().numpy()
    t.stop()
    if timer is not None:
        timer.merge(t)
        if ring.cuda:
            upload_ms, kernel_ms = ring.device_ms()
            timer.add("device_upload", upload_ms / 1e3)
            timer.add("device_kernel", kernel_ms / 1e3)
    return data
