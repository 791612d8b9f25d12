"""Shared ingest helpers."""

import gzip
import io
from pathlib import Path

import numpy as np


def sliding_windows(seq: np.ndarray, k: int) -> np.ndarray:
    """All length-k windows of a byte sequence as a [n-k+1, k] view.

    Zero-copy stride trick; the batched replacement for the reference's
    per-position term callbacks.
    """
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.size
    if n < k:
        return np.empty((0, k), dtype=np.uint8)
    return np.lib.stride_tricks.sliding_window_view(seq, k)


def open_maybe_gzip(path) -> io.BufferedIOBase:
    """Open a file, transparently decompressing .gz."""
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


#: bytes of sequence data per streamed term-window batch; parsers carry
#: the (k-1)-byte window tail across batches, so documents of any size
#: are ingested under a fixed memory bound (the reference's bounded
#: sliding buffers, reference: cobs/fasta_file.hpp:156-182,
#: text_file.hpp:45-68 — scaled up from 64 KiB to amortize the batched
#: hash-kernel calls)
STREAM_CHUNK = 4 << 20

#: read granularity of the streaming line iterator
_READ_CHUNK = 1 << 20


def iter_lines(path):
    """Stream lines like repeated std::getline: '\\n'-separated, the
    terminator not included; a trailing newline does not produce an
    empty final line. '\\r' is NOT stripped (matches the reference
    parsers). Reads in bounded chunks — a 100 GB document never lives
    in memory whole."""
    with open_maybe_gzip(path) as f:
        tail = b""
        while True:
            chunk = f.read(_READ_CHUNK)
            if not chunk:
                break
            parts = (tail + chunk).split(b"\n")
            tail = parts.pop()
            yield from parts
        if tail:
            yield tail


def read_lines(path) -> list[bytes]:
    """All lines of a (small) file; see iter_lines for the semantics."""
    return list(iter_lines(path))


def base_name(path) -> str:
    """File name with ALL extensions stripped
    (reference: cobs/util/file.hpp:69-76)."""
    name = Path(path).name
    pos = name.find(".")
    return name if pos < 0 else name[:pos]


def pad_index(index: int, size: int = 6) -> str:
    return f"{index:0{size}d}"
