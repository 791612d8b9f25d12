"""Multi-FASTA parser: each '>'-sequence is its own sub-document
(reference: cobs/fasta_multifile.hpp).

Byte offsets of each sub-document are cached to ``<file>.cobs_cache``
(byte-compatible layout: u64 count, then per sub-document u64 size,
u64 pos_begin, name + '\\0') and in a process-wide in-memory cache.
"""

import collections
import os
import struct
import threading

import numpy as np

from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.ingest.util import sliding_windows

#: process-wide index cache: path -> (stat signature, subdoc list)
_INDEX_CACHE: dict[str, tuple[tuple, list[tuple[str, int, int]]]] = {}

#: per-thread LRU of open file handles — a construction pass over a
#: 10k-sub-document .mfasta seeks within one handle instead of paying
#: 10k opens (reference: cobs/fasta_multifile.hpp:91-141,
#: ThreadObjectArray + ifstream LRU). Keyed on (path, inode, mtime) so
#: a file rewritten at the same path reopens instead of reading the
#: stale old inode; stale entries for a path are closed eagerly.
_LOCAL = threading.local()
_MAX_HANDLES = 64


def _stat_sig(path: str) -> tuple:
    st = os.stat(path)
    return (st.st_ino, st.st_mtime_ns, st.st_size)


def _thread_handle(path: str):
    cache = getattr(_LOCAL, "handles", None)
    if cache is None:
        cache = _LOCAL.handles = collections.OrderedDict()
    key = (path, _stat_sig(path))
    f = cache.get(key)
    if f is not None and not f.closed:
        cache.move_to_end(key)
        return f
    for k in [k for k in cache if k[0] == path]:
        cache.pop(k).close()   # same path, older inode/mtime
    f = open(path, "rb")
    cache[key] = f
    if len(cache) > _MAX_HANDLES:
        _, old = cache.popitem(last=False)
        old.close()
    return f


class FastaMultifile:
    def __init__(self, path, use_cache: bool = True):
        self.path = str(path)
        with open(self.path, "rb") as f:
            first = f.read(1)
        if first not in (b">", b";"):
            raise ValueError(
                f"FastaMultifile: file does not start with > or ; - "
                f"{self.path}")
        if not use_cache or settings.disable_cache:
            self.index = self._compute_index()
            return
        sig = _stat_sig(self.path)
        cached = _INDEX_CACHE.get(self.path)
        if cached is not None and cached[0] == sig:
            self.index = cached[1]
        else:
            idx = self._read_cache_file()
            if idx is None:
                idx = self._compute_index()
                self._write_cache_file(idx)
            self.index = idx
            _INDEX_CACHE[self.path] = (sig, idx)

    def cache_path(self) -> str:
        return self.path + ".cobs_cache"

    def _compute_index(self) -> list[tuple[str, int, int]]:
        index = []
        with open(self.path, "rb") as f:
            line = f.readline()
            while line:
                if line.startswith(b">"):
                    name = line.rstrip(b"\n").decode(
                        "utf-8", errors="surrogateescape")[:16]
                    pos_begin = f.tell()
                    size = 0
                    line = f.readline()
                    while line and not line.startswith((b">", b";")):
                        size += len(line.rstrip(b"\n"))
                        line = f.readline()
                    index.append((name, pos_begin, size))
                else:
                    line = f.readline()
        return index

    def _write_cache_file(self, index) -> None:
        tmp = self.cache_path() + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(struct.pack("<Q", len(index)))
                for name, pos_begin, size in index:
                    f.write(struct.pack("<QQ", size, pos_begin))
                    f.write(name.encode(
                        "utf-8", errors="surrogateescape") + b"\0")
            os.replace(tmp, self.cache_path())
        except OSError:
            pass

    def _read_cache_file(self):
        try:
            with open(self.cache_path(), "rb") as f:
                count = struct.unpack("<Q", f.read(8))[0]
                index = []
                for _ in range(count):
                    size, pos_begin = struct.unpack("<QQ", f.read(16))
                    name = bytearray()
                    while True:
                        c = f.read(1)
                        if not c or c == b"\0":
                            break
                        name += c
                    index.append((name.decode(
                        "utf-8", errors="surrogateescape"), pos_begin, size))
                return index if f.read(1) == b"" else None
        except (OSError, struct.error):
            return None

    def num_documents(self) -> int:
        return len(self.index)

    def size(self, doc_index: int) -> int:
        if doc_index >= len(self.index):
            return 0
        return self.index[doc_index][2]

    def subdoc_sequence(self, doc_index: int) -> np.ndarray:
        """Concatenated sequence bytes of one sub-document (read via
        the per-thread handle LRU; reference:
        cobs/fasta_multifile.hpp:41-64)."""
        if doc_index >= len(self.index):
            return np.empty(0, dtype=np.uint8)
        _, pos_begin, _ = self.index[doc_index]
        parts = []
        f = _thread_handle(self.path)
        f.seek(pos_begin)
        for line in f:
            if line.startswith((b">", b";")):
                break
            parts.append(line.rstrip(b"\n"))
        return np.frombuffer(b"".join(parts), dtype=np.uint8)

    def term_windows(self, doc_index: int, term_size: int):
        w = sliding_windows(self.subdoc_sequence(doc_index), term_size)
        if w.shape[0]:
            yield w
