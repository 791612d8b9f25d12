"""FASTA parser (one document per file).

Semantics match the reference (reference: cobs/fasta_file.hpp):
- sequences are separated by '>' or ';' header lines or empty lines;
- q-grams cross line boundaries within a sequence but never cross
  sequence boundaries;
- a size histogram of sequences is built once and cached to
  ``<file>.cobs_cache`` (byte-compatible little-endian u64 layout);
- ``size()`` is the total byte count as seen by line iteration
  (sum of line length + 1);
- transparent .gz decompression.
"""

import os
import struct

import numpy as np

from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.ingest.util import (STREAM_CHUNK, iter_lines,
                                  sliding_windows)


class FastaFile:
    def __init__(self, path, use_cache: bool = True):
        self.path = str(path)
        if not os.path.exists(self.path):
            raise FileNotFoundError(self.path)
        self.size_ = 0
        self.sequence_count = 0
        self.size_hist: dict[int, int] = {}
        if not use_cache or settings.disable_cache:
            self._compute_index()
        elif not self._read_cache_file():
            self._compute_index()
            self._write_cache_file()

    def cache_path(self) -> str:
        return self.path + ".cobs_cache"

    def _compute_index(self) -> None:
        self.size_ = 0
        self.sequence_count = 0
        self.size_hist = {}
        seq_size = 0
        first = True
        for line in iter_lines(self.path):
            if first:
                if len(line) == 0 or line[0:1] not in (b">", b";"):
                    raise ValueError(
                        "FastaFile: file does not start with > or ; - "
                        f"{self.path}")
                self.size_ = len(line) + 1
                first = False
                continue
            self.size_ += len(line) + 1
            if len(line) == 0 or line[0:1] in (b">", b";"):
                if seq_size != 0:
                    self.size_hist[seq_size] = self.size_hist.get(
                        seq_size, 0) + 1
                    self.sequence_count += 1
                seq_size = 0
                continue
            seq_size += len(line)
        if seq_size != 0:
            self.size_hist[seq_size] = self.size_hist.get(seq_size, 0) + 1
            self.sequence_count += 1

    def _write_cache_file(self) -> None:
        tmp = self.cache_path() + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(struct.pack("<QQQ", self.size_, self.sequence_count,
                                    len(self.size_hist)))
                for size, count in sorted(self.size_hist.items()):
                    f.write(struct.pack("<QQ", size, count))
            os.replace(tmp, self.cache_path())
        except OSError:
            pass

    def _read_cache_file(self) -> bool:
        try:
            with open(self.cache_path(), "rb") as f:
                self.size_, self.sequence_count, hist_size = struct.unpack(
                    "<QQQ", f.read(24))
                for _ in range(hist_size):
                    size, count = struct.unpack("<QQ", f.read(16))
                    self.size_hist[size] = count
                return f.read(1) == b""
        except (OSError, struct.error):
            return False

    def size(self) -> int:
        return self.size_

    def num_terms(self, q: int) -> int:
        return sum(count * (0 if size < q else size - q + 1)
                   for size, count in self.size_hist.items())

    def term_windows(self, term_size: int, chunk_bytes: int | None = None):
        """Yield [n, term_size] window batches under a fixed memory
        bound: sequences stream through ~chunk_bytes buffers with a
        (k-1)-byte carry, so terms cross line (but never sequence)
        boundaries exactly as in the reference's rolling tail buffer
        (reference: cobs/fasta_file.hpp:156-182)."""
        chunk = chunk_bytes or STREAM_CHUNK
        k = term_size
        buf = bytearray()

        def windows(b):
            return sliding_windows(np.frombuffer(bytes(b), np.uint8), k)

        for line in iter_lines(self.path):
            if len(line) == 0 or line[0:1] in (b">", b";"):
                if len(buf) >= k:
                    yield windows(buf)
                buf = bytearray()
                continue
            buf += line
            if len(buf) >= chunk + k - 1:
                yield windows(buf)
                del buf[:len(buf) - (k - 1)]
        if len(buf) >= k:
            yield windows(buf)
