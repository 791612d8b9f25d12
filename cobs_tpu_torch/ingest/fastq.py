"""FASTQ parser (reference: cobs/fastq_file.hpp).

4-line record cycle: '@' header, sequence, '+' separator, quality (dropped).
Terms never cross reads. Size histogram cached like FASTA.
"""

import os
import struct

import numpy as np

from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.ingest.util import (STREAM_CHUNK, iter_lines,
                                  sliding_windows)


class FastqFile:
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

    def _check_line(self, line_num, line):
        mod = line_num % 4
        if mod == 0 and (len(line) == 0 or line[0:1] != b"@"):
            raise ValueError(
                f"FastqFile: line {line_num} does not start with @ - "
                f"{self.path}")
        if mod == 2 and (len(line) == 0 or line[0:1] != b"+"):
            raise ValueError(
                f"FastqFile: line {line_num} does not start with + - "
                f"{self.path}")

    def _compute_index(self) -> None:
        self.size_ = 0
        self.sequence_count = 0
        self.size_hist = {}
        for line_num, line in enumerate(iter_lines(self.path)):
            self._check_line(line_num, line)
            self.size_ += len(line) + 1
            if line_num % 4 == 1:
                self.size_hist[len(line)] = \
                    self.size_hist.get(len(line), 0) + 1
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

    def sequences(self):
        for line_num, line in enumerate(iter_lines(self.path)):
            self._check_line(line_num, line)
            if line_num % 4 == 1 and line:
                yield np.frombuffer(line, dtype=np.uint8)

    def term_windows(self, term_size: int, chunk_bytes: int | None = None):
        """Yield [n, term_size] window batches; reads stream one at a
        time (terms never cross reads) and consecutive short reads'
        windows are packed into ~chunk_bytes batches so the downstream
        hash kernels see large batches, not millions of tiny ones."""
        chunk = chunk_bytes or STREAM_CHUNK
        pend: list[np.ndarray] = []
        pend_bytes = 0
        for seq in self.sequences():
            w = sliding_windows(seq, term_size)
            if not w.shape[0]:
                continue
            pend.append(w)
            pend_bytes += w.shape[0] * term_size
            if pend_bytes >= chunk:
                yield (pend[0] if len(pend) == 1
                       else np.concatenate(pend, axis=0))
                pend, pend_bytes = [], 0
        if pend:
            yield (pend[0] if len(pend) == 1
                   else np.concatenate(pend, axis=0))
