"""McCortex (.ctx) v6 binary parser (reference: cobs/cortex_file.hpp).

Streams each stored k-mer (decoded from 2-bit packing) and emits sub-terms
of length term_size. Only single-color files are supported, like the
reference. Decoding is vectorized: all k-mer payload bytes are decoded with
one table lookup.
"""

import os
import struct

import numpy as np

from cobs_tpu_torch.core import kmer as kmer_codec


class CortexFile:
    def __init__(self, path):
        self.path = str(path)
        if not os.path.exists(self.path):
            raise FileNotFoundError(self.path)
        with open(self.path, "rb") as f:
            self._read_header(f)

    def _check_magic(self, f) -> None:
        if f.read(6) != b"CORTEX":
            raise ValueError(
                f"CortexFile: magic number not found @ {self.path}")

    def _read_header(self, f) -> None:
        self._check_magic(f)
        self.version, self.kmer_size, self.num_words_per_kmer, \
            self.num_colors = struct.unpack("<IIII", f.read(16))
        if self.version != 6:
            raise ValueError(f"Invalid .ctx file version ({self.version})")
        if self.num_colors != 1:
            raise ValueError(
                f"Invalid number of colors ({self.num_colors}), must be 1")
        for _ in range(self.num_colors):
            f.read(4 + 8)  # mean read length, total length
        self.name = ""
        for _ in range(self.num_colors):
            name_len = struct.unpack("<I", f.read(4))[0]
            self.name = f.read(name_len).decode(
                "utf-8", errors="surrogateescape")
        f.seek(16 * self.num_colors, os.SEEK_CUR)
        for _ in range(self.num_colors):
            f.seek(12, os.SEEK_CUR)
            graph_name_len = struct.unpack("<I", f.read(4))[0]
            f.seek(graph_name_len, os.SEEK_CUR)
        self._check_magic(f)
        self.pos_data_begin = f.tell()
        f.seek(0, os.SEEK_END)
        self.pos_data_end = f.tell()

    def num_kmers(self) -> int:
        record = 8 * self.num_words_per_kmer + 5 * self.num_colors
        return (self.pos_data_end - self.pos_data_begin) // record

    def num_terms(self, q: int) -> int:
        if self.kmer_size < q:
            return 0
        return self.num_kmers() * (self.kmer_size - q + 1)

    def kmers(self) -> np.ndarray:
        """Decode all stored k-mers to ASCII, [n, kmer_size] uint8."""
        record = 8 * self.num_words_per_kmer + 5 * self.num_colors
        with open(self.path, "rb") as f:
            f.seek(self.pos_data_begin)
            raw = f.read()
        n = len(raw) // record
        rows = np.frombuffer(
            raw[:n * record], dtype=np.uint8).reshape(n, record)
        packed_size = kmer_codec.packed_size(self.kmer_size)
        packed = rows[:, :packed_size]
        return kmer_codec.decode(packed, self.kmer_size)

    def term_windows(self, term_size: int):
        km = self.kmers()
        if km.shape[0] == 0 or self.kmer_size < term_size:
            return
        # windows within each k-mer; vectorized over all k-mers at once
        n = km.shape[0]
        w = np.lib.stride_tricks.sliding_window_view(
            km, term_size, axis=1)  # [n, kmer_size-ts+1, ts]
        yield np.ascontiguousarray(w).reshape(-1, term_size)
