"""Text parser: verbatim byte stream including newlines
(reference: cobs/text_file.hpp)."""

import os

import numpy as np

from cobs_tpu_torch.ingest.util import STREAM_CHUNK, sliding_windows


class TextFile:
    def __init__(self, path):
        self.path = str(path)
        if not os.path.exists(self.path):
            raise FileNotFoundError(self.path)

    def size(self) -> int:
        return os.path.getsize(self.path)

    def num_terms(self, q: int) -> int:
        n = self.size()
        return 0 if n < q else n - q + 1

    def term_windows(self, term_size: int, chunk_bytes: int | None = None):
        """Yield [n, term_size] q-gram batches streamed through a
        bounded buffer with a (q-1)-byte carry — the reference's 64 KiB
        sliding window (reference: cobs/text_file.hpp:45-68) scaled to
        batched hashing."""
        chunk = chunk_bytes or STREAM_CHUNK
        k = term_size
        with open(self.path, "rb") as f:
            carry = b""
            while True:
                data = f.read(chunk)
                if not data:
                    break
                buf = carry + data
                if len(buf) >= k:
                    yield sliding_windows(
                        np.frombuffer(buf, np.uint8), k)
                    carry = buf[len(buf) - (k - 1):]
                else:
                    carry = buf
