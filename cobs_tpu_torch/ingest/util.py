"""Shared ingest helpers."""

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
