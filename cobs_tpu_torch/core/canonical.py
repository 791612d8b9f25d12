"""Vectorized DNA k-mer canonicalization.

Replicates the reference's byte-level canonicalization semantics exactly
(reference: cobs/util/query.cpp:143-199):

- Non-ACGT letters map to 0 in both the forward and reverse-complement maps
  and make the k-mer "not good"; the zero-mapped bytes are still emitted
  (construction indexes them with a warning; query rejects them).
- The forward-mapped k-mer ``fm`` and reverse-complement ``rm`` are compared
  position by position, but ONLY over the first floor(k/2) positions; at the
  first difference the smaller side wins (whole string). If the first half
  ties, the FORWARD k-mer is kept even when the middle character of an
  odd-length k-mer would make the reverse complement smaller — this
  truncated comparison is part of the observable format semantics and is
  reproduced bit-for-bit.

Implemented as a batch kernel over all sliding windows of a sequence at
once: O(n*k) table lookups + one argmax, no per-window Python loop.
"""

import numpy as np

#: forward map: ACGT -> themselves, everything else -> 0
FORWARD_MAP = np.zeros(256, dtype=np.uint8)
for _c in b"ACGT":
    FORWARD_MAP[_c] = _c

#: reverse map: A<->T, C<->G, everything else -> 0
REVERSE_MAP = np.zeros(256, dtype=np.uint8)
for _a, _b in [(ord("A"), ord("T")), (ord("C"), ord("G")),
               (ord("G"), ord("C")), (ord("T"), ord("A"))]:
    REVERSE_MAP[_a] = _b


def canonicalize_batch(windows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Canonicalize a batch of equal-length k-mers.

    Args:
      windows: uint8 [n, k] — raw ASCII k-mers.

    Returns:
      (canon, good): canon uint8 [n, k] canonicalized (invalid letters are 0),
      good bool [n] — True iff every letter was one of ACGT.
    """
    windows = np.asarray(windows, dtype=np.uint8)
    if windows.ndim == 1:
        windows = windows[None, :]
    n, k = windows.shape

    fm = FORWARD_MAP[windows]                  # forward-mapped
    rm = REVERSE_MAP[windows[:, ::-1]]         # reverse complement
    good = (fm != 0).all(axis=1)

    half = k // 2
    if half == 0:
        return fm, good

    fh = fm[:, :half]
    rh = rm[:, :half]
    diff = fh != rh
    has_diff = diff.any(axis=1)
    first = np.argmax(diff, axis=1)
    rows = np.arange(n)
    use_reverse = has_diff & (fh[rows, first] > rh[rows, first])

    canon = np.where(use_reverse[:, None], rm, fm)
    return canon, good
