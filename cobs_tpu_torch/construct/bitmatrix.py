"""Batched Bloom bit-matrix construction on the host.

The reference sets bits one term at a time through a scalar callback chain
(reference: cobs/construction/classic_index.cpp:39-73). Here each window
batch of a document goes through the native library in one call:
canonicalization, XXH64 for every (term, seed) pair and the mod by the
signature size (`native.window_rows`), then the bit scatter into the byte
matrix (`native.set_bits`). `doc_row_indices` also feeds the device
scatter of construct/device.py.
"""

import concurrent.futures

import numpy as np

from cobs_tpu_torch import native
from cobs_tpu_torch.settings import settings


def invalid_dna_warning(path) -> str:
    return f"WARNING: Invalid DNA base pair (not ACGT) in document: {path}"


def doc_row_indices(windows: np.ndarray, signature_size: int,
                    num_hashes: int,
                    canonicalize: int) -> tuple[np.ndarray, bool]:
    """Bloom row indices for all terms of a window batch, hashed on
    settings.threads threads.

    Args:
      windows: uint8 [n, k] raw term windows.
    Returns:
      (rows uint64 [n * num_hashes], all_good): rows are already modded by
      signature_size; all_good is False when any term contained non-ACGT
      letters (construction warns but still indexes the zero-mapped bytes,
      reference: cobs/construction/classic_index.cpp:57-66).
    """
    return native.window_rows(windows, num_hashes, signature_size,
                              canonicalize, settings.threads)


def build_batch_matrix(entries, signature_size: int, row_size: int,
                       term_size: int, num_hashes: int, canonicalize: int,
                       warn, num_threads: int = 0) -> np.ndarray:
    """Construct the bit matrix for one batch of documents.

    Parallelizes over groups of 8 documents, one byte column each, so
    worker threads never write the same byte (the reference's
    false-sharing-free scheme, reference:
    cobs/construction/classic_index.cpp:96-118). The native calls release
    the GIL, so Python threads give real parallelism; the bits a document
    sets do not depend on which thread sets them.

    Returns uint8 [signature_size, row_size].
    """
    data = np.zeros((signature_size, row_size), dtype=np.uint8)

    def do_octet(start: int) -> list[str]:
        warned = []
        for doc_index in range(start, min(start + 8, len(entries))):
            entry = entries[doc_index]
            shown_warning = False
            for windows in entry.term_windows(term_size):
                rows, good = doc_row_indices(
                    windows, signature_size, num_hashes, canonicalize)
                if not good and not shown_warning:
                    warned.append(str(entry.path))
                    shown_warning = True
                native.set_bits(data, rows, doc_index)
        return warned

    octets = range(0, len(entries), 8)
    workers = num_threads or settings.threads or 1
    if workers > 1 and len(entries) > 8:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            warned_lists = list(pool.map(do_octet, octets))
    else:
        warned_lists = [do_octet(o) for o in octets]
    for warned in warned_lists:
        for path in warned:
            warn(invalid_dna_warning(path))
    return data
