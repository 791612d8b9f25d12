"""Misc helpers (reference: cobs/util/misc.{hpp,cpp})."""

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_sequence_rng(size: int, rng: np.random.Generator) -> str:
    """Random ACGT sequence of `size` letters drawn from `rng`
    (reference: cobs/util/misc.hpp:30-40)."""
    return _BASES[rng.integers(0, 4, size=size)].tobytes().decode()
