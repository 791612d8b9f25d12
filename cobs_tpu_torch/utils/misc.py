"""Misc helpers (reference: cobs/util/misc.{hpp,cpp})."""

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_sequence(size: int, seed: int) -> str:
    """Random ACGT sequence of `size` letters from a new generator seeded
    with `seed` (reference: cobs/util/misc.hpp:30-40)."""
    return random_sequence_rng(size, np.random.default_rng(seed))


def random_sequence_rng(size: int, rng: np.random.Generator) -> str:
    """Random ACGT sequence of `size` letters drawn from `rng`
    (reference: cobs/util/misc.hpp:30-40)."""
    return _BASES[rng.integers(0, 4, size=size)].tobytes().decode()


def format_iec(n: float) -> str:
    """1536 -> '1.5 Ki' style IEC formatting."""
    units = ["", "Ki", "Mi", "Gi", "Ti", "Pi"]
    i = 0
    x = float(n)
    while x >= 1024 and i + 1 < len(units):
        x /= 1024
        i += 1
    if i == 0:
        return f"{int(x)}"
    return f"{x:.1f} {units[i]}"
