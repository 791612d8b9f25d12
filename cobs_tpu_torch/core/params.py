"""Bloom filter parameter math.

Mirrors the reference formulas exactly
(reference: cobs/util/calc_signature_size.cpp:17-46).
"""

import math


def calc_signature_size_ratio(num_hashes: float,
                              false_positive_rate: float) -> float:
    """Bits-per-element ratio m/n for the given (k, fpr)."""
    denominator = math.log(1 - false_positive_rate ** (1 / num_hashes))
    result = -num_hashes / denominator
    if not result > 0:
        raise ValueError("invalid signature size ratio")
    return result


def calc_signature_size(num_elements: int, num_hashes: float,
                        false_positive_rate: float) -> int:
    """Number of Bloom filter rows for the largest document."""
    ratio = calc_signature_size_ratio(num_hashes, false_positive_rate)
    result = math.ceil(num_elements * ratio)
    if result < 0:
        raise ValueError("invalid signature size")
    return int(result)


def calc_average_set_bit_ratio(signature_size: int, num_hashes: float,
                               false_positive_rate: float) -> float:
    """Expected fraction of set bits in a full filter."""
    num_elements = signature_size / calc_signature_size_ratio(
        num_hashes, false_positive_rate)
    result = 1 - (1 - 1 / signature_size) ** (num_hashes * num_elements)
    if not (0 <= result <= 1):
        raise ValueError("invalid set bit ratio")
    return result
