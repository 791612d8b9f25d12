"""Vectorized XXH64.

The reference uses one hash family for the entire system:
``hash_j = XXH64(term, len, seed=j) % signature_size`` for
j in 0..num_hashes-1 (reference: cobs/util/misc.hpp:65-72). Bit-exact file
and query parity therefore requires a bit-exact XXH64.

Implemented here from the public xxHash specification as a NumPy
batch kernel: it hashes `n` equal-length byte strings (the sliding windows
of a query batch) for one or many seeds at once, and feeds the device
gather-and-count kernel with whole row-index tensors in one shot.

All arithmetic is uint64 with natural wraparound.
"""

import numpy as np

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)

_U64 = np.uint64
_MASK_ERRSTATE = {"over": "ignore"}


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = _U64(r)
    return (x << r) | (x >> (_U64(64) - r))


def _u64_lanes(data: np.ndarray, start: int, count: int) -> np.ndarray:
    """Read `count` little-endian u64 lanes starting at byte `start`.

    data: [n, L] uint8. Returns [n, count] uint64.
    """
    sl = np.ascontiguousarray(data[:, start:start + 8 * count])
    return sl.view("<u8")


def _u32_lane(data: np.ndarray, start: int) -> np.ndarray:
    sl = np.ascontiguousarray(data[:, start:start + 4])
    return sl.view("<u4")[:, 0].astype(_U64)


def _round(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _rotl(acc + lane * _P2, 31) * _P1


def _merge_round(h: np.ndarray, acc: np.ndarray) -> np.ndarray:
    h = h ^ _round(np.zeros_like(acc), acc)
    return h * _P1 + _P4


def xxh64(data: np.ndarray, seed: int | np.ndarray) -> np.ndarray:
    """Batched XXH64 of `n` equal-length byte strings.

    Args:
      data: uint8 array [n, L] — n inputs of common length L.
      seed: scalar seed, or an array of seeds broadcastable against n.

    Returns:
      uint64 array [n] of hashes.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim == 1:
        data = data[None, :]
    n, length = data.shape
    seed = _U64(seed) if np.isscalar(seed) else np.asarray(seed, dtype=_U64)

    with np.errstate(**_MASK_ERRSTATE):
        pos = 0
        if length >= 32:
            v1 = np.broadcast_to(seed + _P1 + _P2, (n,)).copy()
            v2 = np.broadcast_to(seed + _P2, (n,)).copy()
            v3 = np.broadcast_to(seed + _U64(0), (n,)).copy()
            v4 = np.broadcast_to(seed - _P1, (n,)).copy()
            n_stripes = length // 32
            lanes = _u64_lanes(data, 0, 4 * n_stripes)  # [n, 4*s]
            for s in range(n_stripes):
                v1 = _round(v1, lanes[:, 4 * s + 0])
                v2 = _round(v2, lanes[:, 4 * s + 1])
                v3 = _round(v3, lanes[:, 4 * s + 2])
                v4 = _round(v4, lanes[:, 4 * s + 3])
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
            h = _merge_round(h, v1)
            h = _merge_round(h, v2)
            h = _merge_round(h, v3)
            h = _merge_round(h, v4)
            pos = 32 * n_stripes
        else:
            h = np.broadcast_to(seed + _P5, (n,)).copy()

        h = h + _U64(length)

        while length - pos >= 8:
            lane = _u64_lanes(data, pos, 1)[:, 0]
            h = h ^ _round(np.zeros_like(lane), lane)
            h = _rotl(h, 27) * _P1 + _P4
            pos += 8

        if length - pos >= 4:
            h = h ^ (_u32_lane(data, pos) * _P1)
            h = _rotl(h, 23) * _P2 + _P3
            pos += 4

        while pos < length:
            h = h ^ (data[:, pos].astype(_U64) * _P5)
            h = _rotl(h, 11) * _P1
            pos += 1

        h = h ^ (h >> _U64(33))
        h = h * _P2
        h = h ^ (h >> _U64(29))
        h = h * _P3
        h = h ^ (h >> _U64(32))
    return h


def xxh64_multi_seed(data: np.ndarray, num_seeds: int) -> np.ndarray:
    """Hash each input under seeds 0..num_seeds-1.

    Args:
      data: uint8 [n, L].
    Returns:
      uint64 [n, num_seeds]; column j is XXH64(input, seed=j).

    This is the vector form of `process_hashes` before the modulo
    (reference: cobs/util/misc.hpp:65-72); the `% signature_size` is applied
    by the caller because the compact index re-mods per page
    (reference: cobs/query/compact_index/mmap_search_file.cpp:55-66).
    """
    out = np.empty((data.shape[0] if data.ndim == 2 else 1, num_seeds),
                   dtype=np.uint64)
    for j in range(num_seeds):
        out[:, j] = xxh64(data, j)
    return out
