"""2-bit packed k-mer codec, vectorized.

Byte layout matches the reference `KMer<N>` exactly so `.cobs_doc` files and
McCortex payload bits interoperate (reference: cobs/kmer.hpp:35-177,
cobs/kmer.cpp:13-181):

- base encoding A=0, C=1, G=2, T=3;
- the packed array has ceil(N/4) bytes; byte[0] holds the LAST four
  characters and byte[size-1] the FIRST ones;
- within a byte the earlier character occupies the higher 2 bits;
- when N % 4 != 0, the top 2*(4 - N%4) bits of byte[size-1] are zero
  ('A' padding) — equivalently the whole k-mer is the integer
  sum(base[j] * 4**(N-1-j)) stored little-endian.

Implemented as whole-array table lookups over [n, P] packed matrices; no
per-kmer loops.
"""

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

#: ASCII letter -> 2-bit code (A=0 C=1 G=2 T=3); invalid letters -> 0
LETTER_TO_CODE = np.zeros(256, dtype=np.uint8)
LETTER_TO_CODE[ord("C")] = 1
LETTER_TO_CODE[ord("G")] = 2
LETTER_TO_CODE[ord("T")] = 3

#: packed byte -> 4 ASCII letters (earlier char in higher bits)
BYTE_TO_LETTERS = np.empty((256, 4), dtype=np.uint8)
for _v in range(256):
    BYTE_TO_LETTERS[_v] = [
        _BASES[(_v >> 6) & 3], _BASES[(_v >> 4) & 3],
        _BASES[(_v >> 2) & 3], _BASES[_v & 3],
    ]

#: packed byte -> reverse-complement packed byte (4 bases reversed+complemented)
MIRROR_BYTE = np.empty(256, dtype=np.uint8)
for _v in range(256):
    _b = [(_v >> 6) & 3, (_v >> 4) & 3, (_v >> 2) & 3, _v & 3]
    _m = [3 - x for x in reversed(_b)]
    MIRROR_BYTE[_v] = (_m[0] << 6) | (_m[1] << 4) | (_m[2] << 2) | _m[3]


def packed_size(kmer_size: int) -> int:
    return (kmer_size + 3) // 4


def encode(strings: np.ndarray) -> np.ndarray:
    """Pack ASCII k-mers [n, N] uint8 -> packed [n, P] uint8."""
    strings = np.asarray(strings, dtype=np.uint8)
    if strings.ndim == 1:
        strings = strings[None, :]
    n, N = strings.shape
    pad = (4 - N % 4) % 4
    if pad:
        padded = np.zeros((n, N + pad), dtype=np.uint8)
        padded[:, :pad] = ord("A")
        padded[:, pad:] = strings
    else:
        padded = strings
    codes = LETTER_TO_CODE[padded].reshape(n, -1, 4)
    bytes_be = ((codes[:, :, 0] << 6) | (codes[:, :, 1] << 4) |
                (codes[:, :, 2] << 2) | codes[:, :, 3]).astype(np.uint8)
    # byte[0] holds the last 4 characters -> reverse group order
    return bytes_be[:, ::-1].copy()


def decode(packed: np.ndarray, kmer_size: int) -> np.ndarray:
    """Unpack packed k-mers [n, P] uint8 -> ASCII [n, N] uint8."""
    packed = np.asarray(packed, dtype=np.uint8)
    if packed.ndim == 1:
        packed = packed[None, :]
    n = packed.shape[0]
    chars = BYTE_TO_LETTERS[packed[:, ::-1]].reshape(n, -1)
    skip = (4 - kmer_size % 4) % 4
    return chars[:, skip:skip + kmer_size]


def mirror(packed: np.ndarray, kmer_size: int) -> np.ndarray:
    """Reverse complement in packed form, batch [n, P] -> [n, P].

    Matches KMer::mirror() (reference: cobs/kmer.hpp:160-176): shift the
    (N%4)-base tail through the byte stream while mirroring each byte.
    """
    packed = np.asarray(packed, dtype=np.uint8)
    if packed.ndim == 1:
        packed = packed[None, :]
    rem = kmer_size % 4
    if rem == 0:
        return MIRROR_BYTE[packed[:, ::-1]].copy()
    sh_hi = 2 * (4 - rem)
    sh_lo = 2 * rem
    n, P = packed.shape
    # overflow chain: carry the high (4-rem) bases of each byte downward
    shifted = np.empty_like(packed)
    carry = (packed[:, P - 1] << sh_hi).astype(np.uint8)
    for i in range(1, P):
        bp = packed[:, P - 1 - i]
        shifted[:, i - 1] = carry | (bp >> sh_lo)
        carry = (bp << sh_hi).astype(np.uint8)
    shifted[:, P - 1] = carry
    return MIRROR_BYTE[shifted]


def canonicalize_packed(packed: np.ndarray, kmer_size: int) -> np.ndarray:
    """Canonicalize packed k-mers with the reference's truncated compare.

    Matches KMer::canonicalize() (reference: cobs/kmer.hpp:148-158): walk
    i from the front and r from the back while base[i] == 3 - base[r] and
    i < N/2; mirror iff base[i] > 3 - base[r] at the stopping point.
    """
    strings = decode(packed, kmer_size)
    codes = LETTER_TO_CODE[strings]            # [n, N]
    comp_rev = 3 - codes[:, ::-1]
    half = kmer_size // 2
    n = codes.shape[0]
    if half == 0:
        return packed.copy()
    diff = codes[:, :half] != comp_rev[:, :half]
    has_diff = diff.any(axis=1)
    first = np.argmax(diff, axis=1)
    rows = np.arange(n)
    use_mirror = has_diff & (codes[rows, first] > comp_rev[rows, first])
    mirrored = mirror(packed, kmer_size)
    return np.where(use_mirror[:, None], mirrored, packed)


def random_packed(n: int, kmer_size: int, rng: np.random.Generator) -> np.ndarray:
    """Random packed k-mers (uniform bases), for benchmarks/tests."""
    P = packed_size(kmer_size)
    data = rng.integers(0, 256, size=(n, P), dtype=np.uint8)
    rem = kmer_size % 4
    if rem:
        # zero the unused high bits of the last byte ('A' padding)
        data[:, P - 1] &= (1 << (2 * rem)) - 1
    return data
