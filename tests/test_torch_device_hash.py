"""cobs_tpu_torch device hashing against the JAX package, on the CPU.

On CPU tensors `rows_from_queries` runs its plain version (the CUDA
kernel is held against the same plain version on the card by
chip_smoke.py). Inputs come from numpy with a fixed seed and go through
both packages; row ids are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cobs_tpu.ops import device_hash as jdh
from cobs_tpu.query import engine as jeng
from cobs_tpu_torch.core.xxh64 import xxh64
from cobs_tpu_torch.ops import device_hash as tdh

torch.set_num_threads(2)

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: multi-page signature sizes: a prime, a power of two plus one, and the
#: rest of the int32 row space, so the zero row is 2^31 - 1 (a modulo of
#: hashes past 2^63 that signed arithmetic would get wrong)
SIGS = (1009, 65537, (1 << 31) - 1 - 1009 - 65537)


def _batch(rng, k, canonicalize, lens):
    """uint8 [B, L] (ACGT, or random bytes in text mode) and int32 [B]
    true lengths; L is past the longest query, so every row has padding
    terms."""
    L = max(lens) + 5
    if canonicalize:
        q = ACGT[rng.integers(0, 4, size=(len(lens), L))]
    else:
        q = rng.integers(0, 256, size=(len(lens), L)).astype(np.uint8)
    return q, np.asarray(lens, dtype=np.int32)


def _port(q, lens, k, h, canonicalize, sigs, offs, zero):
    return tdh.rows_from_queries(torch.from_numpy(q), torch.from_numpy(lens),
                                 k, h, canonicalize, sigs, offs,
                                 zero).numpy()


def _jax(q, lens, k, h, canonicalize, sigs, offs, zero):
    with jax.enable_x64():
        return np.asarray(jax.jit(
            jdh.rows_from_queries, static_argnums=range(2, 9))(
                jnp.asarray(q), jnp.asarray(lens), k, h, canonicalize,
                sigs, offs, zero, 0))


@pytest.mark.parametrize("canonicalize", [0, 1])
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("k", [7, 15, 31, 32, 33, 64, 100])
def test_rows_match_jax(rng, k, h, canonicalize):
    lens = [k, k + 3, 2 * k + 9, 3 * k]   # lens[0] is a one-term query
    q, lens = _batch(rng, k, canonicalize, lens)
    offs = tuple(int(x) for x in np.cumsum((0,) + SIGS[:-1]))
    zero = int(sum(SIGS))
    got = _port(q, lens, k, h, canonicalize, SIGS, offs, zero)
    want = _jax(q, lens, k, h, canonicalize, SIGS, offs, zero)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the one-term query hashes one term, the rest point at the zero row
    assert (got[0, 1:] == np.int32(zero)).all()
    assert (got[0, 0] != np.int32(zero)).all()


def test_hashes_with_top_bit_set_occur(rng):
    """The modulo above is really taken of u64 values past 2^63."""
    q = ACGT[rng.integers(0, 4, size=(1, 64))]
    hashes = xxh64(np.lib.stride_tricks.sliding_window_view(q[0], 31), 0)
    assert (hashes >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("kind,k,h,canonicalize", [
    ("classic", 31, 1, 1), ("classic", 31, 3, 1), ("compact", 20, 2, 1),
    ("text", 12, 2, 0)])
def test_rows_match_host_pipeline(rng, kind, k, h, canonicalize):
    """create_hashes + row_indices of the JAX package's host path, with
    its zero-row padding, give the same row ids."""
    sigs = (4099,) if kind == "classic" else SIGS[:2] + (3,)
    offs = tuple(int(x) for x in np.cumsum((0,) + sigs[:-1]))
    zero = int(sum(sigs))
    q, lens = _batch(rng, k, canonicalize, [k, 50, 90, 200])
    ix = jeng.DeviceIndex.__new__(jeng.DeviceIndex)
    ix.sig_sizes = np.asarray(sigs, dtype=np.uint64)
    ix.row_offsets = np.asarray(offs, dtype=np.int64)
    ix.matrix = np.zeros((zero + 1, 1), np.uint32)
    hashes = jeng.create_hashes([bytes(r[:n]) for r, n in zip(q, lens)],
                                k, h, canonicalize)
    want = np.full((len(lens), q.shape[1] - k + 1, h, len(sigs)), zero,
                   dtype=np.int32)
    for b, hs in enumerate(hashes):
        want[b, :hs.shape[0]] = ix.row_indices(hs)
    np.testing.assert_array_equal(
        _port(q, lens, k, h, canonicalize, sigs, offs, zero), want)


def test_cpu_wrapper_takes_plain_without_launch(rng):
    q, lens = _batch(rng, 31, 1, [40, 31])
    args = (torch.from_numpy(q), torch.from_numpy(lens), 31, 2, 1,
            (101, 7), (0, 101), 108)
    before = tdh.LAUNCHES
    got = tdh.rows_from_queries(*args)
    assert tdh.LAUNCHES == before
    assert got.shape == (2, q.shape[1] - 30, 2, 2)
    assert torch.equal(got, tdh.rows_from_queries_reference(*args))


def test_page_tables_as_tensors(rng):
    """Per-page tables given as int64 tensors (how the engine keeps them
    on the device) give the same rows as tuples."""
    q, lens = _batch(rng, 15, 1, [20, 60])
    t = (torch.tensor(SIGS[:2]), torch.tensor([0, SIGS[0]]))
    a = tdh.rows_from_queries(torch.from_numpy(q), torch.from_numpy(lens),
                              15, 1, 1, *t, 99)
    b = tdh.rows_from_queries(torch.from_numpy(q), torch.from_numpy(lens),
                              15, 1, 1, SIGS[:2], (0, SIGS[0]), 99)
    assert torch.equal(a, b)


def _bad_args(case):
    q = torch.zeros((2, 40), dtype=torch.uint8)
    n = torch.full((2,), 40, dtype=torch.int32)
    good = dict(qdata=q, qlens=n, term_size=31, num_hashes=1,
                canonicalize=1, sig_sizes=(7,), row_offsets=(0,),
                zero_row=7)
    bad = {
        "qdata_int32": (dict(qdata=q.int()), TypeError),
        "qlens_int64": (dict(qlens=n.long()), TypeError),
        "qdata_1d": (dict(qdata=q[0]), ValueError),
        "lens_mismatch": (dict(qlens=n[:1]), ValueError),
        "too_short": (dict(term_size=41), ValueError),
        "no_hashes": (dict(num_hashes=0), ValueError),
        "canonicalize_2": (dict(canonicalize=2), ValueError),
        "pages_mismatch": (dict(row_offsets=(0, 7)), ValueError),
        "noncontig": (dict(qdata=torch.zeros((2, 80),
                                             dtype=torch.uint8)[:, ::2]),
                      ValueError),
    }[case]
    return {**good, **bad[0]}, bad[1]


@pytest.mark.parametrize("case", ["qdata_int32", "qlens_int64", "qdata_1d",
                                  "lens_mismatch", "too_short", "no_hashes",
                                  "canonicalize_2", "pages_mismatch",
                                  "noncontig"])
def test_wrapper_rejects_bad_input(case):
    kwargs, exc = _bad_args(case)
    with pytest.raises(exc):
        tdh.rows_from_queries(**kwargs)


@pytest.mark.parametrize("queries,term_size,canonicalize", [
    ([b"ACGT" * 10, b"ACGTN" + b"A" * 40], 31, 1),
    ([b"ACGT" * 10, b"ACGT"], 31, 1),
    ([b"ACGT" * 10, b"ACGTacgt" * 5], 31, 1),
    ([b"ACGT" * 10, b"hello world, text mode!" * 2], 31, 0),
    ([b"ACGT" * 10, b"short"], 8, 0),
])
def test_validate_queries_matches_jax(queries, term_size, canonicalize):
    def outcome(fn):
        try:
            fn(queries, term_size, canonicalize)
            return None
        except ValueError as e:
            return str(e)

    assert outcome(tdh.validate_queries) == outcome(jdh.validate_queries)


@pytest.mark.parametrize("canonicalize", [0, 1])
def test_invalid_query_mask_matches_jax(rng, canonicalize):
    arr = ACGT[rng.integers(0, 4, size=(12, 40))]
    arr[3, 5] = ord("N")
    arr[7, 0] = ord("a")
    arr[11, 39] = 0
    got = tdh.invalid_query_mask(arr, canonicalize)
    np.testing.assert_array_equal(got,
                                  jdh.invalid_query_mask(arr, canonicalize))
    assert got.sum() == (3 if canonicalize else 0)


#: signature sizes of the Barrett checks: the smallest, small primes, a
#: power of two and its neighbour, and the largest int32 row space
BARRETT_SIGS = [1, 2, 3, 1009, 65537, 1 << 21, (1 << 21) + 1, (1 << 31) - 1]


def _barrett_mod(x: int, sig: int, m: int) -> int:
    """Python twin of the kernel's `mod_barrett`: x % sig for
    0 <= x < 2^64 and m = (2^64 - 1) // sig, step for step as the kernel
    computes it in 64-bit registers."""
    q = (x * m) >> 64                  # __umul64hi(x, m)
    r = (x - q * sig) % (1 << 64)      # wraps as u64 arithmetic does
    return r - sig if r >= sig else r


@pytest.mark.parametrize("sig", BARRETT_SIGS)
def test_barrett_twin_equals_modulo(sig):
    """The kernel's Barrett step (its Python twin, with the factor of
    `barrett_factors`) equals % at the edges of each quotient and at 10^4
    random 64-bit values."""
    m = int(tdh.barrett_factors([sig])[0])
    assert m == (2**64 - 1) // sig
    xs = [0, 1, 1 << 63, 2**64 - 1, 2**64 - 2, (1 << 63) - 1]
    for j in (1, 2, 7, 2**64 // sig - 1, 2**64 // sig):
        xs += [x for x in (sig * j - 1, sig * j, sig * j + 1)
               if 0 <= x < 2**64]
    gen = np.random.default_rng(sig)
    xs += [int(x) for x in gen.integers(0, 2**64, size=10_000,
                                        dtype=np.uint64)]
    for x in xs:
        assert _barrett_mod(x, sig, m) == x % sig, (x, sig)


def test_page_tables_hold_barrett_factors():
    sig, off, mag = tdh.page_tables((1, 1009, 1 << 21), (0, 1, 1010), "cpu")
    assert sig.tolist() == [1, 1009, 1 << 21]
    assert off.tolist() == [0, 1, 1010]
    assert mag.dtype == torch.int64
    assert (mag.numpy().view(np.uint64).tolist()
            == [(2**64 - 1) // s for s in (1, 1009, 1 << 21)])
    with pytest.raises(ValueError, match=">= 1"):
        tdh.barrett_factors([3, 0])


_M32 = np.uint64(0xFFFF_FFFF)


def _words(s, start, step, count):
    """uint64 [n, count]: the kernel's `Words` over the staged bytes
    (uint32 words `s`): word j is the funnel shift of the aligned words
    at (start + 4 step j) // 4 and the one after it."""
    start = np.asarray(start)
    wi = (start >> 2)[:, None] + step * np.arange(count)[None, :]
    sh = ((start & 3) * 8).astype(np.uint64)[:, None]
    lo, hi = s[wi].astype(np.uint64), s[wi + 1].astype(np.uint64)
    return (((hi << np.uint64(32)) | lo) >> sh) & _M32


def _complement4(x):
    return (x ^ np.uint64(0x15151515)
            ^ (((x >> np.uint64(1)) & np.uint64(0x01010101))
               * np.uint64(0x11))) & _M32


def _bswap32(x):
    return (((x & np.uint64(0xFF)) << np.uint64(24))
            | ((x & np.uint64(0xFF00)) << np.uint64(8))
            | ((x >> np.uint64(8)) & np.uint64(0xFF00))
            | (x >> np.uint64(24))) & _M32


def _swar_canonical(seq: np.ndarray, k: int) -> tuple[np.ndarray,
                                                      np.ndarray]:
    """numpy twin of the kernel's SWAR path over every window of `seq`:
    the strand choice (`reverse_is_smaller`) and the hashed key's bytes
    rebuilt from `Key::word`. Staged as the kernel stages a tile: 4 pad
    bytes, the bytes, 8 more, in whole words."""
    n = seq.size - k + 1
    nbytes = -(-(4 + seq.size + 8) // 4) * 4
    buf = np.zeros(nbytes, dtype=np.uint8)
    buf[4:4 + seq.size] = seq
    s = buf.view("<u4")
    base = 4 + np.arange(n)
    half = k // 2
    rev = np.zeros(n, dtype=bool)
    if half:
        nw = -(-half // 4)
        rem = half - 4 * (nw - 1)
        last = np.uint64(0xFFFFFFFF if rem == 4
                         else (0xFFFFFFFF & ~(0xFFFFFFFF >> (8 * rem))))
        f = _bswap32(_words(s, base, 1, nw))
        r = _complement4(_words(s, base + k - 4, -1, nw))
        f[:, -1] &= last
        r[:, -1] &= last
        differ = f != r
        first = differ.argmax(axis=1)
        rows = np.arange(n)
        rev = differ.any(axis=1) & (f[rows, first] > r[rows, first])
    nk = -(-k // 4)
    fwd = _words(s, base, 1, nk)
    bwd = _complement4(_bswap32(_words(s, base + k - 4, -1, nk)))
    key = np.where(rev[:, None], bwd, fwd).astype("<u4")
    return rev, key.view(np.uint8).reshape(n, 4 * nk)[:, :k]


@pytest.mark.parametrize("k", [7, 15, 31, 32, 33, 64])
def test_swar_canonical_twin_matches_canonicalize_batch(rng, k):
    """The kernel's word-wide reverse complement and truncated canonical
    compare, as a numpy twin, pick the same strand and key bytes as
    `canonicalize_batch` at every window start (every offset mod 8) of
    sequences whose lengths are not multiples of 4, including windows
    whose halves tie."""
    from cobs_tpu_torch.core.canonical import canonicalize_batch

    seen = set()
    for length in (k, k + 1, k + 2, 4 * k + 3, 203):
        seq = ACGT[rng.integers(0, 4, size=length)]
        if length == 4 * k + 3:  # a palindrome: the halves tie
            seq[:k] = canonicalize_batch(seq[:k][None])[0][0]
            rc = {65: 84, 67: 71, 71: 67, 84: 65}
            seq[k - k // 2:k] = [rc[c] for c in seq[:k // 2][::-1]]
        rev, key = _swar_canonical(seq, k)
        windows = np.lib.stride_tricks.sliding_window_view(seq, k)
        want, _ = canonicalize_batch(windows)
        np.testing.assert_array_equal(key, want)
        seen.update(rev.tolist())
    assert seen == {False, True}
