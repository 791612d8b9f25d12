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
