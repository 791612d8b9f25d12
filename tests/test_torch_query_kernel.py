"""cobs_tpu_torch gather-and-count against the JAX package, on the CPU.

On CPU tensors `gather_and_count` runs its plain PyTorch twin (the CUDA
kernel is checked against the same twin on the card by chip_smoke.py).
Inputs come from numpy with a fixed seed and go through both packages;
counts are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cobs_tpu.ops.query_kernel import CHUNK, gather_and_count_pallas
from cobs_tpu.query.engine import _gather_and_count
from cobs_tpu_torch.ops import query_kernel as qk

torch.set_num_threads(2)

R = 97


def _inputs(rng, B, T, h, P, W):
    """Random u32 matrix [R+1, W] with a zero last row, and row ids whose
    last T//8 terms are zero-row padding."""
    matrix = rng.integers(0, 1 << 32, size=(R + 1, W),
                          dtype=np.uint64).astype(np.uint32)
    matrix[-1] = 0
    rows = rng.integers(0, R, size=(B, T, h, P)).astype(np.int32)
    rows[:, T - T // 8:] = R
    return matrix, rows


def _port(matrix, rows, h):
    return qk.gather_and_count(torch.from_numpy(matrix.view(np.int32)),
                               torch.from_numpy(rows), h).numpy()


@pytest.mark.parametrize("B,T,h,P,W", [
    (2, 128, 1, 1, 128),
    (2, 128, 3, 3, 128),
    (1, 37, 2, 2, 256),     # T not a multiple of 128, h=2, two pages
    (3, 1, 1, 1, 128),      # a single term
])
def test_twin_matches_xla(rng, B, T, h, P, W):
    matrix, rows = _inputs(rng, B, T, h, P, W)
    want = np.asarray(_gather_and_count(jnp.asarray(matrix),
                                        jnp.asarray(rows), h))
    np.testing.assert_array_equal(_port(matrix, rows, h), want)


@pytest.mark.parametrize("B,T,h,P,W", [
    (2, CHUNK, 3, 3, 128),
    (1, 2 * CHUNK, 1, 1, 256),
])
def test_twin_matches_pallas_interpret(rng, B, T, h, P, W):
    matrix, rows = _inputs(rng, B, T, h, P, W)
    want = np.asarray(gather_and_count_pallas(
        jnp.asarray(matrix), jnp.asarray(rows), h, interpret=True))
    np.testing.assert_array_equal(_port(matrix, rows, h), want)


def test_twin_streams_terms_in_chunks(rng, monkeypatch):
    """A tiny intermediate budget forces one-term chunks; the counts are
    unchanged."""
    matrix, rows = _inputs(rng, 2, 45, 2, 2, 8)
    want = _port(matrix, rows, 2)
    monkeypatch.setattr(qk, "_TWIN_BYTES", 1)
    np.testing.assert_array_equal(_port(matrix, rows, 2), want)


def test_twin_reads_out_of_range_ids_as_zero_row(rng):
    matrix, rows = _inputs(rng, 2, 16, 1, 1, 8)
    bad = rows.copy()
    bad[:, :3] = -5
    bad[:, 3:6] = R + 7
    fixed = rows.copy()
    fixed[:, :6] = R
    np.testing.assert_array_equal(_port(matrix, bad, 1),
                                  _port(matrix, fixed, 1))


def test_cpu_wrapper_takes_twin_without_launch(rng):
    matrix, rows = _inputs(rng, 2, 20, 1, 2, 8)
    m, r = torch.from_numpy(matrix.view(np.int32)), torch.from_numpy(rows)
    before = qk.LAUNCHES
    got = qk.gather_and_count(m, r, 1)
    assert qk.LAUNCHES == before
    assert got.dtype == torch.int32 and got.shape == (2, 2 * 8 * 32)
    assert torch.equal(got, qk.gather_and_count_reference(m, r, 1))


def _bad_args(case):
    m = torch.zeros((5, 8), dtype=torch.int32)
    r = torch.zeros((2, 3, 1, 1), dtype=torch.int32)
    return {
        "matrix_int64": (m.long(), r, 1, TypeError),
        "rows_int64": (m, r.long(), 1, TypeError),
        "rows_3d": (m, r[:, :, 0], 1, ValueError),
        "hash_mismatch": (m, r, 2, ValueError),
        "matrix_noncontig": (torch.zeros((8, 5), dtype=torch.int32).t(),
                             r, 1, ValueError),
        "rows_noncontig": (m, torch.zeros((2, 6, 1, 1),
                                          dtype=torch.int32)[:, ::2],
                           1, ValueError),
        "empty_terms": (m, r[:, :0], 1, ValueError),
    }[case]


@pytest.mark.parametrize("case", ["matrix_int64", "rows_int64", "rows_3d",
                                  "hash_mismatch", "matrix_noncontig",
                                  "rows_noncontig", "empty_terms"])
def test_wrapper_rejects_bad_input(case):
    m, r, h, exc = _bad_args(case)
    with pytest.raises(exc):
        qk.gather_and_count(m, r, h)


def test_term_splits_fill_the_card():
    """T is split so the grid holds about 8 blocks per SM, never into
    ranges shorter than 64 terms."""
    # the reference's default shape on a 132-SM H100: 192 base blocks
    assert qk.term_splits(64, 1000, 1, 384, 132) == 6
    assert qk.term_splits(1, 20, 1, 128, 132) == 1
    for B, T, P, W in [(1, 1, 1, 4), (3, 1000, 3, 316), (8, 1024, 1, 3136),
                       (64, 100_000, 1, 384), (1024, 50, 40, 128)]:
        s = qk.term_splits(B, T, P, W, 132)
        assert 1 <= s <= max(1, T // 64)
