"""cobs_tpu_torch row gather (K2) against the JAX package, on the CPU.

On CPU tensors `dma_gather_rows` runs its plain version (the CUDA kernel
is held against the same plain version on the card by chip_smoke.py).
Inputs come from numpy with a fixed seed; every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cobs_tpu.ops.dma_gather as jdg
from cobs_tpu_torch.ops import dma_gather as tdg

torch.set_num_threads(2)


def _matrix(rng, R, W):
    return rng.integers(0, 1 << 32, size=(R, W),
                        dtype=np.uint64).astype(np.uint32)


def _port(matrix, rows):
    return tdg.dma_gather_rows(torch.from_numpy(matrix.view(np.int32)),
                               torch.from_numpy(rows)).numpy() \
        .view(np.uint32)


@pytest.mark.parametrize("R,W,N,group,budget", [
    (512, 384, 96, 16, None),     # the JAX test's exact case
    (64, 128, 64, 8, 32 * 4),     # two pallas_calls of 32 ids each
])
def test_plain_matches_pallas_interpret(rng, monkeypatch, R, W, N, group,
                                        budget):
    if budget is not None:
        monkeypatch.setattr(jdg, "_IDX_SMEM_BUDGET", budget)
    matrix = _matrix(rng, R, W)
    rows = rng.integers(0, R, size=N).astype(np.int32)
    want = np.asarray(jdg.dma_gather_rows(
        jnp.asarray(matrix), jnp.asarray(rows), group=group,
        interpret=True))
    np.testing.assert_array_equal(_port(matrix, rows), want)


@pytest.mark.parametrize("R,W,N", [(1, 1, 1), (7, 3, 17), (100, 5, 1000),
                                   (33, 130, 9), (4099, 384, 257)])
def test_any_shape_matches_numpy(rng, R, W, N):
    """Any R, W and N (no group, 128-lane or flat-view rule)."""
    matrix = _matrix(rng, R, W)
    rows = rng.integers(0, R, size=N).astype(np.int32)
    np.testing.assert_array_equal(_port(matrix, rows), matrix[rows])


def test_out_of_range_ids_give_zero_rows(rng):
    R, W = 50, 6
    matrix = _matrix(rng, R, W)
    rows = np.array([0, -1, R, R - 1, np.iinfo(np.int32).min,
                     np.iinfo(np.int32).max, 3], dtype=np.int32)
    got = _port(matrix, rows)
    ok = (rows >= 0) & (rows < R)
    np.testing.assert_array_equal(got[ok], matrix[rows[ok]])
    assert (got[~ok] == 0).all()


def test_cpu_wrapper_takes_plain_without_launch(rng):
    m = torch.from_numpy(_matrix(rng, 20, 8).view(np.int32))
    r = torch.from_numpy(rng.integers(-2, 22, size=30).astype(np.int32))
    before = tdg.LAUNCHES
    got = tdg.dma_gather_rows(m, r)
    assert tdg.LAUNCHES == before
    assert got.dtype == torch.int32 and got.shape == (30, 8)
    assert torch.equal(got, tdg.dma_gather_rows_reference(m, r))


@pytest.mark.parametrize("case,exc", [
    ("matrix_int64", TypeError), ("rows_int64", TypeError),
    ("rows_2d", ValueError), ("empty_rows", ValueError),
    ("matrix_noncontig", ValueError)])
def test_wrapper_rejects_bad_input(case, exc):
    m = torch.zeros((5, 8), dtype=torch.int32)
    r = torch.zeros(3, dtype=torch.int32)
    args = {
        "matrix_int64": (m.long(), r),
        "rows_int64": (m, r.long()),
        "rows_2d": (m, r[None]),
        "empty_rows": (m, r[:0]),
        "matrix_noncontig": (torch.zeros((8, 5), dtype=torch.int32).t(), r),
    }[case]
    with pytest.raises(exc):
        tdg.dma_gather_rows(*args)


H100_SMS = 132


@pytest.mark.parametrize("W", [4, 384, 3136, 4100, 6144, 16384, 1 << 20])
@pytest.mark.parametrize("N", [1, 17, 16384])
def test_plan_gather_fits_and_covers_rows(N, W):
    """Chunks of a row are 16-byte multiples that cover it, no larger than
    a stage; the ring fits the 232,448 bytes a block may opt into, and the
    persistent grid has a unit for every CTA."""
    plan = tdg.plan_gather(N, W, H100_SMS)
    assert plan.chunk_bytes % 16 == 0
    assert plan.chunk_bytes <= tdg.STAGE_MAX_BYTES
    assert (plan.chunks - 1) * plan.chunk_bytes < 4 * W
    assert plan.chunks * plan.chunk_bytes >= 4 * W
    assert 2 <= plan.stages <= 64
    assert plan.smem <= tdg.SMEM_LIMIT
    assert 1 <= plan.grid <= min(N * plan.chunks,
                                 tdg.MAX_CTAS_PER_SM * H100_SMS)
    assert not plan.evict_first   # no L2 size given


def test_plan_gather_small_rows_get_more_ctas():
    """A 1.5 KB row is one unit; one lane issues a CTA's copies, so small
    rows get the most CTAs per SM, wide rows one, each with a ring of at
    least 16 KB."""
    small = tdg.plan_gather(16384, 384, H100_SMS)
    assert small.chunks == 1 and small.chunk_bytes == 1536
    assert small.grid == tdg.MAX_CTAS_PER_SM * H100_SMS
    assert small.stages * small.chunk_bytes >= 15 << 10
    wide = tdg.plan_gather(16384, 16384, H100_SMS)
    assert wide.grid == H100_SMS and wide.chunk_bytes == 8 << 10


H100_L2 = 50 << 20


@pytest.mark.parametrize("N,W,evict", [
    (16384, 384, True),      # a 25 MB output fits in half the L2
    (16384, 6144, False),
    (1, 16384, True),
    (65536, 384, False),
])
def test_plan_gather_reads_evict_first_when_the_output_fits_l2(N, W, evict):
    plan = tdg.plan_gather(N, W, H100_SMS, l2_bytes=H100_L2)
    assert plan.evict_first is evict
