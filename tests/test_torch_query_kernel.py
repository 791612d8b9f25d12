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
    (1, 256, 1, 1, 1152),   # W above one 512-word slice of the kernel
    (2, 128, 2, 1, 1152),
])
def test_twin_matches_xla(rng, B, T, h, P, W):
    matrix, rows = _inputs(rng, B, T, h, P, W)
    want = np.asarray(_gather_and_count(jnp.asarray(matrix),
                                        jnp.asarray(rows), h))
    np.testing.assert_array_equal(_port(matrix, rows, h), want)


@pytest.mark.parametrize("B,T,h,P,W", [
    (2, CHUNK, 3, 3, 128),
    (1, 2 * CHUNK, 1, 1, 256),
    (1, 128, 1, 1, 128),
    (1, 256, 1, 1, 128),
    (1, 128, 1, 1, 1152),   # three slices of the kernel's 384 words
    (1, 256, 2, 1, 1152),
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


H100_SMS = 132
#: the reference's default query shape (phase 3 of chip_smoke.py) and the
#: wide-row shape (phase 4): (B, T, h, P, W)
PHASE3 = (64, 1000, 1, 1, 384)
PHASE4 = (8, 1024, 1, 1, 3136)
PLAN_SHAPES = [PHASE3, PHASE4, (1, 1, 1, 1, 1), (1, 1000, 1, 1, 384),
               (1024, 1000, 1, 1, 384), (3, 17, 3, 3, 5), (2, 9, 8, 2, 1100),
               (1, 5, 252, 1, 16384), (4, 100_000, 2, 3, 128)]


def test_term_splits_fill_the_card():
    """The phase-3 and phase-4 grids are one whole wave of resident CTAs
    on a 132-SM H100, at least 80 % full; the phase-3 grid splits T over
    more than one CTA per query to get there."""
    for shape in (PHASE3, PHASE4):
        plan = qk.plan_gather_count(*shape, H100_SMS)
        slots = plan.per_sm * H100_SMS
        assert plan.grid <= slots, plan
        assert plan.grid >= 0.8 * slots, plan
    assert qk.plan_gather_count(*PHASE3, H100_SMS).cluster > 1


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_term_once(shape):
    """Each term of each (query, page, slice) lands in exactly one CTA of
    one cluster, and every word in exactly one slice."""
    B, T, h, P, W = shape
    plan = qk.plan_gather_count(B, T, h, P, W, H100_SMS)
    seen = np.zeros(T, dtype=np.int64)
    for rank in range(plan.cluster):
        lo = rank * plan.tpc
        seen[lo:min(T, lo + plan.tpc)] += 1
    assert (seen == 1).all()
    assert plan.cluster * plan.tpc - T < plan.tpc   # no CTA without terms
    words = np.zeros(W, dtype=np.int64)
    for s in range(plan.n_slices):
        words[s * plan.slice_w:(s + 1) * plan.slice_w] += 1
    assert (words == 1).all()
    assert plan.slice_w % 4 == 0 and plan.slice_w <= qk.MAX_SLICE_WORDS
    assert plan.wpt == -(-plan.slice_w // 128)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_cluster_divides_grid(shape):
    B, T, h, P, W = shape
    plan = qk.plan_gather_count(B, T, h, P, W, H100_SMS)
    assert 1 <= plan.cluster <= 8
    assert plan.grid % plan.cluster == 0
    assert plan.grid == B * P * plan.n_slices * plan.cluster


@pytest.mark.parametrize("W", [1, 3, 384, 3136, 16384])
@pytest.mark.parametrize("h", [1, 2, 3, 8, 252])
def test_plan_fits_shared_memory(W, h):
    """Dynamic shared memory stays within the 232,448 bytes a block may
    opt into, and the counted CTAs per SM fit the SM's 233,472 bytes."""
    plan = qk.plan_gather_count(64, 1000, h, 1, W, H100_SMS)
    assert plan.smem <= qk.SMEM_LIMIT
    assert plan.per_sm * (plan.smem + 1024) <= qk.SM_SMEM
    assert plan.stages >= 4
    qk._check_plan(plan, 64, 1000, 1, W)


def test_plan_rejects_a_bad_plan():
    plan = qk.plan_gather_count(*PHASE3, H100_SMS)
    for bad in (plan._replace(cluster=9, tpc=112, grid=64 * 9),
                plan._replace(tpc=10),
                plan._replace(smem=qk.SMEM_LIMIT + 1),
                plan._replace(grid=plan.grid + 1),
                plan._replace(stage_rows=3)):
        with pytest.raises(ValueError):
            qk._check_plan(bad, 64, 1000, 1, 384)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_stages_hold_whole_rows(shape):
    """A stage holds a power of 2 (at most 8) of row slices, as many as fit
    in STAGE_BYTES, at least one; the ring is what `smem` counts."""
    B, T, h, P, W = shape
    plan = qk.plan_gather_count(B, T, h, P, W, H100_SMS)
    row = 4 * plan.slice_w
    assert plan.stage_rows in (1, 2, 4, 8)
    assert plan.stage_rows == 1 or plan.stage_rows * row <= qk.STAGE_BYTES
    assert (plan.stage_rows == qk.MAX_STAGE_ROWS
            or 2 * plan.stage_rows * row > qk.STAGE_BYTES)
    assert plan.smem >= plan.stages * plan.stage_rows * row + 4 * 33 * \
        plan.slice_w


def test_plan_narrows_slices_for_small_batches():
    """One query at W=384 would give 8 CTAs: slices of 128 words triple
    them. 64 queries fill the card with whole rows."""
    one = qk.plan_gather_count(1, 1000, 1, 1, 384, H100_SMS)
    assert (one.slice_w, one.n_slices, one.cluster, one.grid) == (128, 3, 8,
                                                                  24)
    assert qk.plan_gather_count(*PHASE3, H100_SMS).slice_w == 384


def test_plan_uses_the_cards_cluster_occupancy():
    """Given the clusters the card holds at once (fewer than SMs x CTAs
    per SM / cluster size, since a cluster must fit in one GPC: here 124
    usable SMs), the phase-3 grid is one whole wave of them."""
    def occupancy(slice_w, stages, stage_rows, wpt, cluster):
        return 3 * 124 // cluster

    plan = qk.plan_gather_count(*PHASE3, H100_SMS, max_clusters=occupancy)
    assert plan.cluster == 5
    assert plan.grid == 64 * 5 <= occupancy(0, 0, 0, 0, 5) * 5
