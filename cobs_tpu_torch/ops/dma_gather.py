"""Row gather ``out = matrix[rows]``: K2 of the JAX package.

`dma_gather_rows` is the port of `cobs_tpu/ops/dma_gather.py::
dma_gather_rows`, the batched-DMA Pallas row gather that
`experiments/dma_gather_bench.py` measures against XLA's native gather.
On a CUDA tensor it launches the hand-written Hopper kernel in
`csrc/dma_gather.cu` (built by `_build.load` at first use); on a CPU
tensor it runs the plain PyTorch version `dma_gather_rows_reference`.
Its bandwidth path is `cobs_tpu_torch/experiments/dma_gather_bench.py`.

Contract (both): matrix int32 [R, W] (u32 words, bit for bit), rows int32
[N] -> int32 [N, W] with ``out[n] = matrix[rows[n]]``. Any R, N, W >= 1
(the TPU kernel's group, 128-lane and R*W < 2^31 rules do not apply; row
offsets are 64-bit). A row id outside [0, R) gives a zero row, in the
kernel and the plain version alike, so no id reads outside the matrix.
"""

import ctypes
from typing import NamedTuple

import torch

#: kernel launches made by `dma_gather_rows` (CUDA tensors only); a run
#: resets it to show that its path went through the kernel
LAUNCHES = 0

_ROWS_PER_BLOCK = 8   # warps per block of the 4-byte path, one row each
#: bulk path (csrc/dma_gather.cu): the largest stage (a row, or a chunk of
#: a wider row), the ring's bytes per SM, the least ring per CTA; and the
#: CTAs per SM, SM_STAGE_BYTES // stage bytes, 1 to MAX_CTAS_PER_SM (one
#: lane issues every copy of a CTA, so smaller stages need more CTAs)
STAGE_MAX_BYTES = 8 << 10
RING_BYTES = 64 << 10
MIN_RING_BYTES = 16 << 10
SM_STAGE_BYTES = 12 << 10
MAX_CTAS_PER_SM = 8
_MIN_STAGES = 2       # a load in flight and a store still reading
_MAX_STAGES = 64
#: dynamic shared memory a block may opt into on sm_90
SMEM_LIMIT = 232_448


class GatherPlan(NamedTuple):
    """Launch geometry of the bulk path: `chunks` units of `chunk_bytes`
    per row, a ring of `stages` stages, `grid` persistent one-warp CTAs,
    `smem` bytes of dynamic shared memory per CTA; `evict_first` reads
    the rows with an L2 evict-first policy."""
    chunk_bytes: int
    chunks: int
    stages: int
    grid: int
    smem: int
    evict_first: bool


def plan_gather(N: int, W: int, sm_count: int,
                stage_max: int = STAGE_MAX_BYTES,
                ring_bytes: int | None = None,
                ctas_per_sm: int | None = None,
                l2_bytes: int = 0) -> GatherPlan:
    """The bulk path's geometry for N rows of W words (W % 4 == 0): rows
    cut into equal 16-byte-aligned chunks of at most `stage_max` bytes;
    by default SM_STAGE_BYTES // chunk CTAs per SM (1 to MAX_CTAS_PER_SM:
    one lane issues every copy of a CTA, so small rows need more CTAs),
    each with an equal share of RING_BYTES, at least MIN_RING_BYTES; as
    many stages as fit in the ring (2 to 64); and a grid of `ctas_per_sm`
    CTAs per SM or one per unit, whichever is fewer. Where the output
    fits in half of an L2 of `l2_bytes`, the rows, each read once, are
    read evict-first so that they do not push the output out of L2. On
    the H100 that is faster at W=384 and slower at W=16384 (PERF.md)."""
    row_bytes = 4 * W
    chunks = -(-row_bytes // stage_max)
    chunk = (-(-row_bytes // chunks) + 15) // 16 * 16
    if ctas_per_sm is None:
        ctas_per_sm = max(1, min(MAX_CTAS_PER_SM, SM_STAGE_BYTES // chunk))
    if ring_bytes is None:
        ring_bytes = max(MIN_RING_BYTES, RING_BYTES // ctas_per_sm)
    stages = max(_MIN_STAGES, min(_MAX_STAGES, ring_bytes // chunk))
    header = -(-stages * 12 // 128) * 128  # barriers + zero-row flags
    smem = header + (stages + 1) * chunk   # + the zero stage
    grid = max(1, min(N * chunks, ctas_per_sm * sm_count))
    return GatherPlan(chunk, chunks, stages, grid, smem,
                      2 * N * row_bytes <= l2_bytes)


def _check(matrix: torch.Tensor, rows: torch.Tensor) -> None:
    if matrix.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError(f"matrix and rows must be int32, got "
                        f"{matrix.dtype} and {rows.dtype}")
    if matrix.dim() != 2 or rows.dim() != 1:
        raise ValueError(f"want matrix [R, W] and rows [N], got "
                         f"{tuple(matrix.shape)} and {tuple(rows.shape)}")
    if min(*matrix.shape, rows.shape[0]) < 1:
        raise ValueError(f"empty axis in matrix {tuple(matrix.shape)} or "
                         f"rows {tuple(rows.shape)}")
    if not (matrix.is_contiguous() and rows.is_contiguous()):
        raise ValueError("matrix and rows must be contiguous")
    if matrix.device != rows.device:
        raise ValueError(f"matrix on {matrix.device}, rows on "
                         f"{rows.device}")


def dma_gather_rows_reference(matrix: torch.Tensor,
                              rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index_select of the clamped ids, then the
    out-of-range ids' rows zeroed."""
    _check(matrix, rows)
    R = matrix.shape[0]
    idx = rows.long()
    bad = (idx < 0) | (idx >= R)
    out = matrix.index_select(0, idx.clamp(0, R - 1))
    out[bad] = 0
    return out


def _lib():
    from cobs_tpu_torch.ops import _build

    lib = _build.load("dma_gather")
    fn = lib.cobs_dma_gather
    if fn.argtypes is None:  # ctypes caches fn on lib: declare once
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        i32 = ctypes.c_int
        fn.argtypes = [vp, i64, i64, vp, i64, vp, i32, i32, i32, i32, i32,
                       vp]
        fn.restype = ctypes.c_int
    return fn


def dma_gather_rows(matrix: torch.Tensor, rows: torch.Tensor,
                    plan: GatherPlan | None = None) -> torch.Tensor:
    """matrix int32 [R, W], rows int32 [N] -> int32 [N, W] = matrix[rows]
    with zero rows for ids outside [0, R) (module docstring).

    CPU tensors go to the plain version. CUDA tensors launch the kernel
    on the current stream, without synchronizing, or raise: there is no
    fallback. W % 4 == 0 with 16-byte aligned tensors takes the bulk
    path, with `plan` (default `plan_gather`'s; an experiment may pass
    another), anything else the 4-byte path."""
    global LAUNCHES
    _check(matrix, rows)
    if matrix.device.type == "cpu":
        return dma_gather_rows_reference(matrix, rows)
    if matrix.device.type != "cuda":
        raise ValueError(f"no dma_gather_rows kernel for {matrix.device}")
    R, W = matrix.shape
    N = rows.shape[0]
    if -(-N // _ROWS_PER_BLOCK) >= 1 << 31:
        raise ValueError(f"N={N} rows is too many for one launch")
    fn = _lib()
    with torch.cuda.device(matrix.device):
        out = torch.empty((N, W), dtype=torch.int32, device=matrix.device)
        vec = (W % 4 == 0 and matrix.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
        if vec and plan is None:
            props = torch.cuda.get_device_properties(matrix.device)
            plan = plan_gather(N, W, props.multi_processor_count,
                               l2_bytes=props.L2_cache_size)
        chunk, stages, grid, evict = (
            (plan.chunk_bytes, plan.stages, plan.grid, plan.evict_first)
            if vec else (0, 0, 0, False))
        if vec and (plan.smem > SMEM_LIMIT or stages < _MIN_STAGES
                    or chunk < 16 or chunk % 16):
            raise ValueError(f"bad gather plan {plan} for W={W}")
        rc = fn(matrix.data_ptr(), R, W, rows.data_ptr(), N, out.data_ptr(),
                int(vec), chunk, stages, grid, int(evict),
                torch.cuda.current_stream(matrix.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dma_gather kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return out
