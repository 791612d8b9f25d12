"""Fused row gather -> AND -> per-document count: the query hot loop.

`gather_and_count` is the port of
`cobs_tpu/ops/query_kernel.py::gather_and_count_pallas`. On a CUDA tensor
it launches the hand-written Hopper kernel in `csrc/gather_count.cu`
(built by `_build.load` at first use); on a CPU tensor it runs the plain
PyTorch twin `gather_and_count_reference`, which the tests hold against
the JAX package and `chip_smoke.py` holds against the kernel on the card.

Contract (both): matrix int32 [R+1, W] (the u32 words, bit for bit; the
last row is all zero), rows_idx int32 [B, T, h, P] (padding terms point at
the zero row) -> int32 [B, P*W*32] counts in document order,
doc = (page*W + word)*32 + bit. Row ids outside [0, R] count as the zero
row in both.
"""

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

#: kernel launches made by `gather_and_count` (CUDA tensors only); a run
#: resets it to show that its main path went through the kernel
LAUNCHES = 0
#: the same launches by CUDA card index: on how many distinct cards a
#: sharded run launched it
LAUNCHES_ON: collections.Counter = collections.Counter()

#: geometry of csrc/gather_count.cu: 128 consumer threads own up to 4
#: words each (a slice of <= 512 words), plus one producer warp
_CONSUMERS = 128
_THREADS = _CONSUMERS + 32
MAX_SLICE_WORDS = 4 * _CONSUMERS
_STRIDE = 33              # padded stride of a word's 32 counts
MAX_CLUSTER = 8           # portable thread-block cluster size
#: the ring of stages per CTA: a stage holds up to MAX_STAGE_ROWS row
#: slices (a power of 2) in at most STAGE_BYTES, the ring at most
#: RING_BYTES in _MIN_STAGES to _MAX_STAGES stages
STAGE_BYTES = 8 << 10
MAX_STAGE_ROWS = 8
RING_BYTES = 24 << 10
_MIN_STAGES, _MAX_STAGES = 4, 64
#: a CTA's fixed cost (count flush, cluster reduction) in row slices
_CTA_OVERHEAD_ROWS = 16
#: shared memory of an SM, of a block (opt-in), and reserved per block,
#: and resident threads per SM (H100, sm_90)
SM_SMEM = 233_472
SMEM_LIMIT = 232_448
_SMEM_PER_BLOCK = 1024
_SM_THREADS = 2048
#: bound on the twin's intermediates per term chunk (bytes)
_TWIN_BYTES = 1 << 30


def _check(matrix: torch.Tensor, rows_idx: torch.Tensor,
           num_hashes: int) -> None:
    if matrix.dtype != torch.int32 or rows_idx.dtype != torch.int32:
        raise TypeError(f"matrix and rows_idx must be int32, got "
                        f"{matrix.dtype} and {rows_idx.dtype}")
    if matrix.dim() != 2 or rows_idx.dim() != 4:
        raise ValueError(f"want matrix [R+1, W] and rows_idx [B, T, h, P], "
                         f"got {tuple(matrix.shape)} and "
                         f"{tuple(rows_idx.shape)}")
    if not (matrix.is_contiguous() and rows_idx.is_contiguous()):
        raise ValueError("matrix and rows_idx must be contiguous")
    B, T, h, P = rows_idx.shape
    R1, W = matrix.shape
    if h != num_hashes:
        raise ValueError(f"rows_idx has {h} hashes per term, "
                         f"num_hashes is {num_hashes}")
    if min(B, T, h, P, R1, W) < 1:
        raise ValueError(f"empty axis in matrix {tuple(matrix.shape)} or "
                         f"rows_idx {tuple(rows_idx.shape)}")
    if R1 > 1 << 31:
        raise ValueError("int32 row ids cannot reach the zero row of a "
                         f"{R1}-row matrix")
    if matrix.device != rows_idx.device:
        raise ValueError(f"matrix on {matrix.device}, rows_idx on "
                         f"{rows_idx.device}")


def gather_and_count_reference(matrix: torch.Tensor, rows_idx: torch.Tensor,
                               num_hashes: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: index_select, &, and
    (x >> i) & 1 summed over terms for each bit i. Streams the term axis
    in chunks so its intermediates stay under about _TWIN_BYTES."""
    _check(matrix, rows_idx, num_hashes)
    B, T, h, P = rows_idx.shape
    R1, W = matrix.shape
    idx = rows_idx.long()
    idx = torch.where((idx < 0) | (idx >= R1), R1 - 1, idx)
    out = torch.zeros((B, P, W, 32), dtype=torch.int32, device=matrix.device)
    # the gathered chunk [B, tc, h, P, W] plus the AND and bit temporaries
    chunk = max(1, _TWIN_BYTES // (B * P * W * 4 * (h + 3)))
    for t0 in range(0, T, chunk):
        sub = idx[:, t0:t0 + chunk]
        tc = sub.shape[1]
        g = matrix.index_select(0, sub.reshape(-1)).view(B, tc, h, P, W)
        anded = g[:, :, 0]
        for j in range(1, h):
            anded = anded & g[:, :, j]
        for i in range(32):
            out[..., i] += ((anded >> i) & 1).sum(dim=1, dtype=torch.int32)
    return out.reshape(B, P * W * 32)


def _align128(x: int) -> int:
    return -(-x // 128) * 128


class GatherCountPlan(NamedTuple):
    """Launch geometry of csrc/gather_count.cu: W cut into `n_slices`
    slices of `slice_w` words (`wpt` words per consumer thread); each
    (query, page, slice) one cluster of `cluster` CTAs, CTA rank r
    counting terms [r * tpc, (r + 1) * tpc); a ring of `stages` stages
    of `stage_rows` row slices each; `smem` bytes of dynamic shared memory
    per CTA, `per_sm` CTAs resident per SM, `grid` CTAs in all."""
    slice_w: int
    n_slices: int
    wpt: int
    cluster: int
    tpc: int
    stages: int
    stage_rows: int
    smem: int
    per_sm: int
    grid: int


def _slices(W: int, n: int) -> tuple[int, int]:
    """(slice_w, n_slices): W cut into about n slices, as equal as
    16-byte steps allow."""
    slice_w = -(-(-(-W // n)) // 4) * 4
    return slice_w, -(-W // slice_w)


def _ring(slice_w: int, ring_bytes: int) -> tuple[int, int, int, int]:
    """(stages, stage_rows, smem, per_sm) of a CTA with this slice
    width (a multiple of 4 words)."""
    row = 4 * slice_w
    rows = 1
    while rows < MAX_STAGE_ROWS and 2 * rows * row <= STAGE_BYTES:
        rows *= 2
    stages = max(_MIN_STAGES, min(_MAX_STAGES, ring_bytes // (rows * row)))
    smem = (_align128(16 * stages) + _align128(4 * _STRIDE * slice_w)
            + stages * rows * row)
    per_sm = max(1, min(SM_SMEM // (smem + _SMEM_PER_BLOCK),
                        _SM_THREADS // _THREADS))
    return stages, rows, smem, per_sm


def plan_gather_count(B: int, T: int, h: int, P: int, W: int,
                      sm_count: int, ring_bytes: int = RING_BYTES,
                      max_clusters=None) -> GatherCountPlan:
    """The kernel's geometry for rows_idx [B, T, h, P] over W words.

    Slices are as equal as 16-byte steps allow, at most 512 words, and
    narrower (down to 128) while even clusters of MAX_CLUSTER CTAs would
    leave the card under one wave. The ring holds as many stages of
    `stage_rows` row slices (a power of 2 up to 8, in at most
    STAGE_BYTES) as fit in `ring_bytes` (4 to 64). The cluster size
    (1..MAX_CLUSTER, at most T) is the one that minimises waves x (row
    slices per CTA + a CTA's fixed cost). A wave is as many clusters as
    the card holds at once: `max_clusters(slice_w, stages, stage_rows,
    wpt, cluster)` where given (the wrapper asks the CUDA occupancy API,
    since a cluster must fit in one GPC), else every SM holding as many
    CTAs as its shared memory and threads allow."""
    slice_w, n_slices = _slices(W, -(-W // MAX_SLICE_WORDS))
    stages, rows, smem, per_sm = _ring(slice_w, ring_bytes)
    n = n_slices
    while B * P * n_slices * min(MAX_CLUSTER, T) < per_sm * sm_count:
        n += 1
        narrower = _slices(W, n)
        if narrower[0] < _CONSUMERS:
            break
        slice_w, n_slices = narrower
        stages, rows, smem, per_sm = _ring(slice_w, ring_bytes)
    wpt = -(-slice_w // _CONSUMERS)
    clusters = B * P * n_slices
    best = None
    for cs in range(1, min(MAX_CLUSTER, T) + 1):
        tpc = -(-T // cs)
        cs = -(-T // tpc)              # no CTA without terms
        resident = (max_clusters(slice_w, stages, rows, wpt, cs)
                    if max_clusters
                    else per_sm * sm_count // cs)
        waves = -(-clusters // max(1, resident))
        cost = waves * (tpc * h + _CTA_OVERHEAD_ROWS)
        if best is None or cost < best[0]:
            best = (cost, cs, tpc)
    _, cs, tpc = best
    return GatherCountPlan(slice_w, n_slices, wpt, cs, tpc, stages, rows,
                           smem, per_sm, clusters * cs)


def _lib():
    from cobs_tpu_torch.ops import _build

    lib = _build.load("gather_count")
    if lib.cobs_gather_count.argtypes is None:  # ctypes caches: declare once
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cobs_gather_count.argtypes = [
            vp, ctypes.c_longlong, i32, vp, i32, i32, i32, i32, i32, i32,
            i32, i32, i32, i32, i32, i32, vp, vp]
        lib.cobs_gather_count.restype = i32
        lib.cobs_gather_count_max_clusters.argtypes = [i32] * 6
        lib.cobs_gather_count_max_clusters.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _max_clusters(device: int, slice_w: int, stages: int, stage_rows: int,
                  wpt: int, cluster: int) -> int:
    """Clusters of this geometry that card `device` holds at once (the
    4-byte path's variants use the same shared memory and threads)."""
    with torch.cuda.device(device):
        n = _lib().cobs_gather_count_max_clusters(slice_w, stages,
                                                  stage_rows, wpt, 1,
                                                  cluster)
    if n < 0:
        raise RuntimeError(f"gather_count occupancy query failed: CUDA "
                           f"error {-n}")
    return n


@functools.lru_cache(maxsize=256)
def launch_plan(device: int, B: int, T: int, h: int, P: int,
                W: int) -> GatherCountPlan:
    """`gather_and_count`'s default plan on CUDA card `device`."""
    return plan_gather_count(
        B, T, h, P, W,
        torch.cuda.get_device_properties(device).multi_processor_count,
        max_clusters=functools.partial(_max_clusters, device))


def _check_plan(plan: GatherCountPlan, B: int, T: int, P: int,
                W: int) -> None:
    ok = (plan.smem <= SMEM_LIMIT and 1 <= plan.cluster <= MAX_CLUSTER
          and plan.cluster * plan.tpc >= T and plan.slice_w % 4 == 0
          and 0 < plan.slice_w <= plan.wpt * _CONSUMERS <= MAX_SLICE_WORDS
          and plan.slice_w * plan.n_slices >= W > plan.slice_w
          * (plan.n_slices - 1) and plan.stages >= 2
          and plan.stage_rows in (1, 2, 4, 8, 16, 32)
          and plan.grid == B * P * plan.n_slices * plan.cluster)
    if not ok:
        raise ValueError(f"bad gather_and_count plan {plan} for B={B} "
                         f"T={T} P={P} W={W}")


def gather_and_count(matrix: torch.Tensor, rows_idx: torch.Tensor,
                     num_hashes: int,
                     plan: GatherCountPlan | None = None) -> torch.Tensor:
    """matrix int32 [R+1, W], rows_idx int32 [B, T, h, P] ->
    int32 [B, P*W*32] per-document counts (module docstring).

    CPU tensors go to the twin. CUDA tensors launch the kernel on the
    current stream, without synchronizing, or raise: there is no
    fallback. The launch geometry is `plan_gather_count`'s unless a test
    or an experiment passes another `plan`."""
    global LAUNCHES
    _check(matrix, rows_idx, num_hashes)
    if matrix.device.type == "cpu":
        return gather_and_count_reference(matrix, rows_idx, num_hashes)
    if matrix.device.type != "cuda":
        raise ValueError(f"no gather_and_count kernel for {matrix.device}")
    B, T, h, P = rows_idx.shape
    R1, W = matrix.shape
    fn = _lib().cobs_gather_count
    with torch.cuda.device(matrix.device):
        if plan is None:
            plan = launch_plan(matrix.device.index, B, T, h, P, W)
        _check_plan(plan, B, T, P, W)
        if plan.grid >= 1 << 31:
            raise ValueError("grid too large for one launch")
        out = torch.empty((B, P * W * 32), dtype=torch.int32,
                          device=matrix.device)
        bulk = int(W % 4 == 0 and matrix.data_ptr() % 16 == 0)
        rc = fn(matrix.data_ptr(), R1, W, rows_idx.data_ptr(), B, T, h, P,
                plan.slice_w, plan.n_slices, plan.wpt, plan.cluster,
                plan.tpc, plan.stages, plan.stage_rows, bulk, out.data_ptr(),
                torch.cuda.current_stream(matrix.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_count kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    LAUNCHES_ON[matrix.device.index] += 1
    return out
