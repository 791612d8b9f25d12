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

import ctypes

import torch

#: kernel launches made by `gather_and_count` (CUDA tensors only); a run
#: resets it to show that its main path went through the kernel
LAUNCHES = 0

_THREADS = 128            # word columns per block (csrc/gather_count.cu)
_TILE_TERMS = 32          # row-id tile staged in shared memory per block
_STAGE_WORDS = _THREADS * 33
_SHARED_BYTES = 48 * 1024  # static shared-memory limit without opt-in
_BLOCKS_PER_SM = 8        # target resident blocks when T is split
_MIN_SPLIT_TERMS = 64     # no split range shorter than this
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


def term_splits(B: int, T: int, P: int, W: int, sm_count: int) -> int:
    """How many term ranges the kernel cuts T into: enough blocks for
    about _BLOCKS_PER_SM per SM, no range under _MIN_SPLIT_TERMS terms."""
    base = -(-W // _THREADS) * P * B
    want = -(-_BLOCKS_PER_SM * sm_count // base)
    return max(1, min(want, T // _MIN_SPLIT_TERMS))


def _lib():
    from cobs_tpu_torch.ops import _build

    lib = _build.load("gather_count")
    fn = lib.cobs_gather_count
    if fn.argtypes is None:  # ctypes caches fn on lib: declare once
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong, i32, vp, i32, i32, i32, i32,
                       i32, vp, vp]
        fn.restype = i32
    return fn


def gather_and_count(matrix: torch.Tensor, rows_idx: torch.Tensor,
                     num_hashes: int) -> torch.Tensor:
    """matrix int32 [R+1, W], rows_idx int32 [B, T, h, P] ->
    int32 [B, P*W*32] per-document counts (module docstring).

    CPU tensors go to the twin. CUDA tensors launch the kernel on the
    current stream, without synchronizing, or raise: there is no
    fallback."""
    global LAUNCHES
    _check(matrix, rows_idx, num_hashes)
    if matrix.device.type == "cpu":
        return gather_and_count_reference(matrix, rows_idx, num_hashes)
    if matrix.device.type != "cuda":
        raise ValueError(f"no gather_and_count kernel for {matrix.device}")
    B, T, h, P = rows_idx.shape
    R1, W = matrix.shape
    if (_TILE_TERMS * h + _STAGE_WORDS) * 4 > _SHARED_BYTES:
        raise ValueError(f"num_hashes={h} exceeds the kernel's shared "
                         "memory tile")
    fn = _lib()
    with torch.cuda.device(matrix.device):
        sm = torch.cuda.get_device_properties(matrix.device) \
            .multi_processor_count
        splits = term_splits(B, T, P, W, sm)
        if -(-W // _THREADS) * P * splits * B >= 1 << 31:
            raise ValueError("grid too large for one launch")
        alloc = torch.zeros if splits > 1 else torch.empty
        out = alloc((B, P * W * 32), dtype=torch.int32,
                    device=matrix.device)
        rc = fn(matrix.data_ptr(), R1, W, rows_idx.data_ptr(), B, T, h, P,
                splits, out.data_ptr(),
                torch.cuda.current_stream(matrix.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_count kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return out
