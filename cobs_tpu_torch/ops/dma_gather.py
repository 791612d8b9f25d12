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

import torch

#: kernel launches made by `dma_gather_rows` (CUDA tensors only); a run
#: resets it to show that its path went through the kernel
LAUNCHES = 0

_ROWS_PER_BLOCK = 8   # warps per block, one row each (csrc/dma_gather.cu)


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
        fn.argtypes = [vp, i64, i64, vp, i64, vp, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def dma_gather_rows(matrix: torch.Tensor, rows: torch.Tensor
                    ) -> torch.Tensor:
    """matrix int32 [R, W], rows int32 [N] -> int32 [N, W] = matrix[rows]
    with zero rows for ids outside [0, R) (module docstring).

    CPU tensors go to the plain version. CUDA tensors launch the kernel
    on the current stream, without synchronizing, or raise: there is no
    fallback."""
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
        vec = int(W % 4 == 0 and matrix.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        rc = fn(matrix.data_ptr(), R, W, rows.data_ptr(), N, out.data_ptr(),
                vec, torch.cuda.current_stream(matrix.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dma_gather kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    return out
