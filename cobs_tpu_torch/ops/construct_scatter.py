"""Construction bit scatter: the Bloom bits of (row, document) updates set
into a batch's packed word matrix.

`construct_scatter` is the port of the jitted XLA scatter and pack of
`cobs_tpu/construct/device.py` (`_scatter_single` :46, `_pack_plane` :86)
for one device. On a CUDA tensor it launches the hand-written Hopper
kernel in `csrc/construct_scatter.cu` (built by `_build.load` at first
use), which ORs each bit straight into the words with an atomic; on a CPU
tensor it runs the plain PyTorch version `construct_scatter_reference`,
the JAX math: a u8 indicator plane set by `index_put_`, then packed.

Contract (both): words int32 [R1, Wc] (u32 words, bit for bit; bit d % 32
of word d // 32 is document d, so the little-endian bytes are the
`.cobs_classic` row layout), rows and docs int32 [n]; the update i sets
bit docs[i] of row rows[i], in place. Updates outside [0, R1) x
[0, 32 * Wc) are dropped, as the JAX scatter's mode="drop" drops them.
OR is idempotent and commutes, so the result does not depend on the order
of the updates or on duplicates.
"""

import ctypes

import torch

#: kernel launches made by `construct_scatter` (CUDA tensors only); a run
#: resets it to show that its path went through the kernel
LAUNCHES = 0

_THREADS = 256        # threads per block (csrc/construct_scatter.cu)
_BLOCKS_PER_SM = 8    # grid-stride loop: enough blocks to fill the card


def _check(words: torch.Tensor, rows: torch.Tensor,
           docs: torch.Tensor) -> None:
    if (words.dtype, rows.dtype, docs.dtype) != (torch.int32,) * 3:
        raise TypeError(f"words, rows and docs must be int32, got "
                        f"{words.dtype}, {rows.dtype} and {docs.dtype}")
    if words.dim() != 2 or rows.dim() != 1 or rows.shape != docs.shape:
        raise ValueError(f"want words [R1, Wc] and rows, docs [n], got "
                         f"{tuple(words.shape)}, {tuple(rows.shape)} and "
                         f"{tuple(docs.shape)}")
    if not (words.is_contiguous() and rows.is_contiguous()
            and docs.is_contiguous()):
        raise ValueError("words, rows and docs must be contiguous")
    if not words.device == rows.device == docs.device:
        raise ValueError(f"words on {words.device}, rows on {rows.device}, "
                         f"docs on {docs.device}")


def pack_plane(plane: torch.Tensor) -> torch.Tensor:
    """u8 indicator plane [R1, D] (D % 32 == 0) -> int32 words
    [R1, D // 32], bit d % 32 of word d // 32 set iff plane[:, d] != 0
    (`_pack_plane`). Packed a byte at a time, since torch on the CPU
    shifts no uint32; the bytes viewed little-endian are the words."""
    R1, D = plane.shape
    bits = plane.view(R1, D // 8, 8)
    out = bits[..., 0].contiguous()
    for j in range(1, 8):
        out |= bits[..., j] << j
    return out.view(torch.int32)


def construct_scatter_reference(words: torch.Tensor, rows: torch.Tensor,
                                docs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a u8 plane [R1, 32 * Wc] with index_put_ of
    ones at the in-range updates, packed and ORed into `words`."""
    _check(words, rows, docs)
    R1, Wc = words.shape
    r, d = rows.long(), docs.long()
    ok = (r >= 0) & (r < R1) & (d >= 0) & (d < 32 * Wc)
    plane = torch.zeros((R1, 32 * Wc), dtype=torch.uint8,
                        device=words.device)
    plane.index_put_((r[ok], d[ok]),
                     torch.ones((), dtype=torch.uint8, device=words.device))
    return words.bitwise_or_(pack_plane(plane))


def _lib():
    from cobs_tpu_torch.ops import _build

    fn = _build.load("construct_scatter").cobs_construct_scatter
    if fn.argtypes is None:  # ctypes caches fn on lib: declare once
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [vp, i64, i64, vp, vp, i64, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


def construct_scatter(words: torch.Tensor, rows: torch.Tensor,
                      docs: torch.Tensor) -> torch.Tensor:
    """words int32 [R1, Wc] |= the bits of the updates (rows, docs) int32
    [n], in place; returns words (module docstring).

    CPU tensors go to the plain version. CUDA tensors launch the kernel on
    the current stream, without synchronizing, or raise: there is no
    fallback. n == 0 launches nothing."""
    global LAUNCHES
    _check(words, rows, docs)
    if words.device.type == "cpu":
        return construct_scatter_reference(words, rows, docs)
    if words.device.type != "cuda":
        raise ValueError(f"no construct_scatter kernel for {words.device}")
    n = rows.shape[0]
    if n == 0:
        return words
    fn = _lib()
    with torch.cuda.device(words.device):
        sms = torch.cuda.get_device_properties(
            words.device).multi_processor_count
        grid = min(-(-n // _THREADS), _BLOCKS_PER_SM * sms)
        rc = fn(words.data_ptr(), words.shape[0], words.shape[1],
                rows.data_ptr(), docs.data_ptr(), n, grid,
                torch.cuda.current_stream(words.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"construct_scatter kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return words
