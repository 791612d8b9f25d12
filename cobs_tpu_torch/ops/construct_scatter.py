"""Construction bit scatter: the Bloom bits of (row, document) updates set
into a batch's packed word matrix, held word-major on the device.

`construct_scatter` is the port of the jitted XLA scatter and pack of
`cobs_tpu/construct/device.py` (`_scatter_single` :46, `_pack_plane` :86)
for one device. On a CUDA tensor it launches the hand-written Hopper
kernels in `csrc/construct_scatter.cu` (built by `_build.load` at first
use): for a full chunk they bin the updates by row block and OR each bin
into a shared-memory tile of its strip; a small chunk (or a matrix with
too many row blocks) takes one pass that ORs each bit straight into the
words with an atomic (`plan_scatter` decides). On a CPU tensor it runs
the plain PyTorch version `construct_scatter_reference`, the JAX math: a
u8 indicator plane set by `index_put_`, then packed and transposed.

Contract (both): words int32 [Wc, R1], word-major: words[c, r] is u32 word
c of Bloom row r, bit for bit (bit d % 32 of word d // 32 is document d),
so `words.t()` has the `.cobs_classic` row layout in its little-endian
bytes; rows and docs int32 [n]; the update i sets bit docs[i] of row
rows[i], in place. Updates outside [0, R1) x [0, 32 * Wc) are dropped, as
the JAX scatter's mode="drop" drops ids past the end (JAX wraps negative
ids first; construction makes none). OR is idempotent and commutes,
so the result does not depend on the order of the updates or on
duplicates. All updates of a document land in one strip words[d // 32],
which is why the layout is word-major: a launch's updates, a few
documents' worth, then set bits in one or two strips that the L2 holds
(`csrc/construct_scatter.cu`).
"""

import collections
import ctypes
from typing import NamedTuple

import torch

#: kernel launches made by `construct_scatter` (CUDA tensors only); a run
#: resets it to show that its path went through the kernel
LAUNCHES = 0
#: the same launches by CUDA card index: on how many distinct cards a
#: sharded run launched it
LAUNCHES_ON: collections.Counter = collections.Counter()

_THREADS = 256        # threads per block (csrc/construct_scatter.cu)
_BLOCKS_PER_SM = 8    # grid-stride loop: enough blocks to fill the card

#: rows per bin of the binned kernel (csrc/construct_scatter.cu kRowBlock)
ROW_BLOCK = 1 << 14
#: most bins (strip slots x row blocks) the binned kernel takes (kMaxBins)
MAX_BINS = 8192
#: strip slots: the strips from one below the chunk's first document's
#: (the device build's workers stage neighbouring documents)
MAX_SLOTS = 4
#: chunks with fewer updates take the one-pass kernel: binning's two
#: launches and zeroed cursors do not pay for themselves there
MIN_BINNED = 1 << 16
#: ints per bin cursor (kCursorStride): one 128-byte line each
CURSOR_STRIDE = 32


class ScatterPlan(NamedTuple):
    """How `construct_scatter` launches: the one-pass kernel (binned =
    False), or binning by row block into `slots` x `nblk` bins of `cap`
    entries each (csrc/construct_scatter.cu, step 2)."""
    binned: bool
    slots: int = 0
    nblk: int = 0
    cap: int = 0


def plan_scatter(n: int, R1: int, Wc: int) -> ScatterPlan:
    """The launch plan for n updates into words [Wc, R1]: binned when the
    chunk is large enough and the bins fit the kernel's histogram and
    int32 scratch indices. A bin holds a quarter more than its share of
    the chunk as if every update fell in one strip, plus 256, rounded up
    to a multiple of 4 (the kernel reads a bin 16 bytes at a time);
    updates past a bin's capacity (a skewed chunk) are ORed straight into
    device memory, so any capacity is correct."""
    slots = min(MAX_SLOTS, Wc)
    nblk = -(-R1 // ROW_BLOCK)
    cap = -(-(-(-5 * n // (4 * nblk)) + 256) // 4) * 4
    if n < MIN_BINNED or slots * nblk > MAX_BINS or \
            slots * nblk * cap >= 1 << 31:
        return ScatterPlan(False)
    return ScatterPlan(True, slots, nblk, cap)


def _check(words: torch.Tensor, rows: torch.Tensor,
           docs: torch.Tensor) -> None:
    if (words.dtype, rows.dtype, docs.dtype) != (torch.int32,) * 3:
        raise TypeError(f"words, rows and docs must be int32, got "
                        f"{words.dtype}, {rows.dtype} and {docs.dtype}")
    if words.dim() != 2 or rows.dim() != 1 or rows.shape != docs.shape:
        raise ValueError(f"want words [Wc, R1] and rows, docs [n], got "
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
    ones at the in-range updates, packed, transposed to the word-major
    [Wc, R1] and ORed into `words`."""
    _check(words, rows, docs)
    Wc, R1 = words.shape
    r, d = rows.long(), docs.long()
    ok = (r >= 0) & (r < R1) & (d >= 0) & (d < 32 * Wc)
    plane = torch.zeros((R1, 32 * Wc), dtype=torch.uint8,
                        device=words.device)
    plane.index_put_((r[ok], d[ok]),
                     torch.ones((), dtype=torch.uint8, device=words.device))
    return words.bitwise_or_(pack_plane(plane).t())


def _lib():
    from cobs_tpu_torch.ops import _build

    lib = _build.load("construct_scatter")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn, argtypes in (
            (lib.cobs_construct_scatter, [vp, i64, i64, vp, vp, i64, i32,
                                          vp]),
            (lib.cobs_construct_scatter_binned, [vp, i64, i64, vp, vp, i64,
                                                 i32, i32, i64, vp, vp,
                                                 vp])):
        if fn.argtypes is None:  # ctypes caches fn on lib: declare once
            fn.argtypes = argtypes
            fn.restype = i32
    return lib


def construct_scatter(words: torch.Tensor, rows: torch.Tensor,
                      docs: torch.Tensor,
                      plan: ScatterPlan | None = None) -> torch.Tensor:
    """words int32 [Wc, R1] |= the bits of the updates (rows, docs) int32
    [n], in place; returns words (module docstring).

    CPU tensors go to the plain version. CUDA tensors launch the kernel on
    the current stream, without synchronizing, or raise: there is no
    fallback. `plan` (default `plan_scatter`) picks the one-pass kernel
    or binning; the binned kernel's scratch and zeroed cursors are
    allocated here. The kernel reads rows and docs 16 bytes at a time;
    views that do not start on a 16-byte boundary are copied first.
    n == 0 launches nothing."""
    global LAUNCHES
    _check(words, rows, docs)
    if words.device.type == "cpu":
        return construct_scatter_reference(words, rows, docs)
    if words.device.type != "cuda":
        raise ValueError(f"no construct_scatter kernel for {words.device}")
    n = rows.shape[0]
    if n == 0:
        return words
    Wc, R1 = words.shape
    plan = plan or plan_scatter(n, R1, Wc)
    lib = _lib()
    if rows.data_ptr() % 16:
        rows = rows.clone()
    if docs.data_ptr() % 16:
        docs = docs.clone()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        if plan.binned:
            bins = plan.slots * plan.nblk
            scratch = torch.empty(bins * plan.cap, dtype=torch.int32,
                                  device=words.device)
            cursor = torch.zeros(bins * CURSOR_STRIDE, dtype=torch.int32,
                                 device=words.device)
            rc = lib.cobs_construct_scatter_binned(
                words.data_ptr(), R1, Wc, rows.data_ptr(), docs.data_ptr(),
                n, plan.slots, plan.nblk, plan.cap, scratch.data_ptr(),
                cursor.data_ptr(), stream)
        else:
            sms = torch.cuda.get_device_properties(
                words.device).multi_processor_count
            # a thread takes four updates per step (one 16-byte load each)
            grid = min(-(-n // (4 * _THREADS)), _BLOCKS_PER_SM * sms)
            rc = lib.cobs_construct_scatter(
                words.data_ptr(), R1, Wc, rows.data_ptr(), docs.data_ptr(),
                n, grid, stream)
    if rc != 0:
        raise RuntimeError(f"construct_scatter kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    LAUNCHES_ON[words.device.index] += 1
    return words
