"""Query hashing on the device: window -> canonicalize -> XXH64 -> row id.

`rows_from_queries` is the port of `cobs_tpu/ops/device_hash.py::
rows_from_queries`. In the JAX package this is XLA code inside the scoring
program; here it is the hand-written CUDA kernel `csrc/device_hash.cu`
(built by `_build.load` at first use), launched before the gather-and-count
kernel. On a CPU tensor the wrapper runs the plain version
`rows_from_queries_reference`, built on the port's numpy host pipeline
(`core/canonical.py`, `core/xxh64.py`), which the tests hold against the
JAX package and `chip_smoke.py` holds against the kernel on the card.

Contract (both): qdata uint8 [B, L] (queries padded to a common length L
with any bytes), qlens int32 [B] (true lengths) -> int32 [B, T, h, P],
T = L - k + 1, where entry [b, t, j, p] is
``XXH64(term_t, seed=j) % sig_sizes[p] + row_offsets[p]`` (reference:
cobs/util/misc.hpp:65-72, cobs/query/compact_index/mmap_search_file.cpp:
55-66) and terms at or past ``qlens[b] - k + 1`` point at `zero_row`.
With canonicalize=1 the bytes inside each query's length must be ACGT
(`validate_queries` / `invalid_query_mask` check that on the host, where
the reference dies per query: cobs/query/classic_search.cpp:66-107);
canonicalize=0 (text mode) hashes arbitrary bytes 0..255. The kernel takes
the modulo by Barrett reduction with per-page factors (`barrett_factors`,
kept resident beside sig_sizes and row_offsets by `page_tables`).

Not ported: the 2-bit query packing (`pack_queries_2bit`,
`decode_2bit_device`), a workaround for the TPU's slow host link; the
kernel takes raw bytes.
"""

import collections
import ctypes
import functools

import numpy as np
import torch

from cobs_tpu_torch.core.canonical import canonicalize_batch
from cobs_tpu_torch.core.xxh64 import xxh64_multi_seed
from cobs_tpu_torch.ingest.util import sliding_windows

#: kernel launches made by `rows_from_queries` (CUDA tensors only); a run
#: resets it to show that its main path went through the kernel
LAUNCHES = 0
#: the same launches by CUDA card index: on how many distinct cards a
#: sharded run launched it
LAUNCHES_ON: collections.Counter = collections.Counter()

_THREADS = 128              # terms per block (csrc/device_hash.cu)
_SHARED_BYTES = 48 * 1024   # shared-memory limit without opt-in
_STAGED_BYTES = 4 + 8       # staged bytes besides the tile's windows


def barrett_factors(sig_sizes) -> np.ndarray:
    """uint64 [P]: the Barrett factor floor((2^64 - 1) / sig) of each
    page's signature size, with which the kernel takes x % sig as
    ``r = x - umulhi(x, m) * sig`` and one conditional subtraction. The
    factor is floor(2^64 / sig) except at powers of two, where it is one
    less; the quotient estimate is then still floor(x / sig) or one
    less, so the one correction stays exact, and sig = 1 needs no
    special case."""
    sig = np.asarray(sig_sizes, dtype=np.uint64)
    if (sig == 0).any():
        raise ValueError("signature sizes must be >= 1")
    return np.uint64(0xFFFF_FFFF_FFFF_FFFF) // sig


def _as_int64(name: str, v, device) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.uint64)
                             .astype(np.int64))
    if v.dtype != torch.int64 or v.dim() != 1:
        raise TypeError(f"{name} must be a 1-D int64 tensor or a "
                        f"sequence of ints, got {v.dtype} "
                        f"{tuple(v.shape)}")
    return v.to(device).contiguous()


def page_tables(sig_sizes, row_offsets, device) -> tuple:
    """(sig_sizes, row_offsets, barrett factors) as int64 [P] tensors on
    `device`, the factors' u64 bits viewed as int64: the three per-page
    tables of the kernel, made once so that an index keeps them resident
    (`engine._PageLayout.page_tables`)."""
    sig = _as_int64("sig_sizes", sig_sizes, "cpu")
    mag = torch.from_numpy(barrett_factors(
        sig.numpy().astype(np.uint64)).view(np.int64))
    return (sig.to(device), _as_int64("row_offsets", row_offsets, device),
            mag.to(device))


def _page_tables(sig_sizes, row_offsets, barrett, device) -> tuple:
    """The kernel's three tables on `device`: tensors already there pass
    through, so a caller can keep them resident; the factors are made
    from sig_sizes when none are given."""
    if barrett is None:
        if isinstance(sig_sizes, torch.Tensor):
            sig_sizes = sig_sizes.cpu()
        return page_tables(sig_sizes, row_offsets, device)
    return (_as_int64("sig_sizes", sig_sizes, device),
            _as_int64("row_offsets", row_offsets, device),
            _as_int64("barrett", barrett, device))


def _check(qdata, qlens, term_size, num_hashes, canonicalize, sig_sizes,
           row_offsets) -> None:
    if qdata.dtype != torch.uint8 or qlens.dtype != torch.int32:
        raise TypeError(f"qdata must be uint8 and qlens int32, got "
                        f"{qdata.dtype} and {qlens.dtype}")
    if qdata.dim() != 2 or qlens.shape != qdata.shape[:1]:
        raise ValueError(f"want qdata [B, L] and qlens [B], got "
                         f"{tuple(qdata.shape)} and {tuple(qlens.shape)}")
    if not (qdata.is_contiguous() and qlens.is_contiguous()):
        raise ValueError("qdata and qlens must be contiguous")
    if qdata.device != qlens.device:
        raise ValueError(f"qdata on {qdata.device}, qlens on "
                         f"{qlens.device}")
    B, L = qdata.shape
    if B < 1 or term_size < 1 or L < term_size:
        raise ValueError(f"need B >= 1 and L >= term_size >= 1, got "
                         f"B={B} L={L} term_size={term_size}")
    if num_hashes < 1:
        raise ValueError(f"num_hashes must be >= 1, got {num_hashes}")
    if canonicalize not in (0, 1):
        raise ValueError(f"Unknown canonicalize value {canonicalize}")
    if len(sig_sizes) < 1 or len(sig_sizes) != len(row_offsets):
        raise ValueError(f"{len(sig_sizes)} sig_sizes and "
                         f"{len(row_offsets)} row_offsets")


def rows_from_queries_reference(qdata: torch.Tensor, qlens: torch.Tensor,
                                term_size: int, num_hashes: int,
                                canonicalize: int, sig_sizes, row_offsets,
                                zero_row: int, barrett=None
                                ) -> torch.Tensor:
    """Plain version of the kernel on the host pipeline's numpy: sliding
    windows, `canonicalize_batch`, `xxh64_multi_seed`, a uint64 modulo
    (`barrett`, the kernel's factors, is taken and not used). Returns
    int32 [B, T, h, P] on qdata's device."""
    _check(qdata, qlens, term_size, num_hashes, canonicalize, sig_sizes,
           row_offsets)
    q = qdata.cpu().numpy()
    lens = qlens.cpu().numpy().astype(np.int64)
    sig = np.asarray(sig_sizes.cpu() if isinstance(sig_sizes, torch.Tensor)
                     else sig_sizes).astype(np.uint64)
    off = np.asarray(row_offsets.cpu()
                     if isinstance(row_offsets, torch.Tensor)
                     else row_offsets).astype(np.uint64)
    B, L = q.shape
    k = term_size
    T = L - k + 1
    windows = np.concatenate([sliding_windows(row, k) for row in q])
    if canonicalize == 1:
        windows, _ = canonicalize_batch(windows)
    hashes = xxh64_multi_seed(np.ascontiguousarray(windows), num_hashes)
    rows = (hashes[:, :, None] % sig[None, None, :]
            + off[None, None, :]).astype(np.int32)
    rows = rows.reshape(B, T, num_hashes, len(sig))
    valid = np.arange(T)[None, :] < (lens[:, None] - (k - 1))
    rows = np.where(valid[:, :, None, None], rows, np.int32(zero_row))
    return torch.from_numpy(rows).to(qdata.device)


def _lib():
    from cobs_tpu_torch.ops import _build

    lib = _build.load("device_hash")
    fn = lib.cobs_device_hash
    if fn.argtypes is None:  # ctypes caches fn on lib: declare once
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i32, i32, i32, i32, i32, i32, vp, vp, vp,
                       i32, vp, vp]
        fn.restype = i32
    return fn


def rows_from_queries(qdata: torch.Tensor, qlens: torch.Tensor,
                      term_size: int, num_hashes: int, canonicalize: int,
                      sig_sizes, row_offsets, zero_row: int,
                      barrett=None) -> torch.Tensor:
    """qdata uint8 [B, L], qlens int32 [B] -> int32 [B, T, h, P] row ids
    (module docstring). sig_sizes / row_offsets: per-page sequences, or
    int64 tensors already on qdata's device; barrett: the kernel's
    per-page Barrett factors as `page_tables` makes them (made here from
    sig_sizes when None; the plain version takes a true `%`).

    CPU tensors go to the plain version. CUDA tensors launch the kernel
    on the current stream, without synchronizing, or raise: there is no
    fallback."""
    global LAUNCHES
    _check(qdata, qlens, term_size, num_hashes, canonicalize, sig_sizes,
           row_offsets)
    if qdata.device.type == "cpu":
        return rows_from_queries_reference(
            qdata, qlens, term_size, num_hashes, canonicalize, sig_sizes,
            row_offsets, zero_row, barrett)
    if qdata.device.type != "cuda":
        raise ValueError(f"no rows_from_queries kernel for {qdata.device}")
    B, L = qdata.shape
    T = L - term_size + 1
    P = len(sig_sizes)
    if _THREADS + term_size - 1 + _STAGED_BYTES > _SHARED_BYTES:
        raise ValueError(f"term_size={term_size} exceeds the kernel's "
                         "shared-memory window")
    if L >= 1 << 31 or -(-T // _THREADS) * B >= 1 << 31:
        raise ValueError("query batch too large for one launch")
    if not 0 <= zero_row < 1 << 31:
        raise ValueError(f"zero_row={zero_row} is not an int32 row id")
    fn = _lib()
    with torch.cuda.device(qdata.device):
        sig, off, mag = _page_tables(sig_sizes, row_offsets, barrett,
                                     qdata.device)
        out = torch.empty((B, T, num_hashes, P), dtype=torch.int32,
                          device=qdata.device)
        rc = fn(qdata.data_ptr(), qlens.data_ptr(), B, L, term_size,
                num_hashes, canonicalize, P, sig.data_ptr(), off.data_ptr(),
                mag.data_ptr(), zero_row, out.data_ptr(),
                torch.cuda.current_stream(qdata.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"device_hash kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES += 1
    LAUNCHES_ON[qdata.device.index] += 1
    return out


@functools.lru_cache(maxsize=None)
def _valid_dna() -> np.ndarray:
    ok = np.zeros(256, dtype=bool)
    ok[list(b"ACGT")] = True
    return ok


def invalid_query_mask(arr: np.ndarray, canonicalize: int) -> np.ndarray:
    """bool [B]: True where a row of uint8 [B, L] holds a non-ACGT byte
    (always False in text mode, canonicalize=0); the batch form of
    validate_queries for queries of one length."""
    if canonicalize != 1 or not arr.tobytes().translate(None, b"ACGT"):
        # text mode, or every byte is ACGT (one C-speed pass; the
        # per-row table lookup below costs ~3x more)
        return np.zeros(arr.shape[0], dtype=bool)
    return ~np.take(_valid_dna(), arr).all(axis=1)


def validate_queries(queries: list[bytes], term_size: int,
                     canonicalize: int) -> None:
    """Host-side error parity for device hashing: the reference dies per
    query on non-ACGT letters and on too-short queries (reference:
    cobs/query/classic_search.cpp:66-107)."""
    ok = _valid_dna()
    for q in queries:
        if len(q) < term_size:
            raise ValueError(
                f"query too short, needs to be at least {term_size} "
                "characters long")
        if canonicalize == 1 and not ok[
                np.frombuffer(q, dtype=np.uint8)].all():
            raise ValueError("Invalid DNA base pair in query string. "
                             "Only ACGT are allowed.")
