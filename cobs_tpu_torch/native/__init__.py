"""Host C++ runtime of the port, built with g++ at first use and bound
with ctypes.

`native.cpp` holds the port's own copy of cobs_tpu/native/native.cpp's
construction and query-path entry points (the port never imports
cobs_tpu): batched XXH64 (`xxh64_batch`), the fused canonicalize + hash +
mod of construction (`window_rows`, which takes the sequence path for
sliding-window views, `window_hashes`), the random-document rows of
`classic_construct_random` (`random_rows`), the host bit scatter
(`set_bits`), the threaded scattered row copy (`gather_rows`), the host
gather/AND/expand-add scorer (`score_batch_host`) and the io_uring row
gather of cold-cache serving (`gather_rows_file`, `uring_supported`,
`dontcache_supported`). The
first call of any of them compiles the source into
`cobs_tpu_torch/_build/` (listed in `.gitignore`), named by a hash of
the source, the flags and, for `-march=native`, this machine's CPU
flags, so a build made for another CPU is never loaded. It tries
`g++ -O3 -march=native` (the AVX-512BW / AVX2 paths of the scorer), then
plain `-O3`, and raises if both fail: nothing falls back to numpy.
ctypes releases the GIL for the length of every call. Nothing here runs
at import.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from cobs_tpu_torch.ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "native.cpp"
#: g++ flag sets, tried in order
FLAG_SETS = (("-O3", "-march=native"), ("-O3",))

_lock = threading.Lock()
_lib = None

#: io_uring availability: None = not tried yet, False = setup failed once
#: (seccomp or an old kernel), so later gathers skip the syscall
_uring_ok: bool | None = None
#: RWF_DONTCACHE support: None = no gather has asked for it yet, False =
#: the kernel or the filesystem rejected the flag (reads went through the
#: page cache)
_dontcache_ok: bool | None = None


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return os.uname().machine.encode()


def _so_path(src: bytes, flags) -> Path:
    h = hashlib.sha256(src + b"\0" + " ".join(flags).encode())
    if "-march=native" in flags:
        h.update(_cpu_flags())
    return BUILD_DIR / f"libcobs_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    src = _SRC.read_bytes()
    errors = []
    for flags in FLAG_SETS:
        so = _so_path(src, flags)
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # several test processes may build at once: each writes its own
        # temporary file and renames it into place atomically
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17", "-pthread",
               "-o", str(tmp), str(_SRC)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{' '.join(cmd)}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(cmd)}:\n{proc.stderr.strip()}")
    raise RuntimeError("building the port's host library failed:\n" + "\n".join(errors))


def lib() -> ctypes.CDLL:
    """The loaded library, built first if this source has no build yet.
    Raises RuntimeError if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(_build()))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            u64 = ctypes.c_uint64
            L.cobs_xxh64_batch.argtypes = [p, i64, i64, u64, p]
            L.cobs_xxh64_batch.restype = None
            for fn in (L.cobs_sequence_rows_mt, L.cobs_window_rows_mt):
                fn.argtypes = [p, i64, i64, i64, u64, i32, p, i32]
                fn.restype = i32
            for fn in (L.cobs_sequence_rows, L.cobs_window_rows):
                fn.argtypes = [p, i64, i64, i64, u64, i32, p]
                fn.restype = i32
            L.cobs_window_hashes.argtypes = [p, i64, i64, i64, i32, p]
            L.cobs_window_hashes.restype = i32
            L.cobs_random_rows.argtypes = [u64, i64, i64, i64, u64, p]
            L.cobs_random_rows.restype = i32
            L.cobs_set_bits.argtypes = [p, i64, p, i64, i64]
            L.cobs_set_bits.restype = None
            L.cobs_gather_rows.argtypes = [p, i64, p, i64, p, i64, i32]
            L.cobs_gather_rows.restype = None
            L.cobs_score_batch.argtypes = [p, i64, p, i64, i64, i64, i64,
                                           i64, p, i32]
            L.cobs_score_batch.restype = None
            L.cobs_gather_rows_file.argtypes = [i32, i64, i64, p, i64, p,
                                                i64, i32, i32]
            L.cobs_gather_rows_file.restype = i32
            _lib = L
        return _lib


def xxh64_batch(data, seed: int) -> np.ndarray:
    """XXH64 of each row of data uint8 [n, len] with one seed -> u64 [n]
    (`cobs_xxh64_batch`)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.ndim != 2:
        raise ValueError(f"data must be [n, len], got {data.shape}")
    out = np.empty(data.shape[0], dtype=np.uint64)
    lib().cobs_xxh64_batch(data.ctypes.data, data.shape[0], data.shape[1],
                           seed & (2**64 - 1), out.ctypes.data)
    return out


def _windows(windows) -> np.ndarray:
    windows = np.asarray(windows, dtype=np.uint8)
    if windows.ndim != 2 or windows.shape[1] < 1:
        raise ValueError(f"windows must be uint8 [n, k >= 1], got "
                         f"{windows.shape}")
    return windows


def _canonical(canonical: int) -> int:
    if canonical not in (0, 1):
        raise ValueError(f"unknown canonicalize value {canonical}")
    return canonical


def window_rows(windows, num_hashes: int, sig_size: int, canonical: int,
                threads: int = 1) -> tuple[np.ndarray, bool]:
    """Canonicalize (canonical=1) + XXH64 with seeds 0..num_hashes-1 +
    mod sig_size over windows uint8 [n, k] on `threads` threads.

    Returns (rows u64 [n * num_hashes], term-major; all_good), all_good
    False when a term held a letter other than ACGT. Sliding-window views
    (strides (1, 1), as ingest.util.sliding_windows makes them) hand the
    underlying sequence to `cobs_sequence_rows_mt` without materializing
    the [n, k] matrix; other arrays go to `cobs_window_rows_mt`."""
    windows = _windows(windows)
    canonical = _canonical(canonical)
    if sig_size < 1:
        raise ValueError(f"signature size must be >= 1, got {sig_size}")
    n, k = windows.shape
    out = np.empty(n * num_hashes, dtype=np.uint64)
    if n == 0:
        return out, True
    threads = max(1, int(threads))
    if windows.strides == (1, 1):
        good = lib().cobs_sequence_rows_mt(
            windows.ctypes.data, n + k - 1, k, num_hashes, sig_size,
            canonical, out.ctypes.data, threads)
    else:
        windows = np.ascontiguousarray(windows)
        good = lib().cobs_window_rows_mt(
            windows.ctypes.data, n, k, num_hashes, sig_size, canonical,
            out.ctypes.data, threads)
    return out, bool(good)


def window_hashes(windows, num_hashes: int,
                  canonical: int) -> tuple[np.ndarray, bool]:
    """Canonicalize + XXH64, not modded: (u64 [n, num_hashes], all_good)
    (`cobs_window_hashes`)."""
    windows = np.ascontiguousarray(_windows(windows))
    n, k = windows.shape
    out = np.empty((n, num_hashes), dtype=np.uint64)
    good = lib().cobs_window_hashes(windows.ctypes.data, n, k, num_hashes,
                                    _canonical(canonical), out.ctypes.data)
    return out, bool(good)


def random_rows(seed: int, n: int, k: int, num_hashes: int,
                sig_size: int) -> np.ndarray:
    """Rows of n random canonical k-mers (a splitmix64 stream from
    `seed`, one draw per term, so 1 <= k <= 32), hashed and modded:
    u64 [n * num_hashes] (`cobs_random_rows`)."""
    if not 1 <= k <= 32:
        raise ValueError(f"random_rows needs 1 <= k <= 32, got {k}")
    out = np.empty(n * num_hashes, dtype=np.uint64)
    lib().cobs_random_rows(seed & (2**64 - 1), n, k, num_hashes, sig_size,
                           out.ctypes.data)
    return out


def set_bits(data, rows, doc_index: int) -> None:
    """OR document `doc_index`'s bit (LSB first) into the given rows of
    data uint8 [signature_size, row_size], in place (`cobs_set_bits`)."""
    if (not isinstance(data, np.ndarray) or data.dtype != np.uint8
            or data.ndim != 2 or not data.flags.c_contiguous
            or not data.flags.writeable):
        raise ValueError("data must be a writeable C-contiguous uint8 "
                         "[rows, row_size] array")
    if not 0 <= doc_index < 8 * data.shape[1]:
        raise ValueError(f"document {doc_index} outside a row of "
                         f"{data.shape[1]} bytes")
    rows = np.ascontiguousarray(rows, dtype=np.uint64).reshape(-1)
    if rows.size and int(rows.max()) >= data.shape[0]:
        raise ValueError(f"row ids outside [0, {data.shape[0]})")
    lib().cobs_set_bits(data.ctypes.data, data.shape[1], rows.ctypes.data,
                        rows.size, doc_index)


def _payload(base, row_bytes: int) -> np.ndarray:
    base = np.asarray(base)
    if (base.dtype != np.uint8 or base.ndim != 2
            or base.shape[1] != row_bytes or not base.flags.c_contiguous):
        raise ValueError(f"base must be a C-contiguous uint8 "
                         f"[rows, {row_bytes}] array, got {base.dtype} "
                         f"{base.shape}")
    return base


def _out_rows(out, n: int, row_bytes: int) -> None:
    if (not isinstance(out, np.ndarray) or out.dtype != np.uint8
            or out.ndim != 2 or out.shape[0] != n
            or out.shape[1] < row_bytes or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous uint8 [{n}, >= "
                         f"{row_bytes}] array, got "
                         f"{getattr(out, 'dtype', type(out))} "
                         f"{getattr(out, 'shape', '')}")


def _row_ids(rows, limit: int, what: str) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if rows.size and (int(rows.min()) < 0 or int(rows.max()) >= limit):
        raise ValueError(f"{what} outside [0, {limit})")
    return rows


def score_batch_host(base, row_bytes: int, rows, zero_id: int,
                     num_threads: int) -> np.ndarray:
    """Host scoring over a contiguous payload (`cobs_score_batch`).

    base: uint8 [R, row_bytes] (an np.memmap of the index payload, or a
    buffer of gathered rows); rows: int64 [B, T, h, P] row ids into it,
    where id == zero_id marks a padding term (zero_id may be R, a
    virtual zero row). Returns int32 [B, P * 8 * row_bytes] counts,
    page-major, in-page document = byte * 8 + bit."""
    base = _payload(base, row_bytes)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if rows.ndim != 4:
        raise ValueError(f"rows must be [B, T, h, P], got {rows.shape}")
    real = rows[rows != zero_id]
    _row_ids(real, base.shape[0], "row ids")
    B, T, h, P = rows.shape
    out = np.empty((B, P * 8 * row_bytes), dtype=np.int32)
    lib().cobs_score_batch(base.ctypes.data, row_bytes, rows.ctypes.data,
                           B, T, h, P, zero_id, out.ctypes.data,
                           max(1, int(num_threads)))
    return out


def gather_rows(base, row_bytes: int, rows, out, num_threads: int) -> None:
    """Threaded scattered copy (`cobs_gather_rows`): out[i, :row_bytes] =
    base[rows[i]]; the rest of each out row is left as it is.

    base: uint8 [R, row_bytes]; rows: int64 [n] in [0, R); out: uint8
    [n, stride >= row_bytes], C-contiguous."""
    base = _payload(base, row_bytes)
    rows = _row_ids(rows, base.shape[0], "row ids").reshape(-1)
    _out_rows(out, rows.size, row_bytes)
    lib().cobs_gather_rows(base.ctypes.data, row_bytes, rows.ctypes.data,
                           rows.size, out.ctypes.data, out.shape[1],
                           max(1, int(num_threads)))


def uring_supported() -> bool | None:
    """Whether io_uring worked on the last row gather from a file (None
    before any ran)."""
    return _uring_ok


def dontcache_supported() -> bool | None:
    """Whether RWF_DONTCACHE reads worked on the last gather that asked
    for them (None before any such gather ran)."""
    return _dontcache_ok


def gather_rows_file(path, base_off: int, row_bytes: int, rows, out,
                     depth: int = 256, dontcache: bool = False) -> bool:
    """Batched async file reads (`cobs_gather_rows_file`):
    out[i, :row_bytes] = file[base_off + rows[i] * row_bytes].

    A deep io_uring queue keeps the disk busy with hundreds of scattered
    row reads instead of one synchronous page fault at a time per
    thread (the analog of the reference's O_DIRECT AIO batch, reference:
    cobs/query/compact_index/aio_search_file.cpp:23-97). dontcache=True
    asks the kernel to drop each read's pages once it completes
    (RWF_DONTCACHE), so a cold-cache loop never warms the cache it is
    measured against; where the flag is unsupported the reads complete
    through the cache and `dontcache_supported()` says so. Returns False
    when io_uring is unavailable (the caller then gathers from the
    mmap); raises OSError on an IO error."""
    global _uring_ok, _dontcache_ok
    limit = (os.path.getsize(path) - base_off) // row_bytes
    rows = _row_ids(rows, limit, "row ids").reshape(-1)
    _out_rows(out, rows.size, row_bytes)
    L = lib()
    if _uring_ok is False:
        return False
    fd = os.open(path, os.O_RDONLY)
    try:
        # no kernel readahead: each buffered miss would otherwise read up
        # to read_ahead_kb of neighbours of a ~1 KB row
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_RANDOM)
        rc = L.cobs_gather_rows_file(fd, base_off, row_bytes,
                                     rows.ctypes.data, rows.size,
                                     out.ctypes.data, out.shape[1], depth,
                                     1 if dontcache else 0)
    finally:
        os.close(fd)
    if rc == -1:
        _uring_ok = False
        return False
    if rc not in (0, 1):
        raise OSError(f"io_uring row gather failed (rc={rc}) reading "
                      f"{path}")
    _uring_ok = True
    if dontcache:
        _dontcache_ok = rc == 0
    return True
