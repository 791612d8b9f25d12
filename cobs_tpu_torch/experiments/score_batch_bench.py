"""Microbenchmark of the native host scorer `cobs_score_batch`.

The port of cobs_tpu's experiments/score_batch_bench.py, over the port's
native library (`cobs_tpu_torch/native`, built with g++ at first use).
The host scorer carries the streamed backend's host scoring
(`settings.streamed_host_score = "host"`); this times it alone on
synthetic data: a payload of 2^sig_log2 rows + the zero row of
ceil(docs / 8) bytes whose bits are set with about `density` after the
AND of h rows, B queries of T random row ids (seed 7), 4 threads, the
best of `iters` calls. `file_backed` scores through a file-backed mmap
(4 KiB pages, as StreamedIndex reads an index) instead of an anonymous
buffer, which may get transparent huge pages. Host times only: no
device runs.

    python -m cobs_tpu_torch.experiments.score_batch_bench [B T docs h ...]
"""

import mmap
import sys
import tempfile
import time

import numpy as np

from cobs_tpu_torch import native

THREADS = 4


def synthetic(B=64, T=1000, docs=10_000, h=1, density=0.3, sig_log2=18,
              seed=7):
    """(payload uint8 [2^sig_log2 + 1, row_bytes], rows int64 [B, T, h,
    1], zero_id, row_bytes): cobs_tpu's harness's data, same draws."""
    rng = np.random.default_rng(seed)
    row_bytes = (docs + 7) // 8
    sig = 1 << sig_log2
    shape = (sig + 1, row_bytes)
    # per-bit density ~0.5^n from the AND of n random byte planes, n such
    # that the AND of h gathered rows lands near `density`
    per_row = density ** (1.0 / max(h, 1))
    n = max(1, round(np.log(per_row) / np.log(0.5)))
    payload = rng.integers(0, 256, size=shape, dtype=np.uint8)
    for _ in range(n - 1):
        payload &= rng.integers(0, 256, size=shape, dtype=np.uint8)
    payload[sig] = 0
    rows = rng.integers(0, sig, size=(B, T, h, 1)).astype(np.int64)
    return payload, rows, sig, row_bytes


def score(payload, rows, zero_id: int, row_bytes: int, out,
          threads: int = THREADS) -> None:
    """One call of `cobs_score_batch` into out int32 [B, 8 * row_bytes]
    (no argument checks: the kernel alone)."""
    B, T, h, P = rows.shape
    native.lib().cobs_score_batch(payload.ctypes.data, row_bytes,
                                  rows.ctypes.data, B, T, h, P, zero_id,
                                  out.ctypes.data, threads)


def bench(B=64, T=1000, docs=10_000, h=1, density=0.3, iters=5,
          sig_log2=18, file_backed=0):
    """Best seconds of `iters` calls; prints one line."""
    payload, rows, zero_id, row_bytes = synthetic(B, T, docs, h, density,
                                                  sig_log2)
    if file_backed:
        tf = tempfile.TemporaryFile()   # under TMPDIR; gone when closed
        payload.tofile(tf)
        tf.flush()
        mm = mmap.mmap(tf.fileno(), 0, prot=mmap.PROT_READ)
        warmed = np.frombuffer(mm, dtype=np.uint8).reshape(payload.shape)
        # touch one byte per 4 KiB page: the page cache fully warm
        int(warmed.reshape(-1)[::4096].astype(np.int64).sum())
        payload = warmed
    out = np.zeros((B, 8 * row_bytes), dtype=np.int32)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        score(payload, rows, zero_id, row_bytes, out)
        best = min(best, time.perf_counter() - t0)
    gb = B * T * h * row_bytes / 1e9
    print(f"B={B} T={T} docs={docs} h={h}: {best * 1e3:.1f} ms/batch "
          f"({B / best:.0f} q/s kernel-only, {gb / best:.2f} GB/s rows)")
    return best


if __name__ == "__main__":
    bench(*[float(a) if "." in a else int(a) for a in sys.argv[1:]])
