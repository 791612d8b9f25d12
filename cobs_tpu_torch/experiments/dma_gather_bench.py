"""Row-gather bandwidth of K2 (`ops.dma_gather.dma_gather_rows`) against
`torch.index_select`, on one CUDA card.

The port of experiments/dma_gather_bench.py, at its shapes: 16,384 rows
per call, rows of W in {384, 6144, 16384} 32-bit words, from a matrix of
R = min(2^21, 4 GiB / (4 W)) rows of uniform random bits made on the card
from a seed (3.2 GB at W=384). Every timed call gathers fresh random row
ids, so the 50 MB L2 holds none of its rows. GB/s counts each gathered
row read once and written once (2 * N * W * 4 bytes); the bound is those
bytes at the H100's 3.35 TB/s.

    python -m cobs_tpu_torch.experiments.dma_gather_bench
"""

import statistics
import sys

import numpy as np

N_ROWS = 16384
WIDTHS = (384, 6144, 16384)
#: H100 SXM device-memory bandwidth, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def median_device_ms(torch, fn, reps: int = 20) -> float:
    """Median over `reps` of fn(i)'s device time in ms (CUDA events),
    after two warm-up calls. A busy-wait kernel runs ahead of each
    reading, so the launch is enqueued before the card reaches the
    first event and the reading holds no host launch time."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def random_matrix(torch, rows: int, words: int, seed: int,
                  device="cuda"):
    """int32 [rows, words] of uniform random bits made on the card in
    stripes of about 256 MB."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = torch.empty((rows, words), dtype=torch.int32, device=device)
    stripe = max(1, (256 << 20) // (words * 8))
    for r0 in range(0, rows, stripe):
        r1 = min(rows, r0 + stripe)
        m[r0:r1] = torch.randint(-2**31, 2**31, (r1 - r0, words),
                                 generator=g, device=device,
                                 dtype=torch.int64).to(torch.int32)
    return m


def sweep(torch, device="cuda", widths=WIDTHS, reps: int = 20,
          plain=None, seed: int = 11) -> list[dict]:
    """K2 against index_select at each width: one dict per width with
    W, R, ms, library_ms (index_select), plain_ms (`plain(matrix, rows)`
    when given, else None), their GB/s, bound_ms and bytes. Raises if K2
    and index_select disagree."""
    from cobs_tpu_torch.ops.dma_gather import dma_gather_rows

    rng = np.random.default_rng(seed)
    out = []
    for W in widths:
        R = min(1 << 21, (4 << 30) // (W * 4))
        m = random_matrix(torch, R, W, seed=seed + W, device=device)
        ids = torch.from_numpy(rng.integers(0, R, size=(reps + 2, N_ROWS))
                               .astype(np.int32)).to(device)
        ids64 = ids.long()
        got = dma_gather_rows(m, ids[0])
        if not torch.equal(got, m.index_select(0, ids64[0])):
            raise RuntimeError(f"dma_gather_rows != index_select at W={W}")
        moved = 2 * N_ROWS * W * 4
        row = {"W": W, "R": R, "bytes": moved + N_ROWS * 4,
               "ms": median_device_ms(
                   torch, lambda i: dma_gather_rows(m, ids[i]), reps),
               "library_ms": median_device_ms(
                   torch, lambda i: m.index_select(0, ids64[i]), reps),
               "plain_ms": None if plain is None else median_device_ms(
                   torch, lambda i: plain(m, ids[i]), reps)}
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["gbps"] = moved / row["ms"] / 1e6
        row["library_gbps"] = moved / row["library_ms"] / 1e6
        out.append(row)
        del m, ids, ids64, got
        torch.cuda.empty_cache()
    return out


def format_row(r: dict) -> str:
    plain = ("" if r["plain_ms"] is None
             else f", plain {r['plain_ms']:.4f} ms")
    return (f"W={r['W']:5d} R={r['R']}: dma_gather_rows {r['ms']:.4f} ms "
            f"({r['gbps']:.1f} GB/s), index_select {r['library_ms']:.4f} "
            f"ms ({r['library_gbps']:.1f} GB/s){plain}, bound "
            f"{r['bound_ms']:.4f} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dma_gather_bench: no CUDA card", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for r in sweep(torch):
        print(format_row(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
