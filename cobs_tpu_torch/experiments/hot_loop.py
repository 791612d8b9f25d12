"""The query hot loop under cobs_tpu's bench.py protocol, on the port.

`bench_torch.py`, `batch_sweep.py` and `width_sweep.py` share it. The
work is K launches of K1 (`ops.query_kernel.gather_and_count`), each on
its own batch of fresh random row ids [B, T, h, 1], each batch's
per-query totals summed on the device (a result that depends on every
gathered row). Two run lengths, K small and K large, alternate for a
number of rounds; each keeps its best time, and their difference over
(K large - K small) batches gives the time of a batch with the fixed
cost of a run (the first launch, the last synchronisation) cancelled, as
bench.py cancels its per-dispatch cost.

On a CUDA card a run is timed by CUDA events. A busy-wait kernel runs
ahead of the first event, long enough for the host to enqueue the run's
launches, so the events hold device time and no host launch time. On
the CPU (the tests) the kernel's plain version runs, timed by the host
clock; such a time is the CPU's and no device's.
"""

import time

import numpy as np

#: bench.py's seed, of the random matrix and of the row ids
SEED = 0xC0B5
#: H100 SXM device-memory bandwidth, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: busy-wait cycles per enqueued batch ahead of a timed run (~0.2 ms at
#: the H100's clocks, above the host's cost of enqueueing K1, its sum
#: and the copy)
_SLEEP_CYCLES_PER_BATCH = 400_000


def words_for(docs: int) -> int:
    """bench.py's word width for `docs` documents: ceil(docs / 8) bytes
    in u32 words, padded to the 128-word multiple the loader uses."""
    return max(128, -(-(-(-docs // 8) // 4) // 128) * 128)


def reference_matrix(torch, sig_size: int, W: int, seed: int = SEED,
                     device="cuda"):
    """int32 [sig_size + 1, W] of uniform random bits made on `device`
    from `seed`, the last row zero (bench.py's matrix; the bits come
    from torch's generator, not JAX's)."""
    from cobs_tpu_torch.experiments.dma_gather_bench import random_matrix

    m = random_matrix(torch, sig_size + 1, W, seed, device)
    m[sig_size] = 0
    return m


def random_ids(torch, rng, K: int, B: int, T: int, h: int, sig_size: int,
               device):
    """int32 [K, B, T, h, 1] uniform row ids in [0, sig_size): K batches
    of fresh ids, no padding terms."""
    return torch.from_numpy(rng.integers(
        0, sig_size, size=(K, B, T, h, 1)).astype(np.int32)).to(device)


def batch_totals(matrix, ids, num_hashes: int):
    """int64 [B]: per-query totals of K1's counts over one batch of ids
    [B, T, h, P]."""
    from cobs_tpu_torch.ops.query_kernel import gather_and_count

    return gather_and_count(matrix, ids, num_hashes).sum(dim=1)


def run_totals(torch, matrix, ids, num_hashes: int):
    """int64 [K, B]: batch_totals of each of the K batches of ids
    [K, B, T, h, P], one launch of K1 (and one sum) after another."""
    out = torch.empty(ids.shape[:2], dtype=torch.int64, device=matrix.device)
    for k in range(ids.shape[0]):
        out[k] = batch_totals(matrix, ids[k], num_hashes)
    return out


def timed_run(torch, matrix, ids, num_hashes: int) -> float:
    """Seconds of one run_totals over ids [K, ...]: CUDA events behind a
    busy-wait kernel on a card, the host clock on the CPU."""
    if matrix.device.type != "cuda":
        t0 = time.perf_counter()
        run_totals(torch, matrix, ids, num_hashes)
        return time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_SLEEP_CYCLES_PER_BATCH * ids.shape[0])
    a.record()
    run_totals(torch, matrix, ids, num_hashes)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


class Differenced:
    """One configuration of the differenced protocol: the matrix, and
    ids of K small and K large batches of B x T terms drawn from `rng`.
    `round()` times each run once and keeps its best; `result()` gives
    the throughput from the best times so far."""

    def __init__(self, torch, matrix, B: int, T: int, num_hashes: int,
                 k_small: int, k_large: int, rng):
        self.torch, self.matrix = torch, matrix
        self.B, self.T, self.h = B, T, num_hashes
        sig = matrix.shape[0] - 1
        self.ids_s = random_ids(torch, rng, k_small, B, T, num_hashes, sig,
                                matrix.device)
        self.ids_l = random_ids(torch, rng, k_large, B, T, num_hashes, sig,
                                matrix.device)
        self.best_s = self.best_l = float("inf")
        # warm: kernel build and plan, allocations
        for ids in (self.ids_s, self.ids_l):
            run_totals(torch, matrix, ids, num_hashes).cpu()

    def round(self) -> None:
        t = self.torch
        self.best_s = min(self.best_s, timed_run(t, self.matrix, self.ids_s,
                                                 self.h))
        self.best_l = min(self.best_l, timed_run(t, self.matrix, self.ids_l,
                                                 self.h))

    def result(self) -> dict:
        """queries (counted over the differenced batches), dt seconds,
        queries_per_s, gbps (rows gathered, T*h rows of W words a query),
        ms_per_batch."""
        dt = max(self.best_l - self.best_s, 1e-9)
        batches = self.ids_l.shape[0] - self.ids_s.shape[0]
        queries = batches * self.B
        W = self.matrix.shape[1]
        return {"queries": queries, "dt": dt, "queries_per_s": queries / dt,
                "gbps": queries * self.T * self.h * W * 4 / dt / 1e9,
                "ms_per_batch": dt / batches * 1e3}


def measure(torch, matrix, B: int, T: int, num_hashes: int, k_small: int,
            k_large: int, rounds: int, rng) -> dict:
    """Differenced(...) over `rounds` rounds: its result()."""
    d = Differenced(torch, matrix, B, T, num_hashes, k_small, k_large, rng)
    for _ in range(rounds):
        d.round()
    return d.result()
