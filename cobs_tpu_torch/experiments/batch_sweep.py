"""Batch-size sweep of the headline query benchmark on one CUDA card.

The port of cobs_tpu's experiments/batch_sweep.py: bench_torch.py's
measurement (`hot_loop.measure`: differenced runs of K1 launches with
per-query totals summed on the card, CUDA-event timed) over a list of B,
at the reference's default shape (2^21 rows x 384 words, 10,000
documents, T=1,000, h=1). The total work is held at 36 batches of 64
queries, so the long run has max(2, 36 * 64 / B) batches and the short
one an eighth of that; best of 5 rounds each. One line per B:

    RESULT B=<B> queries_per_s=<q/s> gather_GBps=<GB/s>

    python -m cobs_tpu_torch.experiments.batch_sweep [B ...]   # 64 128 256

`--device cpu` runs the kernel's plain version at a tiny size over one
batch of 64 queries' work (36 on the card), for the tests only.
"""

import sys

import numpy as np

from cobs_tpu_torch.experiments import hot_loop

SWEEP = (64, 128, 256)
ROUNDS = 5
#: the reference default, and the tests' CPU size
CUDA_SHAPE = (1 << 21, 10_000, 1000)
CPU_SHAPE = (1 << 12, 512, 64)


def bench_b(torch, matrix, B: int, T: int, num_hashes: int,
            work_batches: int, rng) -> dict:
    """hot_loop.measure at batch size B over the same total queries for
    every B (work_batches batches of 64)."""
    k_large = max(2, work_batches * 64 // B)
    k_small = max(1, k_large // 8)
    return hot_loop.measure(torch, matrix, B, T, num_hashes, k_small,
                            k_large, ROUNDS, rng)


def sweep(torch, Bs=SWEEP, device="cuda", shape=None,
          work_batches: int = 36) -> list[dict]:
    """bench_b for each B on one matrix (seed 0xC0B5) and one id stream;
    one result dict per B, with "B" set."""
    sig, docs, T = shape or (CUDA_SHAPE if device == "cuda" else CPU_SHAPE)
    W = hot_loop.words_for(docs)
    matrix = hot_loop.reference_matrix(torch, sig, W, device=device)
    rng = np.random.default_rng(hot_loop.SEED)
    return [dict(bench_b(torch, matrix, B, T, 1, work_batches, rng), B=B)
            for B in Bs]


def result_line(r: dict) -> str:
    return (f"RESULT B={r['B']} queries_per_s={r['queries_per_s']:.1f} "
            f"gather_GBps={r['gbps']:.1f}")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if device == "cuda" and not torch.cuda.is_available():
        print("batch_sweep: no CUDA card", file=sys.stderr)
        return 1
    Bs = [int(a) for a in argv] or list(SWEEP)
    sig, docs, T = CUDA_SHAPE if device == "cuda" else CPU_SHAPE
    where = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    print(f"sweep on {where}: sig={sig} docs={docs} "
          f"W={hot_loop.words_for(docs)} T={T} h=1", file=sys.stderr)
    for r in sweep(torch, Bs, device,
                   work_batches=36 if device == "cuda" else 1):
        print(result_line(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
