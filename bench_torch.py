#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: query throughput of the
bit-sliced signature index's hot loop on one CUDA card.

The port of bench.py (which stays as cobs_tpu's). Same workload: the
reference's synthetic scale (`classic-construct-random` defaults,
reference src/cobs.cpp:243-291): 2^21 Bloom rows + the zero row x 384
words of random bits made on the card from seed 0xC0B5, 10,000
documents, B=64 queries of T=1,000 terms, one hash, one page; fresh
random row ids for every launch. Same output: one JSON line, the last of
stdout,

  {"metric": "query_throughput", "value": <queries/s>, "unit":
   "queries/s", "vs_baseline": <ratio over the reference's single-node
   memory-bandwidth roofline>}

where the baseline is bench.py's: the reference's mmap row gather is
DRAM-bound, T*h rows of docs/8 bytes a query, at an optimistic 50 GB/s
of random-row bandwidth 50e9 / (1000 * 1 * 1250) = 40,000 queries/s.
A line on stderr gives the rows gathered in GB/s beside the H100's
3.35 TB/s, and the card's name and power limit.

Differences from bench.py:

- Timing. The work is K launches of K1 (`ops.query_kernel.gather_and_count`)
  timed by CUDA events, each batch's per-query totals summed on the
  card (`experiments/hot_loop.py`). Two run lengths (4 and 36 batches)
  alternate for 10 rounds and are differenced, as in bench.py, so a
  run's fixed cost (its first launch and last synchronisation) cancels.
- No term padding. bench.py pads T to cobs_tpu's 1,024-term bucket
  because the TPU path serves padded shapes; the port's serving path
  does not pad, so T=1,000 is what is measured and counted.
- No watchdog and no CPU fallback. Without a CUDA card the script exits
  1 and prints no number. `--device cpu` runs the kernel's plain
  version at bench.py's CPU sizes (2^16 rows, 2,048 documents, B=8,
  T=128), for the tests only, with vs_baseline 0.0 as bench.py prints
  off the TPU.

    python3 bench_torch.py [--device cuda|cpu]
"""

import argparse
import json
import subprocess
import sys

import numpy as np

from cobs_tpu_torch.experiments import hot_loop

#: (signature rows, documents, B, T, K large) on the card and on the CPU
CUDA_SIZES = (1 << 21, 10_000, 64, 1000, 36)
CPU_SIZES = (1 << 16, 2_048, 8, 128, 8)
K_SMALL, ROUNDS, NUM_HASHES = 4, 10, 1


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of card 0."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def reference_qps(T: int, num_hashes: int, docs: int) -> float:
    """bench.py's baseline: the reference's DRAM-roofline row gather."""
    return 50e9 / (T * num_hashes * (docs / 8.0))


def run(torch, device: str, matrix=None) -> dict:
    """The measurement at `device`'s sizes: hot_loop.measure's result
    plus the sizes, the reference q/s and vs_baseline. `matrix` (None =
    made here) is hot_loop.reference_matrix at those sizes."""
    sig, docs, B, T, k_large = CUDA_SIZES if device == "cuda" else CPU_SIZES
    W = hot_loop.words_for(docs)
    print(f"bench_torch: {device} sig={sig} docs={docs} W={W} B={B} T={T}",
          file=sys.stderr, flush=True)
    if matrix is None:
        matrix = hot_loop.reference_matrix(torch, sig, W, device=device)
    rng = np.random.default_rng(hot_loop.SEED)
    res = hot_loop.measure(torch, matrix, B, T, NUM_HASHES, K_SMALL,
                           k_large, ROUNDS, rng)
    ref = reference_qps(T, NUM_HASHES, docs)
    res.update(sig=sig, docs=docs, W=W, B=B, T=T, reference_qps=ref,
               vs_baseline=res["queries_per_s"] / ref
               if device == "cuda" else 0.0)
    return res


def result_line(res: dict) -> str:
    return json.dumps({"metric": "query_throughput",
                       "value": round(res["queries_per_s"], 2),
                       "unit": "queries/s",
                       "vs_baseline": round(res["vs_baseline"], 4)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA card (torch.cuda.is_available() is "
              "False); no measurement", file=sys.stderr)
        return 1
    res = run(torch, args.device)
    where = (f"card {card_line()} (HBM {hot_loop.HBM_BYTES_PER_S / 1e9:.0f} "
             f"GB/s)" if args.device == "cuda"
             else "CPU, the kernel's plain version: no device number")
    print(f"bench_torch: {res['queries_per_s']:.1f} queries/s "
          f"({res['gbps']:.1f} GB/s gathered, {res['ms_per_batch']:.4f} ms "
          f"a batch of {res['B']}; {where}); reference DRAM-roofline "
          f"~{res['reference_qps']:.0f} q/s", file=sys.stderr, flush=True)
    print(result_line(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
