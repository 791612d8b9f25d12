"""Corpus-width scaling on one CUDA card: gather bandwidth and q/s of the
query hot loop against the Bloom row width.

The port of cobs_tpu's experiments/width_sweep.py. Every config holds
the matrix at the same bytes (2^21 x 384 words, 3.2 GB) and varies its
aspect ratio: half the signature rows, twice the row width, up to 96 KB
rows (W=24,576 words, 786,432 document slots), the trade a deployment
makes when it packs more documents on a card. The work at each is
bench_torch.py's measurement (`hot_loop`: differenced runs of K1
launches, per-query totals summed on the card, CUDA-event timed) at
B=64, T=1,000 (not padded to 1,024 as on the TPU), h=1; the long run has
2 + max(4, 32 * 384 / W) batches, the short one 2, so each run gathers
about the same bytes. The configs take turns for ROUNDS rounds and each
keeps its best.

    python -m cobs_tpu_torch.experiments.width_sweep [--rounds N]

`--device cpu` runs the kernel's plain version at tiny configs, for the
tests only.
"""

import argparse
import sys

import numpy as np

from cobs_tpu_torch.experiments import hot_loop

B, T, H = 64, 1000, 1
ROUNDS = 4
#: (log2 signature rows, W words): constant rows x W = 2^21 x 384
CONFIGS = ((21, 384), (19, 1536), (17, 6144), (15, 24576))
#: the tests' CPU configs (constant rows x W = 2^10 x 128) and shape
CPU_CONFIGS = ((10, 128), (9, 256), (8, 512))
CPU_B, CPU_T = 4, 32


def setups(torch, configs=CONFIGS, B: int = B, T: int = T,
           device="cuda") -> list[dict]:
    """Per config: its matrix (seed = log2 rows, as cobs_tpu's) and its
    warmed hot_loop.Differenced, all made before any is timed."""
    rng = np.random.default_rng(hot_loop.SEED)
    out = []
    for lg, W in configs:
        matrix = hot_loop.reference_matrix(torch, 1 << lg, W, seed=lg,
                                           device=device)
        k_small = 2
        k_large = k_small + max(4, (32 * 384) // W)
        out.append({"lg": lg, "W": W, "matrix": matrix,
                    "run": hot_loop.Differenced(torch, matrix, B, T, H,
                                                k_small, k_large, rng)})
    return out


def sweep(torch, configs=CONFIGS, rounds: int = ROUNDS, B: int = B,
          T: int = T, device="cuda", log=print) -> list[dict]:
    """The configs in turns for `rounds` rounds; per config its
    hot_loop result plus lg, W and docs (W * 32 slots)."""
    st = setups(torch, configs, B, T, device)
    for r in range(rounds):
        for s in st:
            s["run"].round()
        log(f"  round {r + 1}/{rounds} done")
    return [dict(s["run"].result(), lg=s["lg"], W=s["W"], docs=s["W"] * 32)
            for s in st]


def table(rows: list[dict]) -> list[str]:
    out = [f"{'sig':>8} {'row_KB':>7} {'docs':>7} {'q/s':>9} {'GB/s':>7}"]
    for r in rows:
        out.append(f"{1 << r['lg']:>8} {r['W'] * 4 / 1024:>7.1f} "
                   f"{r['docs']:>7} {r['queries_per_s']:>9.1f} "
                   f"{r['gbps']:>7.1f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("width_sweep: no CUDA card", file=sys.stderr)
        return 1
    cuda = args.device == "cuda"
    configs, b, t = (CONFIGS, B, T) if cuda else (CPU_CONFIGS, CPU_B, CPU_T)
    where = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"width_sweep: {where} B={b} T={t} h={H}", flush=True)
    rows = sweep(torch, configs, args.rounds, b, t, args.device,
                 log=lambda s: print(s, flush=True))
    for line in table(rows):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
