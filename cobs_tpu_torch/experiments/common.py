"""Seeded inputs and ranking comparisons shared by `chip_smoke.py` and
the experiments: FASTA corpora and ACGT queries drawn from a seed, ranked
result lists compared pair for pair, and a wait for every visible card.
"""

from pathlib import Path

import numpy as np


def write_fasta_corpus(root: Path, n_docs: int, lo: int, hi: int,
                       seed: int) -> list[int]:
    """n_docs FASTA files `doc0000.fasta`, ... of random ACGT from `seed`
    under root, 80 letters a line, lengths spread evenly over [lo, hi] in
    a shuffled order. Returns the lengths by document number."""
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n_docs).astype(np.int64)
    rng.shuffle(lengths)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    root.mkdir(parents=True, exist_ok=True)
    for i, n in enumerate(lengths.tolist()):
        seq = acgt[rng.integers(0, 4, n, dtype=np.uint8)]
        full = n // 80 * 80
        lines = np.empty((n // 80, 81), dtype=np.uint8)
        lines[:, :80] = seq[:full].reshape(-1, 80)
        lines[:, 80] = ord("\n")
        with open(root / f"doc{i:04d}.fasta", "wb") as f:
            f.write(b">doc%d\n" % i)
            f.write(lines.tobytes())
            if n > full:
                f.write(seq[full:].tobytes() + b"\n")
    return lengths.tolist()


def read_fasta_sequence(path: Path) -> bytes:
    """The letters of a one-record FASTA file, line breaks removed."""
    return b"".join(path.read_bytes().split(b"\n")[1:])


def acgt_queries(rng, n: int, length: int) -> list[str]:
    """n random ACGT strings of `length` letters drawn from `rng`."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    return [acgt[rng.integers(0, 4, length)].tobytes().decode()
            for _ in range(n)]


def pairs(results) -> list:
    """Ranked result lists as (document name, score) pairs."""
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def same_ranking(a, b) -> bool:
    """Ranked result lists equal, documents and scores, in order."""
    return len(a) == len(b) and all(
        np.array_equal(x._gidx, y._gidx) and np.array_equal(x._scores,
                                                             y._scores)
        for x, y in zip(a, b))


def sync_all(torch) -> None:
    """Wait for every visible card (none on a CPU-only host)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
