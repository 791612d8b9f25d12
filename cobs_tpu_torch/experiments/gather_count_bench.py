"""Batch sweep of K1 (`ops.query_kernel.gather_and_count`) on one CUDA card.

Times the fused gather -> AND -> count at the reference's default query
shape (W=384 words, T=1,000 terms, h=1, P=1) for B in {1, 8, 64, 256,
1024} queries, and at the wide-row shape of chip_smoke.py's phase 4
(B=8, T=1,024, W=3,136). The matrix has R = min(2^21, 4 GiB / (4 W)) rows
of uniform random bits made on the card from a seed, plus the zero row
(3.2 GB at W=384), and every timed call reads fresh random row ids, so
the 50 MB L2 holds none of its rows. Times are the median of `reps`
calls (`dma_gather_bench.median_device_ms`). The bound counts the rows
read (B*T*h*P*W*4 bytes), the scores written (B*P*W*32*4) and the ids
read (B*T*h*P*4) at the H100's 3.35 TB/s; GB/s counts the rows alone.

    python -m cobs_tpu_torch.experiments.gather_count_bench [--tune]

`--tune` also times each shape at other launch geometries: the ring
bytes of `ops.query_kernel.plan_gather_count`, and each cluster size
1-8 at the default ring. Without `--tune` the sweep needs only
`gather_and_count` and its plain version, so the same file also times
an older tree of the port (one without the planner) on the same card.
"""

import sys

import numpy as np

#: (B, T, W): the reference-shape batch sweep, then phase 4's wide rows
SHAPES = ((1, 1000, 384), (8, 1000, 384), (64, 1000, 384),
          (256, 1000, 384), (1024, 1000, 384), (8, 1024, 3136))
#: ring bytes per CTA that `--tune` times
TUNE_RINGS = (8 << 10, 16 << 10, 24 << 10, 32 << 10, 48 << 10, 64 << 10)
#: H100 SXM device-memory bandwidth, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def sweep(torch, device="cuda", shapes=SHAPES, reps: int = 20,
          seed: int = 21, tune: bool = False) -> list[dict]:
    """One dict per (B, T, W): ms, bound_ms, gbps (rows only), the byte
    counts and the default plan; with `tune`, `plans`: (label, ms) for
    each other geometry. Raises if the kernel and its plain version
    disagree on the first ids of a shape."""
    from cobs_tpu_torch.experiments.dma_gather_bench import (
        median_device_ms, random_matrix,
    )
    from cobs_tpu_torch.ops import query_kernel as qk
    from cobs_tpu_torch.ops.query_kernel import (
        gather_and_count, gather_and_count_reference,
    )

    rng = np.random.default_rng(seed)
    out, matrices = [], {}
    for B, T, W in shapes:
        if W not in matrices:
            matrices.clear()
            torch.cuda.empty_cache()
            R = min(1 << 21, (4 << 30) // (W * 4))
            m = random_matrix(torch, R + 1, W, seed=seed + W, device=device)
            m[R] = 0
            matrices[W] = m
        m = matrices[W]
        R = m.shape[0] - 1
        ids = torch.from_numpy(rng.integers(0, R, size=(reps + 2, B, T, 1, 1))
                               .astype(np.int32)).to(device)
        if not torch.equal(gather_and_count(m, ids[0], 1),
                           gather_and_count_reference(m, ids[0], 1)):
            raise RuntimeError(f"gather_and_count != plain at B={B} T={T} "
                               f"W={W}")
        rows_bytes = B * T * W * 4
        row = {"B": B, "T": T, "W": W, "R": R, "rows_bytes": rows_bytes,
               "bytes": rows_bytes + B * W * 32 * 4 + B * T * 4,
               "ms": median_device_ms(
                   torch, lambda i: gather_and_count(m, ids[i], 1), reps)}
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["gbps"] = rows_bytes / row["ms"] / 1e6
        sm = torch.cuda.get_device_properties(m.device).multi_processor_count
        if hasattr(qk, "launch_plan"):
            row["plan"] = qk.launch_plan(m.device.index, B, T, 1, 1, W)
        if tune:
            want = gather_and_count_reference(m, ids[0], 1)
            plans = [(f"ring={rb >> 10}K",
                      qk.plan_gather_count(B, T, 1, 1, W, sm,
                                           ring_bytes=rb))
                     for rb in TUNE_RINGS]
            for cs in range(1, 9):
                p = row["plan"]
                plans.append((f"cluster={cs}", p._replace(
                    cluster=cs, tpc=-(-T // cs),
                    grid=p.grid // p.cluster * cs)))
            row["plans"] = []
            for label, p in plans:
                if not torch.equal(gather_and_count(m, ids[0], 1, p), want):
                    raise RuntimeError(f"gather_and_count with {p} != plain")
                row["plans"].append((label, median_device_ms(
                    torch, lambda i: gather_and_count(m, ids[i], 1, p),
                    reps)))
        out.append(row)
        del ids
    return out


def format_row(r: dict) -> str:
    p = r.get("plan")
    return (f"B={r['B']:4d} T={r['T']} W={r['W']:4d} R={r['R']}: "
            f"gather_and_count {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({100 * r['bound_ms'] / r['ms']:.0f} %), "
            f"{r['gbps']:.1f} GB/s of rows"
            + ("" if p is None else
               f"; cluster {p.cluster}, {p.stages} stages, {p.per_sm} "
               f"CTAs/SM, grid {p.grid}")
            + "".join(f"\n  {label}: {ms:.4f} ms"
                      for label, ms in r.get("plans", ())))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gather_count_bench: no CUDA card", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for r in sweep(torch, tune="--tune" in sys.argv):
        print(format_row(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
