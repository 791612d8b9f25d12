"""Row-gather bandwidth of K2 (`ops.dma_gather.dma_gather_rows`) against
`torch.index_select`, on one CUDA card.

The port of experiments/dma_gather_bench.py, at its shapes: 16,384 rows
per call, rows of W in {384, 6144, 16384} 32-bit words, from a matrix of
R = min(2^21, 4 GiB / (4 W)) rows of uniform random bits made on the card
from a seed (3.2 GB at W=384). Every timed call gathers fresh random row
ids, so the 50 MB L2 holds none of its rows. GB/s counts each gathered
row read once and written once (2 * N * W * 4 bytes); the bound is those
bytes at the H100's 3.35 TB/s.

    python -m cobs_tpu_torch.experiments.dma_gather_bench [--control] [--tune]

`--control` also times the control design, the register path with
non-allocating loads, streaming stores and eight loads in flight per lane
(`experiments/csrc/dma_gather_control.cu`, built here, not used by the
port). `--tune` times the bulk path at other ring geometries
(`ops.dma_gather.plan_gather`'s stage size, ring bytes and CTAs per SM),
and its default plan with the L2 evict-first reads switched the other
way.
"""

import ctypes
import statistics
import sys
from pathlib import Path

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


def control_gather(torch, matrix, rows):
    """out = matrix[rows] by the control kernel (W % 4 == 0, aligned)."""
    from cobs_tpu_torch.ops import _build

    fn = _build.load("dma_gather_control",
                     Path(__file__).resolve().parent / "csrc") \
        .cobs_dma_gather_control
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [vp, i64, i64, vp, i64, vp, vp]
    fn.restype = ctypes.c_int
    R, W = matrix.shape
    out = torch.empty((rows.shape[0], W), dtype=torch.int32,
                      device=matrix.device)
    rc = fn(matrix.data_ptr(), R, W, rows.data_ptr(), rows.shape[0],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"control kernel launch failed: CUDA error {rc}")
    return out


#: (stage_max, ring_bytes, ctas_per_sm) geometries `--tune` times
TUNE_PLANS = tuple((st, ring, ctas) for st in (8 << 10, 16 << 10)
                   for ring in (16 << 10, 32 << 10, 64 << 10)
                   for ctas in (1, 2, 4, 8))


def sweep(torch, device="cuda", widths=WIDTHS, reps: int = 20,
          plain=None, seed: int = 11, control: bool = False,
          tune: bool = False) -> list[dict]:
    """K2 against index_select at each width: one dict per width with
    W, R, ms, library_ms (index_select), plain_ms (`plain(matrix, rows)`
    when given, else None), their GB/s, bound_ms and bytes; with
    `control`, control_ms; with `tune`, `plans`: (plan args, ms) for each
    TUNE_PLANS geometry that fits in shared memory, and `flipped_ms`, the
    default plan with `evict_first` negated. Raises if a kernel and
    index_select disagree."""
    from cobs_tpu_torch.ops.dma_gather import (
        SMEM_LIMIT, dma_gather_rows, plan_gather,
    )

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
        if control:
            if not torch.equal(control_gather(torch, m, ids[0]), got):
                raise RuntimeError(f"control != index_select at W={W}")
            row["control_ms"] = median_device_ms(
                torch, lambda i: control_gather(torch, m, ids[i]), reps)
        if tune:
            props = torch.cuda.get_device_properties(m.device)
            base = plan_gather(N_ROWS, W, props.multi_processor_count,
                               l2_bytes=props.L2_cache_size)
            flip = base._replace(evict_first=not base.evict_first)
            row["flipped_ms"] = median_device_ms(
                torch, lambda i: dma_gather_rows(m, ids[i], flip), reps)
            row["evict_first"] = base.evict_first
            row["plans"] = []
            for args in TUNE_PLANS:
                plan = plan_gather(N_ROWS, W, props.multi_processor_count,
                                   *args, l2_bytes=props.L2_cache_size)
                if plan.smem * args[2] > SMEM_LIMIT:
                    continue
                if not torch.equal(dma_gather_rows(m, ids[0], plan), got):
                    raise RuntimeError(f"K2 with {plan} != index_select")
                row["plans"].append((args, median_device_ms(
                    torch, lambda i: dma_gather_rows(m, ids[i], plan),
                    reps)))
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
    if "control_ms" in r:
        plain += (f", control {r['control_ms']:.4f} ms "
                  f"({2 * N_ROWS * r['W'] * 4 / r['control_ms'] / 1e6:.1f}"
                  " GB/s)")
    line = (f"W={r['W']:5d} R={r['R']}: dma_gather_rows {r['ms']:.4f} ms "
            f"({r['gbps']:.1f} GB/s), index_select {r['library_ms']:.4f} "
            f"ms ({r['library_gbps']:.1f} GB/s){plain}, bound "
            f"{r['bound_ms']:.4f} ms")
    if "flipped_ms" in r:
        line += (f"\n  default plan with evict_first="
                 f"{not r['evict_first']}: {r['flipped_ms']:.4f} ms")
    for (st, ring, ctas), ms in r.get("plans", ()):
        line += (f"\n  plan stage<={st >> 10}K ring={ring >> 10}K "
                 f"ctas/SM={ctas}: {ms:.4f} ms")
    return line


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dma_gather_bench: no CUDA card", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for r in sweep(torch, control="--control" in sys.argv,
                   tune="--tune" in sys.argv):
        print(format_row(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
