"""The construction bit scatter and the query hash kernel against their
control designs, timed in one process on one CUDA card.

The controls are the kernels as they stood before their redesign, kept
under `experiments/csrc/` and never used by the port:
`construct_scatter_control.cu` (one atomic OR per update into row-major
words [R1, Wc]) and `device_hash_control.cu` (one byte at a time, a
software 64-bit modulo). `chip_smoke.py` phases 5 and 10 call the
functions here on the main path's own inputs; run alone, this module
times both pairs on inputs made from a seed:

    python -m cobs_tpu_torch.experiments.redesign_bench

- the scatter at a classic batch of 1,000 documents (R1 = 2,803,591 rows,
  Wc = 32) and at R1 = 2^24 + 1, four chunks of 2^22 updates, each
  a run of eight consecutive documents with uniform random rows (as the
  device build's eight workers stage them), warm (the same strips launch
  after launch) and with the L2 flushed before each launch, at the
  default plan (binned), the one-pass plan and the control;
- the hash kernel at phase 3's shape (B=64, L=1030, k=31, h=1, P=1) and
  at a compact-shaped one (h=3, P=8 pages of unequal sizes), then over
  batch sizes B in {1, 8, 64, 256, 1024} beside an empty launch.

Every pair is checked bit for bit before it is timed.
"""

import ctypes
import statistics
import sys
from pathlib import Path

import numpy as np

from cobs_tpu_torch.experiments.dma_gather_bench import median_device_ms

_CSRC = Path(__file__).resolve().parent / "csrc"
#: control sources (experiments/csrc/<name>.cu)
CONTROLS = ("construct_scatter_control", "device_hash_control")
#: bytes written between launches to push a launch's strips out of the
#: 50 MB L2
FLUSH_BYTES = 128 << 20
#: classic batch of phase 10 (1,000 documents of up to 1 Mbp at fpr 0.3)
PHASE10_ROWS = 2_803_591
#: the hash kernel's compact-shaped case: eight pages of unequal sizes
COMPACT_SIGS = (1_000_003, 2_097_152, 524_309, 1_048_577, 262_147,
                3_000_017, 65_537, 1_500_007)


def build_controls() -> dict[str, float]:
    """nvcc the control sources (one process each, in parallel)."""
    from cobs_tpu_torch.ops import _build

    return _build.build(CONTROLS, _CSRC)


def _fn(name: str, argtypes):
    from cobs_tpu_torch.ops import _build

    fn = getattr(_build.load(name, _CSRC), f"cobs_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def scatter_control(torch, words, rows, docs):
    """words int32 [R1, Wc] (row-major) |= the updates' bits, in place,
    by the control kernel (8 blocks per SM of 256 threads, as it ran)."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn = _fn("construct_scatter_control",
             [vp, i64, i64, vp, vp, i64, ctypes.c_int, vp])
    n = rows.shape[0]
    sms = torch.cuda.get_device_properties(words.device) \
        .multi_processor_count
    rc = fn(words.data_ptr(), words.shape[0], words.shape[1],
            rows.data_ptr(), docs.data_ptr(), n,
            min(-(-n // 256), 8 * sms),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter control launch failed: CUDA error {rc}")
    return words


def hash_control(torch, qdata, qlens, k, h, canon, sig, off, zero_row):
    """int32 [B, T, h, P] row ids by the control kernel; sig and off are
    int64 [P] tensors on the card."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _fn("device_hash_control",
             [vp, vp, i32, i32, i32, i32, i32, i32, vp, vp, i32, vp, vp])
    B, L = qdata.shape
    out = torch.empty((B, L - k + 1, h, sig.shape[0]), dtype=torch.int32,
                      device=qdata.device)
    rc = fn(qdata.data_ptr(), qlens.data_ptr(), B, L, k, h, canon,
            sig.shape[0], sig.data_ptr(), off.data_ptr(), zero_row,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hash control launch failed: CUDA error {rc}")
    return out


def flushed_ms(torch, fn, reps: int = 20) -> float:
    """median_device_ms with FLUSH_BYTES written between the busy-wait
    and the first event of each reading, so that fn(i) finds its data in
    device memory, not in the L2."""
    junk = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        junk.fill_(i)
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_split(torch, fn, reps: int = 8) -> dict[str, tuple]:
    """(device ms per launch, launches recorded) of each kernel (and
    memset) that fn(i) runs, from a torch.profiler window over `reps`
    calls. Per launch, not per call: a window can miss records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].split()[-1][:40]
            us, count = out.get(name, (0.0, 0))
            out[name] = (us + e.self_device_time_total, count + e.count)
    return {k: (us / count / 1e3, count) for k, (us, count) in out.items()}


def synthetic_chunks(torch, R1: int, n: int = 1 << 22, count: int = 4,
                     docs_per_chunk: int = 8, seed: int = 0) -> list:
    """`count` chunks of n (rows, docs) int32 updates on the card: chunk
    c is a run of documents c * docs_per_chunk onwards, each with uniform
    random rows in [0, R1 - 1)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = []
    for c in range(count):
        rows = torch.randint(0, R1 - 1, (n,), generator=g, device="cuda",
                             dtype=torch.int32)
        docs = (c * docs_per_chunk
                + torch.arange(n, device="cuda") * docs_per_chunk // n)
        out.append((rows, docs.to(torch.int32)))
    return out


def time_scatter(torch, cs, R1: int, Wc: int, chunks,
                 plain: bool = False) -> dict:
    """The kernel (word-major words [Wc, R1]) at its default plan and at
    the one-pass plan (step 1 alone, `onepass_*`), and the control
    (row-major [R1, Wc]), on the same chunks, each warm and L2-flushed;
    the control's words, after every timed launch, equal the kernel's
    transposed. With `plain`, plain_ms too. Times in ms per launch."""
    words = torch.zeros((Wc, R1), dtype=torch.int32, device="cuda")
    ctrl = torch.zeros((R1, Wc), dtype=torch.int32, device="cuda")
    k = len(chunks)
    one = cs.ScatterPlan(False)
    runs = {
        "": lambda i: cs.construct_scatter(words, *chunks[i % k]),
        "onepass_": lambda i: cs.construct_scatter(words, *chunks[i % k],
                                                   one),
        "control_": lambda i: scatter_control(torch, ctrl, *chunks[i % k]),
    }
    out = {}
    for name, fn in runs.items():
        out[f"{name}ms"] = median_device_ms(torch, fn)
        out[f"{name}flushed_ms"] = flushed_ms(torch, fn)
    out["split"] = kernel_split(torch, runs[""])
    out["onepass_split"] = kernel_split(torch, runs["onepass_"])
    same = torch.equal(words, ctrl.t())
    del ctrl
    if not same:
        raise RuntimeError(f"construct_scatter != its control at R1={R1} "
                           f"Wc={Wc}")
    if plain:
        out["plain_ms"] = median_device_ms(
            torch, lambda i: cs.construct_scatter_reference(
                words, *chunks[i % k]), reps=5)
    return out


def format_scatter(r: dict) -> str:
    return ("; ".join(
        f"{what} warm {r[f'{key}ms']:.4f} ms, L2 flushed "
        f"{r[f'{key}flushed_ms']:.4f} ms"
        for what, key in (("kernel", ""), ("one-pass plan", "onepass_"),
                          ("control", "control_")))
        + "; by the profiler, ms per launch (launches recorded of 8 "
        "calls), the kernel's: " + format_split(r["split"])
        + "; the one-pass plan's: " + format_split(r["onepass_split"]))


def format_split(split: dict) -> str:
    return ", ".join(f"{k} {ms:.4f} ({n})" for k, (ms, n) in split.items())


def time_hash(torch, dh, args) -> dict:
    """The hash kernel and its control on the same arguments of
    `rows_from_queries` (sig, off and the Barrett factors as the engine
    keeps them), checked equal, then timed (ms)."""
    qdata, qlens, k, h, canon, sig, off, zero, mag = args
    got = dh.rows_from_queries(*args)
    ctrl = hash_control(torch, qdata, qlens, k, h, canon, sig, off, zero)
    torch.cuda.synchronize()
    if not torch.equal(got, ctrl):
        raise RuntimeError(f"hash kernel != its control at k={k} h={h} "
                           f"P={sig.shape[0]}")
    return {"ms": median_device_ms(
                torch, lambda i: dh.rows_from_queries(*args)),
            "control_ms": median_device_ms(
                torch, lambda i: hash_control(torch, qdata, qlens, k, h,
                                              canon, sig, off, zero))}


def hash_sweep(torch, dh, batches=(1, 8, 64, 256, 1024)) -> list[dict]:
    """The hash kernel and its control at phase 3's query shape over batch
    sizes, beside the time of an empty launch under the same timing (the
    floor of any reading here)."""
    floor = median_device_ms(torch, lambda i: torch.cuda._sleep(0))
    out = []
    for B in batches:
        r = time_hash(torch, dh, hash_args(torch, dh, B, 1030, 31, 1,
                                           (1 << 21,), seed=B))
        out.append({"B": B, "floor_ms": floor, **r})
    return out


def hash_args(torch, dh, B: int, L: int, k: int, h: int, sigs,
              seed: int) -> tuple:
    """`rows_from_queries` arguments on the card: B random ACGT queries of
    length L, pages `sigs` back to back, the zero row after them."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    qdata = torch.from_numpy(acgt[rng.integers(0, 4, (B, L))]).cuda()
    qlens = torch.full((B,), L, dtype=torch.int32, device="cuda")
    offs = np.cumsum((0,) + tuple(sigs[:-1]))
    sig, off, mag = dh.page_tables(sigs, offs, "cuda")
    return (qdata, qlens, k, h, 1, sig, off, int(sum(sigs)), mag)


def main() -> int:
    import torch

    from cobs_tpu_torch.ops import _build
    from cobs_tpu_torch.ops import construct_scatter as cs
    from cobs_tpu_torch.ops import device_hash as dh

    if not torch.cuda.is_available():
        print("redesign_bench: no CUDA card", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    _build.build(("construct_scatter", "device_hash"))
    build_controls()
    for R1 in (PHASE10_ROWS + 1, (1 << 24) + 1):
        r = time_scatter(torch, cs, R1, 32, synthetic_chunks(torch, R1))
        print(f"construct_scatter R1={R1} Wc=32, 4 x 2^22 updates: "
              + format_scatter(r), flush=True)
        torch.cuda.empty_cache()
    for name, h, sigs in (("phase 3", 1, (1 << 21,)),
                          ("compact", 3, COMPACT_SIGS)):
        r = time_hash(torch, dh, hash_args(torch, dh, 64, 1030, 31, h,
                                           sigs, seed=1))
        print(f"rows_from_queries {name} (B=64 L=1030 k=31 h={h} "
              f"P={len(sigs)}): {r['ms']:.4f} ms (control "
              f"{r['control_ms']:.4f})", flush=True)
    for r in hash_sweep(torch, dh):
        print(f"rows_from_queries B={r['B']} (L=1030 k=31 h=1 P=1): "
              f"{r['ms']:.4f} ms (control {r['control_ms']:.4f}; an empty "
              f"launch {r['floor_ms']:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
