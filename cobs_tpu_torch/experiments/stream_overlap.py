"""Where `Search.search_stream` loses or gains against `search_batch`, on
one CUDA card.

The index and queries of chip_smoke.py's phase 3 (the reference's default
scale: 2^21 + 1 rows x 384 words of random bits, 10,000 documents, h=1,
k=31; 1,024 random 1,030 bp queries in batches of 64, top 100). Each
variant times `search_batch` over the 16 batches and `search_stream` over
all 1,024 queries, five times in turns, and prints the median, the
spread and the `Timer` phases per batch:

- `port`: the port as it is (non-blocking uploads from pageable numpy
  memory; with device hashing, search_stream's host stage inline);
- `pinned`: uploads staged in pinned memory first;
- `worker`: search_stream's host stage on a worker thread two batches
  ahead, as cobs_tpu does;
- `worker-switch-0.1ms`: the same, with the interpreter's thread switch
  interval cut from 5 ms to 0.1 ms (how long the worker and the calling
  thread wait for each other's GIL);
- `depth-1`, `depth-4`: search_stream with 1 or 4 batches kept
  dispatched instead of 2.

    python -m cobs_tpu_torch.experiments.stream_overlap
"""

import statistics
import sys
import time

import numpy as np


def _time(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_overlap: no CUDA card", file=sys.stderr)
        return 1
    from cobs_tpu_torch.experiments.dma_gather_bench import random_matrix
    from cobs_tpu_torch.query import engine
    from cobs_tpu_torch.query import search as search_mod
    from cobs_tpu_torch.query.search import Search

    rows, W, docs, B, n_batches, k = 1 << 21, 384, 10_000, 64, 16, 100
    m = random_matrix(torch, rows + 1, W, seed=1)
    m[rows] = 0
    ix = engine.DeviceIndex.from_arrays(
        m, [0], [rows], W, term_size=31, canonicalize=1, num_hashes=1,
        page_size=docs // 8, file_names=[f"doc{i:05d}" for i in range(docs)],
        device="cuda")
    rng = np.random.default_rng(2)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    queries = [acgt[rng.integers(0, 4, 1030)].tobytes().decode()
               for _ in range(B * n_batches)]
    batches = [queries[i:i + B] for i in range(0, len(queries), B)]
    s = Search(ix)
    s.search_batch(batches[0], 0.0, k)   # builds and loads the kernels

    pageable = engine._upload

    def pinned(a, device):
        return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)

    switch = sys.getswitchinterval()
    # name -> (upload, switch interval, batches hashed ahead, depth)
    variants = {"port": (pageable, switch, 0, 2),
                "pinned": (pinned, switch, 0, 2),
                "worker": (pageable, switch, 2, 2),
                "worker-switch-0.1ms": (pageable, 1e-4, 2, 2),
                "depth-1": (pageable, switch, 0, 1),
                "depth-4": (pageable, switch, 0, 4)}
    walls = {(v, p): [] for v in variants for p in ("batch", "stream")}
    phases = {}
    for _ in range(5):
        for name, (upload, interval, ahead, depth) in variants.items():
            engine._upload = upload
            sys.setswitchinterval(interval)
            search_mod._HASH_AHEAD["device"] = ahead
            search_mod._DEPTH = depth
            try:
                for path in ("batch", "stream"):
                    s.timer().reset()
                    if path == "batch":
                        fn = lambda: [s.search_batch(b, 0.0, k)  # noqa
                                      for b in batches]
                    else:
                        fn = lambda: list(s.search_stream(  # noqa
                            queries, 0.0, k, batch_size=B))
                    walls[name, path].append(_time(fn))
                    phases[name, path] = " ".join(
                        f"{p}={s.timer().get(p) / n_batches * 1e3:.3f}ms"
                        for p in ("hashes", "io", "add rows",
                                  "sort results"))
            finally:
                engine._upload = pageable
                sys.setswitchinterval(switch)
                search_mod._HASH_AHEAD["device"] = 0
                search_mod._DEPTH = 2
    print(f"device: {torch.cuda.get_device_name(0)}")
    for (name, path), ws in walls.items():
        w = statistics.median(ws)
        print(f"{name:19s} search_{path:6s} {len(queries) / w:8.0f} q/s "
              f"({w / n_batches * 1e3:.3f} ms per batch of {B}, runs "
              f"{min(ws) / n_batches * 1e3:.3f}-"
              f"{max(ws) / n_batches * 1e3:.3f}); last run per batch: "
              f"{phases[name, path]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
