"""Weak-scaling benchmark over a mesh of devices.

The port of `cobs_tpu/parallel/benchmark.py`: batched query throughput
of the document-sharded matrix on 1 shard against n shards, with the
documents per shard held constant (each shard scores the same work, so
perfect scaling keeps q/s flat while the documents grow n-fold).

Cost model (`cost_model`): each shard gathers T x h x W_local x 4 bytes
per query from its own memory, and nothing crosses devices while it
does. What the port can count of that, in place of cobs_tpu's count of
collectives in the compiled program: the device-to-device copies made
in the timed loop (must be 0) and the exchanges between processes (one
per batch or group on a mesh that spans processes, 0 in one process),
from the counters of `parallel/sharded.py`. With n shards on d distinct
devices the predicted efficiency is min(1, d / n): shards that share a
device share its memory bandwidth (and on the CPU its one thread of
cells). Every result names d beside n, so a run of n shards on one card
is never read as scaling across cards.
"""

import time

import numpy as np
import torch

from cobs_tpu_torch.parallel import sharded
from cobs_tpu_torch.parallel.sharded import (
    ShardedIndex,
    make_mesh,
    visible_devices,
)
from cobs_tpu_torch.query.engine import DeviceIndex

#: batches kept dispatched in the timed loops (search_stream's window)
_INFLIGHT = 4


def _random_index(device, sig_size: int, W: int, num_hashes: int
                  ) -> DeviceIndex:
    """A classic index of W * 32 documents over a random matrix made on
    `device` from a seed (the last row zero)."""
    g = torch.Generator(device=device).manual_seed(7)
    m = torch.randint(-(1 << 31), 1 << 31, (sig_size + 1, W),
                      dtype=torch.int64, device=device, generator=g)
    m = m.to(torch.int32)
    m[-1] = 0
    return DeviceIndex.from_arrays(
        m, [0], [sig_size], W, term_size=31, canonicalize=1,
        num_hashes=num_hashes, page_size=W * 4,
        file_names=[f"d{i}" for i in range(W * 32)], device=device)


def _sharded(devices, sig_size: int, W_per_shard: int, num_hashes: int
             ) -> ShardedIndex:
    n = len(devices)
    mesh = make_mesh(1, n, devices)
    ix = _random_index(devices[0], sig_size, W_per_shard * n, num_hashes)
    return ShardedIndex(ix, mesh, word_align=W_per_shard)


def _payloads(B: int, T: int, num_hashes: int, count: int) -> list:
    """`count` batches of B queries, each T terms of random raw hashes."""
    rng = np.random.default_rng(3)
    return [[rng.integers(0, 1 << 63, size=(T, num_hashes),
                          dtype=np.uint64) for _ in range(B)]
            for _ in range(count)]


def _sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _bench_mesh(devices, sig_size: int, W_per_shard: int, B: int, T: int,
                num_hashes: int, iters: int) -> dict:
    """q/s with the matrix sharded over `devices`, the process's CPU
    cores busy over the timed loop (CPU seconds / wall seconds), and the
    cross-device copies and process exchanges per batch in it."""
    sh = _sharded(devices, sig_size, W_per_shard, num_hashes)
    bufs = _payloads(B, T, num_hashes, 4)
    sh.score_batch(bufs[0])   # warm: kernel builds, plans, allocations
    _sync(devices)
    sharded.CROSS_DEVICE_COPIES = sharded.EXCHANGES = 0
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    pending = []
    for i in range(iters):
        pending.append(sh.score_batch_async(bufs[i % len(bufs)]))
        if len(pending) > _INFLIGHT:
            pending.pop(0).fetch()
    for p in pending:
        p.fetch()
    wall = time.perf_counter() - t0
    return {"qps": iters * B / wall,
            "cpu_util": (time.process_time() - cpu0) / max(wall, 1e-9),
            "copies_per_batch": sharded.CROSS_DEVICE_COPIES / iters,
            "exchanges_per_batch": sharded.EXCHANGES / iters}


def _bench_mesh_mega(devices, sig_size: int, W_per_shard: int, B: int,
                     T: int, num_hashes: int, iters: int,
                     K: int = 8) -> float:
    """q/s with K batches per dispatch (score_batch_multi_async: one
    launch of the gather-and-count kernel per cell for the K batches)."""
    sh = _sharded(devices, sig_size, W_per_shard, num_hashes)
    group = _payloads(B, T, num_hashes, K)
    for p in sh.score_batch_multi_async(group):
        p.fetch()
    _sync(devices)
    reps = max(1, iters // K)
    t0 = time.perf_counter()
    inflight = []
    for _ in range(reps):
        inflight.append(sh.score_batch_multi_async(group))
        if len(inflight) > 2:
            for p in inflight.pop(0):
                p.fetch()
    for g in inflight:
        for p in g:
            p.fetch()
    return reps * K * B / (time.perf_counter() - t0)


def cost_model(n_devices: int, W_per_shard: int, T: int, num_hashes: int,
               B: int, term_size: int = 31,
               distinct_devices: int | None = None) -> dict:
    """Bytes moved per query, and the predicted weak-scaling efficiency.

    Keys:
      hbm_bytes_per_query_per_shard: the shard's row gather (its bound).
      cross_device_bytes_per_query: bytes between devices while scoring
        (0: counts stay on their shard until the fetch).
      upload_bytes_per_query: host row ids uploaded per query and cell.
      upload_bytes_per_query_device_hash: query bytes uploaded instead
        when the cells hash on their devices (Search's default).
      distinct_devices: d, the devices the n shards sit on.
      predicted_efficiency: min(1, d / n).
    """
    d = n_devices if distinct_devices is None else distinct_devices
    return {
        "hbm_bytes_per_query_per_shard": T * num_hashes * W_per_shard * 4,
        "cross_device_bytes_per_query": 0,
        "upload_bytes_per_query": T * num_hashes * 4,
        "upload_bytes_per_query_device_hash": T + term_size - 1,
        "distinct_devices": d,
        "predicted_efficiency": min(1.0, d / n_devices),
    }


def benchmark_scaling(n_devices: int | None = None,
                      sig_size: int = 1 << 18, docs_per_shard: int = 4096,
                      B: int = 16, T: int = 1000, num_hashes: int = 1,
                      iters: int = 10, B_sweep: tuple[int, ...] = (),
                      devices=None) -> dict:
    """Weak-scaling sweep over 1, 2 and n shards (docs per shard held
    constant).

    `devices`: the devices to shard over (default: every visible CUDA
    card); they may repeat ([cuda:0] * 4 is four shards on one card).
    n_devices (default len(devices)) beyond them raises, as make_mesh
    does. Returns {"per_n": {n: q/s}, "cpu_util": {n: cores busy},
    "distinct": {n: d}, "copies_per_batch": {n: ...},
    "exchanges_per_batch": {n: ...}, "efficiency": q/s_n / q/s_1,
    "per_b": {B: q/s at n shards}, "mega_qps": q/s at n shards with 8
    batches per dispatch, "cost_model": {...}, "predicted_efficiency":
    min(1, d / n)}. ``B_sweep`` also measures each batch size at the
    full width: scaling claims must state the B they were measured at.
    """
    if devices is None:
        devices = visible_devices("cuda")
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"mesh needs {n_devices} devices, only "
                         f"{len(devices)} available")
    W_per_shard = max(1, docs_per_shard // 32)
    ns = sorted({1, 2, n_devices} & set(range(1, n_devices + 1)))
    per_n, cpu_util, distinct, copies, exchanges = {}, {}, {}, {}, {}
    for n in ns:
        r = _bench_mesh(devices[:n], sig_size, W_per_shard, B, T,
                        num_hashes, iters)
        per_n[n], cpu_util[n] = r["qps"], r["cpu_util"]
        copies[n], exchanges[n] = (r["copies_per_batch"],
                                   r["exchanges_per_batch"])
        distinct[n] = len(set(devices[:n]))
    eff = None
    if n_devices in per_n and 1 in per_n and n_devices > 1:
        # weak scaling: n shards score n x the documents per query
        eff = per_n[n_devices] / per_n[1]
    per_b = {}
    for b in B_sweep:
        per_b[b] = (per_n[n_devices] if b == B else _bench_mesh(
            devices[:n_devices], sig_size, W_per_shard, b, T, num_hashes,
            iters)["qps"])
    mega_qps = _bench_mesh_mega(devices[:n_devices], sig_size, W_per_shard,
                                B, T, num_hashes, iters)
    cm = cost_model(n_devices, W_per_shard, T, num_hashes, B,
                    distinct_devices=distinct[n_devices])
    return {"per_n": per_n, "cpu_util": cpu_util, "distinct": distinct,
            "copies_per_batch": copies, "exchanges_per_batch": exchanges,
            "efficiency": eff, "per_b": per_b, "mega_qps": mega_qps,
            "cost_model": cm,
            "predicted_efficiency": cm["predicted_efficiency"]}
