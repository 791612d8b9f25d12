"""Entry points of a quick check: one kernel step, and one whole sharded
step over a mesh.

The port of `__graft_entry__.py`'s `entry` and `dryrun_multichip`:

    python -m cobs_tpu_torch.parallel.dryrun [N]

runs `entry()`'s step once and `dryrun_multichip(N)` (default: every
visible CUDA card). Nothing falls back to the CPU: with fewer devices
than asked for, it raises. The tests pass `devices=[cpu] * N`, and a card
may take several shards (`devices=[cuda:0] * N`).
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from cobs_tpu_torch.ops.query_kernel import gather_and_count
from cobs_tpu_torch.parallel.sharded import (
    ShardedIndex,
    make_mesh,
    shard_words,
    train_step,
    visible_devices,
)
from cobs_tpu_torch.query.engine import DeviceIndex, resolve_device
from cobs_tpu_torch.settings import settings


def entry(device=None):
    """One gather-and-count step at realistic shapes.

    Returns (fn, example_args): fn(matrix, rows_idx) -> int32 counts
    [batch, docs] of 8 queries of 64 terms against a classic index shard
    of 2^14 rows x 4,096 documents with 3 hashes, on `device` (None =
    settings.device)."""
    num_hashes = 3
    dev = resolve_device(device)

    def fn(matrix, rows_idx):
        return gather_and_count(matrix, rows_idx, num_hashes)

    rng = np.random.default_rng(0xC0B5)
    sig_size, W = 1 << 14, 128
    B, T = 8, 64
    matrix = rng.integers(0, 1 << 32, size=(sig_size + 1, W),
                          dtype=np.uint64).astype(np.uint32)
    matrix[-1] = 0               # the zero row of padding terms
    rows_idx = rng.integers(0, sig_size, size=(B, T, num_hashes, 1)
                            ).astype(np.int32)
    return fn, (torch.from_numpy(matrix.view(np.int32)).to(dev),
                torch.from_numpy(rows_idx).to(dev))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run ONE whole sharded step on an n_devices mesh, and the serving
    surface over it.

    The step: a construction scatter into the document-sharded word
    matrix, then a query batch scored against it (queries over the
    "batch" axis, documents over "docs"), checked against a numpy
    reference; then K batches as one dispatch. `devices` (default: every
    visible CUDA card) may repeat; fewer than n_devices raises."""
    if devices is None:
        devices = visible_devices("cuda")
    n_batch = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_batch, n_devices // n_batch, list(devices))
    n_docs = mesh.shape["docs"]

    rng = np.random.default_rng(0)
    R, W, num_hashes = 64, 8 * n_docs, 2
    B, T, n_upd = 2 * n_batch, 16, 128
    rows = rng.integers(0, R, size=n_upd).astype(np.int32)
    docs = rng.integers(0, W * 32, size=n_upd).astype(np.int32)
    rows_idx = rng.integers(0, R, size=(B, T, num_hashes, 1)
                            ).astype(np.int32)
    words, scores = train_step(mesh, shard_words(mesh, R, W), rows, docs,
                               rows_idx, num_hashes)
    want_m = np.zeros((R + 1, W), np.uint32)
    for r, d in zip(rows, docs):
        want_m[r, d // 32] |= np.uint32(1) << np.uint32(d % 32)
    got_m = torch.cat([w.cpu() for w in words]).t().contiguous().numpy()
    if not np.array_equal(got_m.view(np.uint32), want_m):
        raise AssertionError("sharded scatter != numpy")
    anded = want_m[rows_idx[:, :, 0, 0]]
    for j in range(1, num_hashes):
        anded = anded & want_m[rows_idx[:, :, j, 0]]
    bits = (anded[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    want = bits.sum(axis=1).reshape(B, 1, W, 32).astype(np.int32)
    if scores.shape != (B, 1, W, 32) or not np.array_equal(scores, want):
        raise AssertionError("sharded step scores != numpy")

    # K batches as one dispatch over the same mesh must equal the
    # batches one by one
    ix = DeviceIndex.from_arrays(
        want_m, [0], [R], W, term_size=31, canonicalize=1,
        num_hashes=num_hashes, page_size=W * 4,
        file_names=[f"d{i}" for i in range(W * 32)], device="cpu")
    sh = ShardedIndex(ix, mesh, word_align=8)
    group = [[rng.integers(0, 1 << 63, size=(T, num_hashes),
                           dtype=np.uint64) for _ in range(B)]
             for _ in range(3)]
    for p, pd in zip(group, sh.score_batch_multi_async(group)):
        if not np.array_equal(pd.fetch(), sh.score_batch(p)):
            raise AssertionError("grouped dispatch != per batch")
    _dryrun_serving_surface(mesh)


def _dryrun_serving_surface(mesh) -> None:
    """Drive the multi-device serving surface on tiny shapes: sharded
    top-k, full ranking and (on a mesh with more than one "batch" row)
    a sequence split, over a 2-index federation, each equal to the
    single-device Search over the same indexes."""
    from cobs_tpu_torch.construct.classic import classic_construct
    from cobs_tpu_torch.construct.params import ClassicIndexParameters
    from cobs_tpu_torch.ingest.document_list import DocumentList
    from cobs_tpu_torch.query.search import Search

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    old_cache = settings.disable_cache
    settings.disable_cache = True
    try:
        with tempfile.TemporaryDirectory() as tdir:
            td = Path(tdir)
            paths, seqs = [], []
            for j, n_docs in enumerate((6, 10)):
                docs = td / f"docs{j}"
                docs.mkdir()
                for i in range(n_docs):
                    seq = bases[rng.integers(0, 4, size=160)].tobytes()
                    seqs.append(seq)
                    (docs / f"g{j}_{i}.fasta").write_bytes(
                        b">s\n" + seq + b"\n")
                out = td / f"x{j}.cobs_classic"
                classic_construct(DocumentList(docs), out,
                                  index_params=ClassicIndexParameters(
                                      clobber=True, device_construct=False))
                paths.append(str(out))
            fed_mesh = Search(paths, mesh=mesh)
            fed_ref = Search(paths, device=mesh.devices[0][0])
            queries = [seqs[0][10:90].decode(), seqs[7][:70].decode(),
                       seqs[12][40:140].decode()]

            def pairs(results):
                return [[(r.doc_name, r.score) for r in rl]
                        for rl in results]

            got = fed_mesh.search_batch(queries, 0.1, 4)
            want = fed_ref.search_batch(queries, 0.1, 4)
            if pairs(got) != pairs(want) or not any(want):
                raise AssertionError("mesh top-k federation")
            if pairs(fed_mesh.search_batch(queries[:2], 0.1)) != \
                    pairs(fed_ref.search_batch(queries[:2], 0.1)):
                raise AssertionError("mesh full-ranking federation")
            if mesh.shape["batch"] > 1:
                old = settings.seq_split_terms
                settings.seq_split_terms = 32
                try:
                    long_q = (seqs[2] + seqs[3])[:31 + 63].decode()
                    for num_results, thr in ((5, 0.0), (0, 0.05)):
                        if pairs(fed_mesh.search_batch(
                                [long_q], thr, num_results)) != pairs(
                                fed_ref.search_batch([long_q], thr,
                                                     num_results)):
                            raise AssertionError(
                                f"sequence split, num_results="
                                f"{num_results}")
                finally:
                    settings.seq_split_terms = old
    finally:
        settings.disable_cache = old_cache


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), out.dtype)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else len(
        visible_devices("cuda"))
    dryrun_multichip(n)
    print("dryrun_multichip ok:", n, "devices")
