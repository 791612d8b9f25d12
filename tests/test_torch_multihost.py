"""cobs_tpu_torch across processes (parallel/distributed.py) against
cobs_tpu, on the CPU.

The two-process tests start this file twice as a worker (the code under
`__main__` at the end), each process with 4 shards of the CPU device; the
processes join one gloo process group through a file store in the test's
tmp_path, and the global ("batch", "docs") mesh has 8 cells, 4 per
process. They are the counterparts of tests/test_multihost.py (its
workers tests/multihost_worker.py and tests/multihost_construct_worker.py).
The single-process tests are the counterparts of
tests/test_multihost_construct.py. Results are held to cobs_tpu's (or, in
the scoring worker, to a numpy count, as cobs_tpu's worker holds them)
with exact equality. Each child has 120 s; its output is shown when it
fails.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
BASES = np.frombuffer(b"ACGT", np.uint8)
#: seconds each worker process may take
CHILD_TIMEOUT = 120


def _run_two_process(mode: str, work: Path) -> list[str]:
    env = dict(os.environ,
               PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(i), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-4000:]}"
    return outs


def _pairs(results):
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def _worker_corpus_seqs() -> list[bytes]:
    """multihost_construct_worker.py's corpus: 20 documents."""
    rng = np.random.default_rng(11)
    return [BASES[rng.integers(0, 4, size=130 + 53 * i)].tobytes()
            for i in range(20)]


def _worker_queries(seqs) -> list[str]:
    return [seqs[1][:61].decode(), seqs[10][5:80].decode(),
            seqs[19][:45].decode()]


def test_two_process_distributed_scores_exact(tmp_path):
    """test_multihost.py::test_two_process_distributed_scores_exact: the
    matrix document-sharded over both processes' cells, scored by each
    process's own cells and exchanged: full ranking, top-k, a group of
    two batches and the sequence split give the numpy count on both
    processes, with one exchange per batch or group."""
    outs = _run_two_process("scores", tmp_path)
    for i, out in enumerate(outs):
        assert f"process {i}: multihost scores exact" in out


def test_two_process_construct_and_federate(tmp_path):
    """test_multihost.py::test_two_process_construct_and_federate: each
    process builds the index of its document slice, then both open the
    federation on their own and over the global mesh; every ranking
    equals cobs_tpu's single build's."""
    import cobs_tpu
    from cobs_tpu.settings import settings as jax_settings

    seqs = _worker_corpus_seqs()
    docs = tmp_path / "docs"
    docs.mkdir()
    for i, seq in enumerate(seqs):
        (docs / f"doc{i:03d}.fasta").write_bytes(b">d\n" + seq + b"\n")
    outs = _run_two_process("construct", tmp_path)
    jax_settings.disable_cache = True
    try:
        single = tmp_path / "single.cobs_classic"
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(docs), single,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
        want = _pairs(cobs_tpu.Search(str(single)).search_batch(
            _worker_queries(seqs), 0.0))
    finally:
        jax_settings.disable_cache = False
    want = [[list(p) for p in rl] for rl in want]
    for i, out in enumerate(outs):
        assert f"process {i}: multihost construct+federation exact" in out
        got = json.loads((tmp_path / f"result{i}.json").read_text())
        assert got == {"federated": want, "meshed": want}


# -------------------------------------------- single process (construct)

def _corpus(tmp_path, n_docs=20, seed=3):
    rng = np.random.default_rng(seed)
    d = tmp_path / "docs"
    d.mkdir()
    seqs = []
    for i in range(n_docs):
        seq = BASES[rng.integers(0, 4, size=120 + 41 * i)].tobytes()
        seqs.append(seq)
        (d / f"doc{i:03d}.fasta").write_bytes(b">d\n" + seq + b"\n")
    return d, seqs


def _settings(monkeypatch):
    from cobs_tpu.settings import settings as jax_settings
    from cobs_tpu_torch import settings

    for s in (settings, jax_settings):
        monkeypatch.setattr(s, "disable_cache", True)
    monkeypatch.setattr(settings, "threads", 2)
    monkeypatch.setattr(jax_settings, "device_hash", "host")


def test_partition_documents_covers_and_aligns(tmp_path, monkeypatch):
    """test_multihost_construct.py::test_partition_documents_covers_and_
    aligns, and the same slices as cobs_tpu's partition."""
    import cobs_tpu
    from cobs_tpu.parallel import distributed as jax_distributed
    from cobs_tpu_torch import DocumentList
    from cobs_tpu_torch.parallel import distributed

    _settings(monkeypatch)
    d, _ = _corpus(tmp_path, n_docs=20)
    dl = DocumentList(d)
    parts = [distributed.partition_documents(dl, 2, i) for i in range(2)]
    assert len(parts[0]) % 8 == 0
    assert len(parts[0]) + len(parts[1]) == 20
    names = [e.name for p in parts for e in p.list()]
    assert names == sorted(e.name for e in dl.list())
    again = distributed.partition_documents(DocumentList(d), 2, 0)
    assert [e.name for e in again.list()] == \
        [e.name for e in parts[0].list()]
    jdl = cobs_tpu.DocumentList(d)
    for by_size, align in ((False, 8), (True, 16)):
        for i in range(2):
            mine = distributed.partition_documents(dl, 2, i, by_size,
                                                   align)
            theirs = jax_distributed.partition_documents(jdl, 2, i,
                                                         by_size, align)
            assert [e.name for e in mine.list()] == \
                [e.name for e in theirs.list()]


def _construct_two(distributed, d, prefix, kind, params_fn):
    from cobs_tpu_torch import DocumentList

    return [distributed.construct(DocumentList(d), prefix, kind=kind,
                                  index_params=params_fn(),
                                  num_processes=2, process_id=i)
            for i in range(2)]


def test_multihost_classic_federation_is_bit_exact(tmp_path, monkeypatch):
    """test_multihost_construct.py::test_multihost_classic_federation_is_
    bit_exact: the shards share the global signature size, so the
    federation equals cobs_tpu's single build, false positives included;
    and each shard file is cobs_tpu's shard file byte for byte."""
    import cobs_tpu
    from cobs_tpu.parallel import distributed as jax_distributed
    from cobs_tpu_torch import ClassicIndexParameters
    from cobs_tpu_torch.parallel import distributed

    _settings(monkeypatch)
    d, seqs = _corpus(tmp_path, n_docs=20)
    single = tmp_path / "single.cobs_classic"
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(d), single,
        index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
    prefix = tmp_path / "fed"
    paths = _construct_two(
        distributed, d, prefix, "classic",
        lambda: ClassicIndexParameters(clobber=True, device="cpu"))
    assert paths == distributed.shard_paths(prefix, 2, "classic")
    jprefix = tmp_path / "jfed"
    for i in range(2):
        jax_distributed.construct(
            cobs_tpu.DocumentList(d), jprefix, kind="classic",
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True),
            num_processes=2, process_id=i)
    for i, p in enumerate(paths):
        assert Path(p).read_bytes() == \
            jax_distributed.shard_path(jprefix, i).read_bytes()
    fed = distributed.open_federated(prefix, 2, "classic", device="cpu")
    queries = [seqs[0][:60].decode(), seqs[9][10:80].decode(),
               seqs[19][:50].decode()]
    want = cobs_tpu.Search(str(single)).search_batch(queries, 0.0)
    assert _pairs(fed.search_batch(queries, 0.0)) == _pairs(want)


def _compact_federation(tmp_path, monkeypatch, n_docs, page_size):
    import cobs_tpu
    from cobs_tpu_torch import CompactIndexParameters
    from cobs_tpu_torch.parallel import distributed

    _settings(monkeypatch)
    d, seqs = _corpus(tmp_path, n_docs=n_docs)
    single = tmp_path / "single.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(d), single,
        index_params=cobs_tpu.CompactIndexParameters(
            clobber=True, page_size=page_size))
    prefix = tmp_path / "fedc"
    _construct_two(distributed, d, prefix, "compact",
                   lambda: CompactIndexParameters(
                       clobber=True, page_size=page_size, device="cpu"))
    return (distributed.open_federated(prefix, 2, "compact",
                                       device="cpu"),
            cobs_tpu.Search(str(single)), seqs)


@pytest.mark.parametrize("n_docs,page_size", [
    (24, 1),
    # 36 documents at 16 per page: a slice that is not a page multiple
    # without the page alignment
    (36, 2),
])
def test_multihost_compact_federation_is_bit_exact(tmp_path, monkeypatch,
                                                   n_docs, page_size):
    """test_multihost_construct.py::test_multihost_compact_federation_is_
    bit_exact: the federation's pages are the single build's."""
    fed, ref, seqs = _compact_federation(tmp_path, monkeypatch, n_docs,
                                         page_size)
    for i in (0, 11, n_docs - 1):
        r = fed.search(seqs[i][:62].decode(), 0.8)
        assert (r[0].doc_name, r[0].score) == (f"doc{i:03d}", 32)
    queries = [seqs[0][:62].decode(), seqs[11][5:90].decode(),
               seqs[n_docs - 1][:50].decode(), "ACGT" * 20]
    assert _pairs(fed.search_batch(queries, 0.0)) == \
        _pairs(ref.search_batch(queries, 0.0))


def test_multihost_compact_global_default_page_size(tmp_path,
                                                    monkeypatch):
    """test_multihost_construct.py::test_multihost_compact_global_default_
    page_size: the shard takes the page size of one build over the whole
    corpus, and a corpus of fewer than one page per process refuses."""
    import cobs_tpu
    from cobs_tpu.fmt.compact import read_compact_header
    from cobs_tpu_torch import CompactIndexParameters, DocumentList
    from cobs_tpu_torch.parallel import distributed

    _settings(monkeypatch)
    d, _ = _corpus(tmp_path, n_docs=24)
    single = tmp_path / "single.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(d), single,
        index_params=cobs_tpu.CompactIndexParameters(clobber=True))
    p = distributed.construct(
        DocumentList(d), tmp_path / "fedd", kind="compact",
        index_params=CompactIndexParameters(clobber=True, device="cpu"),
        num_processes=1, process_id=0)
    assert read_compact_header(p)[0].page_size == \
        read_compact_header(single)[0].page_size
    with pytest.raises(ValueError, match="fewer than one"):
        distributed.construct(
            DocumentList(d), tmp_path / "bad", kind="compact",
            index_params=CompactIndexParameters(clobber=True,
                                                device="cpu"),
            num_processes=2, process_id=1)


def test_federated_search_over_mesh_matches(tmp_path, monkeypatch):
    """test_multihost_construct.py::test_federated_search_over_mesh_
    matches: open_federated(mesh=...) shards every index over a (2, 4)
    mesh; full ranking and top-k equal the federation on one device and
    cobs_tpu's federation of the same files."""
    import cobs_tpu
    from cobs_tpu_torch import ClassicIndexParameters
    from cobs_tpu_torch.parallel import distributed
    from cobs_tpu_torch.parallel.sharded import make_mesh

    _settings(monkeypatch)
    d, seqs = _corpus(tmp_path, n_docs=16)
    prefix = tmp_path / "fedm"
    paths = _construct_two(
        distributed, d, prefix, "classic",
        lambda: ClassicIndexParameters(clobber=True, device="cpu"))
    queries = [seqs[2][:60].decode(), seqs[13][:45].decode()]
    flat = distributed.open_federated(prefix, 2, "classic", device="cpu")
    meshed = distributed.open_federated(
        prefix, 2, "classic", mesh=make_mesh(2, 4, ["cpu"] * 8))
    ref = cobs_tpu.Search([str(p) for p in paths])
    for k in (0, 3):
        want = _pairs(ref.search_batch(queries, 0.0, k))
        assert _pairs(flat.search_batch(queries, 0.0, k)) == want
        assert _pairs(meshed.search_batch(queries, 0.0, k)) == want


def test_open_federated_missing_shard_raises(tmp_path, monkeypatch):
    """test_multihost_construct.py::test_open_federated_missing_shard_
    raises."""
    from cobs_tpu_torch import ClassicIndexParameters, DocumentList
    from cobs_tpu_torch.parallel import distributed

    _settings(monkeypatch)
    d, _ = _corpus(tmp_path, n_docs=8)
    prefix = tmp_path / "half"
    distributed.construct(
        DocumentList(d), prefix, kind="classic",
        index_params=ClassicIndexParameters(clobber=True, device="cpu"),
        num_processes=2, process_id=0)
    with pytest.raises(FileNotFoundError):
        distributed.open_federated(prefix, 2, "classic", device="cpu")


# ---------------------------------------------------------------- worker

def _worker_scores(pid: int, work: Path) -> None:
    """multihost_worker.py: a synthetic index of 1,024 documents sharded
    over the global (2, 4) mesh; each process holds its "batch" row's
    four cells."""
    from cobs_tpu_torch import settings
    from cobs_tpu_torch.parallel import distributed, sharded
    from cobs_tpu_torch.parallel.sharded import ShardedIndex
    from cobs_tpu_torch.query.engine import DeviceIndex

    mesh = distributed.global_mesh(n_batch=2, devices=["cpu"] * 4)
    assert mesh.shape == {"batch": 2, "docs": 4}, mesh.shape
    assert mesh.local_cells() == [(pid, d) for d in range(4)]
    rng = np.random.default_rng(7)
    R, W = 257, 32
    matrix = rng.integers(0, 1 << 32, size=(R + 1, W),
                          dtype=np.uint64).astype(np.uint32)
    matrix[-1] = 0
    ix = DeviceIndex.from_arrays(
        matrix, [0], [R], W, term_size=31, canonicalize=1, num_hashes=2,
        page_size=W * 4, file_names=[f"d{i}" for i in range(W * 32)],
        device="cpu")
    sh = ShardedIndex(ix, mesh, word_align=8)
    B, T, h = 4, 64, 2
    rows = rng.integers(0, R, size=(B, T, h))
    hashes = [rows[b].astype(np.uint64) for b in range(B)]
    anded = matrix[rows[:, :, 0]]
    for j in range(1, h):
        anded = anded & matrix[rows[:, :, j]]
    bits = (anded[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    want = bits.sum(axis=1).reshape(B, -1).astype(np.int32)
    order = np.lexsort((np.broadcast_to(np.arange(W * 32), want.shape),
                        -want), axis=1)[:, :10]

    def check(what, group_exchanges):
        sharded.EXCHANGES = 0
        np.testing.assert_array_equal(sh.score_batch(hashes), want, what)
        v, d = sh.score_topk(hashes, 10)
        np.testing.assert_array_equal(d, order, what)
        np.testing.assert_array_equal(
            v, np.take_along_axis(want, order, axis=1), what)
        group = sh.score_batch_multi_async([hashes, hashes[:2]])
        np.testing.assert_array_equal(group[1].fetch(), want[:2], what)
        np.testing.assert_array_equal(group[0].fetch(), want, what)
        assert sharded.EXCHANGES == 2 + group_exchanges, (
            what, sharded.EXCHANGES)

    check("per-cell batches", 1)     # the group is one dispatch
    settings.seq_split_terms = 32
    assert sh._seq_split(hashes)
    check("sequence split", 2)       # the group goes batch by batch
    print(f"process {pid}: multihost scores exact", flush=True)


def _worker_construct(pid: int, work: Path) -> None:
    """multihost_construct_worker.py: process 0 writes the corpus (the
    parent wrote it already: process 0 checks it), each process builds
    its shard, then the federation is queried on one device and over the
    global mesh; the rankings go to result<pid>.json for the parent."""
    from cobs_tpu_torch import ClassicIndexParameters, DocumentList
    from cobs_tpu_torch.parallel import distributed

    seqs = _worker_corpus_seqs()
    docs = work / "docs"
    if pid == 0:
        for i, seq in enumerate(seqs):
            f = docs / f"doc{i:03d}.fasta"
            assert f.read_bytes() == b">d\n" + seq + b"\n"
    distributed.barrier("corpus")
    prefix = work / "fed"
    mine = distributed.construct(
        DocumentList(docs), prefix, kind="classic",
        index_params=ClassicIndexParameters(clobber=True, device="cpu"),
        tmp_path=work / f"tmp{pid}")
    assert mine == distributed.shard_path(prefix, pid, "classic")
    distributed.barrier("construct")
    queries = _worker_queries(seqs)
    fed = distributed.open_federated(prefix, 2, "classic", device="cpu")
    meshed = distributed.open_federated(
        prefix, 2, "classic",
        mesh=distributed.global_mesh(devices=["cpu"] * 4))
    got = {"federated": _pairs(fed.search_batch(queries, 0.0)),
           "meshed": _pairs(meshed.search_batch(queries, 0.0))}
    assert got["meshed"] == got["federated"]
    (work / f"result{pid}.json").write_text(json.dumps(got))
    distributed.barrier("done")
    print(f"process {pid}: multihost construct+federation exact",
          flush=True)


def _worker(mode: str, pid: int, work: Path) -> None:
    import torch

    from cobs_tpu_torch import settings
    from cobs_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    settings.disable_cache = True
    settings.threads = 2
    distributed.initialize(f"file://{work / 'store'}", num_processes=2,
                           process_id=pid, timeout=CHILD_TIMEOUT)
    assert distributed.process_count() == 2
    assert distributed.process_index() == pid
    try:
        {"scores": _worker_scores, "construct": _worker_construct}[mode](
            pid, work)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]))
