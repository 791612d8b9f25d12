"""cobs_tpu_torch's document-sharded index (parallel/sharded.py) against
cobs_tpu, on the CPU.

Meshes here are grids of the CPU device repeated (`make_mesh(nb, nd,
["cpu"] * 8)`), the counterpart of cobs_tpu's 8 virtual CPU devices
(tests/conftest.py); each cell runs the kernels' plain versions. Every
sharded result is held to cobs_tpu's on the same index files and
queries: scores and ranked lists with exact integer equality (tolerance
0), tie order included. Each test names the cobs_tpu test it stands for.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cobs_tpu
from cobs_tpu.parallel import sharded as jax_sharded
from cobs_tpu.query import engine as jax_engine
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu.utils.misc import random_sequence
from cobs_tpu_torch import Search, settings
from cobs_tpu_torch.parallel import sharded
from cobs_tpu_torch.parallel.sharded import (
    ShardedIndex,
    assemble_scores,
    make_mesh,
    scatter_step,
    shard_words,
    train_step,
)
from cobs_tpu_torch.query import engine
from cobs_tpu_torch.query.engine import (
    DeviceIndex,
    QueryBytes,
    StreamedIndex,
    create_hashes,
)
from cobs_tpu_torch.query.search import QueryError

torch.set_num_threads(2)

DATA = Path(__file__).parent / "data"
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
CPU8 = ["cpu"] * 8
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    """cobs_tpu hashes on the host (its results equal its device
    hashing's, without a device-hash compile on the CPU); no document
    caches; the port's settings come back after every test."""
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    monkeypatch.setattr(jax_settings, "disable_cache", True)
    for name in ("device_hash", "mega_batches", "seq_split_terms"):
        monkeypatch.setattr(settings, name, getattr(settings, name))


def mesh(n_batch, n_docs):
    return make_mesh(n_batch, n_docs, CPU8[:n_batch * n_docs])


def _pairs(results):
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


@pytest.fixture(scope="module")
def classic_index(tmp_path_factory):
    """cobs_tpu's classic index of the golden corpus (test_sharded.py's
    fixture)."""
    tmp = tmp_path_factory.mktemp("sharded")
    index_file = tmp / "test.cobs_classic"
    jax_settings.disable_cache = True
    try:
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(DATA / "fasta"), index_file,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
    finally:
        jax_settings.disable_cache = False
    return index_file


@pytest.fixture(scope="module")
def ixs(classic_index):
    """The same file as the port's DeviceIndex and cobs_tpu's."""
    return (DeviceIndex.from_file(classic_index, "cpu"),
            jax_engine.DeviceIndex.from_file(classic_index))


def _jax_scores(jix, queries):
    hashes = jax_engine.create_hashes(queries, jix.term_size,
                                      jix.num_hashes, jix.canonicalize)
    return jax_engine.score_batch(jix, hashes)


def _jax_topk(jix, queries, k):
    hashes = jax_engine.create_hashes(queries, jix.term_size,
                                      jix.num_hashes, jix.canonicalize)
    return jax_engine.score_topk(jix, hashes, k)


def _assert_topk_equal(got, want):
    """Top-k pairs equal once the padding slots (score -1) are dropped."""
    (gv, gd), (wv, wd) = got, want
    for b in range(len(wv)):
        gm, wm = np.asarray(gv[b]) >= 0, np.asarray(wv[b]) >= 0
        np.testing.assert_array_equal(np.asarray(gv[b])[gm],
                                      np.asarray(wv[b])[wm])
        np.testing.assert_array_equal(np.asarray(gd[b])[gm],
                                      np.asarray(wd[b])[wm])


def test_make_mesh_contract():
    """test_make_mesh_shapes: the grid's shape, its devices in row order,
    repeated devices, and a request beyond the devices given raising
    (never a smaller mesh, never the CPU in place of a card)."""
    m = make_mesh(devices=CPU8)
    assert m.shape == {"batch": 1, "docs": 8}
    m = make_mesh(n_batch=2, devices=CPU8)
    assert m.shape == {"batch": 2, "docs": 4}
    assert m.devices[1][3] == torch.device("cpu")
    assert m.local_cells() == [(b, d) for b in range(2) for d in range(4)]
    with pytest.raises(ValueError, match="mesh needs 9 devices, only 8"):
        make_mesh(3, 3, CPU8)
    with pytest.raises(ValueError, match="mesh needs 1 devices, only 0"):
        make_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1, 1)


@pytest.mark.parametrize("n_batch,n_docs", [(1, 8), (2, 4), (8, 1)])
def test_sharded_scores_match_single_device(ixs, n_batch, n_docs):
    """test_sharded_scores_match_single_device."""
    ix, jix = ixs
    sh = ShardedIndex(ix, mesh(n_batch, n_docs), word_align=8)
    queries = [GOLDEN_QUERY.encode(), GOLDEN_QUERY[5:].encode(),
               GOLDEN_QUERY[:40].encode()]
    hashes = create_hashes(queries, ix.term_size, ix.num_hashes,
                           ix.canonicalize)
    want = _jax_scores(jix, queries)
    np.testing.assert_array_equal(sh.score_batch(hashes), want)
    np.testing.assert_array_equal(sh.score_batch(QueryBytes(queries)), want)


def _random_docs(root: Path, rng, n: int, base: int, step: int) -> Path:
    root.mkdir()
    for i in range(n):
        seq = BASES[rng.integers(0, 4, size=base + step * i)].tobytes()
        (root / f"doc{i:02d}.fasta").write_bytes(b">doc\n" + seq + b"\n")
    return root


def test_sharded_compact_matches_single_device(tmp_path, rng):
    """test_sharded_compact_matches_single_device: a compact index of
    several pages over a (2, 4) mesh."""
    docs = _random_docs(tmp_path / "docs", rng, 20, 200, 37)
    index_file = tmp_path / "test.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(docs), index_file,
        index_params=cobs_tpu.CompactIndexParameters(clobber=True,
                                                     page_size=1))
    ix = DeviceIndex.from_file(index_file, "cpu")
    assert ix.num_pages > 1
    jix = jax_engine.DeviceIndex.from_file(index_file)
    sh = ShardedIndex(ix, mesh(2, 4), word_align=8)
    q = [GOLDEN_QUERY.encode()]
    hashes = create_hashes(q, ix.term_size, ix.num_hashes, ix.canonicalize)
    np.testing.assert_array_equal(sh.score_batch(hashes),
                                  _jax_scores(jix, q))


def test_scatter_step_matches_host_bits(rng):
    """test_scatter_step_matches_host_bits: duplicates on purpose, bit
    for bit cobs_tpu's scatter_step on its 8-device mesh, and the zero
    row intact."""
    R, W, n = 64, 16, 500   # 512 documents over 8 shards
    rows = rng.integers(0, R, size=n).astype(np.int32)
    docs = rng.integers(0, W * 32, size=n).astype(np.int32)
    rows[: n // 4] = rows[n // 4: n // 2]
    docs[: n // 4] = docs[n // 4: n // 2]
    rows[-1] = R                     # an update of the zero row: dropped
    m = mesh(1, 8)
    words = scatter_step(m, shard_words(m, R, W), rows, docs)
    got = torch.cat(words).t().contiguous().numpy().view(np.uint32)
    want = np.zeros((R + 1, W), np.uint32)
    for r, d in zip(rows[:-1], docs[:-1]):
        want[r, d // 32] |= np.uint32(1) << np.uint32(d % 32)
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == 0).all()
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmesh = jax_sharded.make_mesh(n_batch=1, n_docs=8)
    jm = jax.device_put(np.zeros((R + 1, W), np.uint32),
                        NamedSharding(jmesh, P(None, "docs")))
    jout = jax_sharded.scatter_step(jmesh, jm, jnp.asarray(rows),
                                    jnp.asarray(docs))
    np.testing.assert_array_equal(got, np.asarray(jout))


def test_train_step_scatter_then_query():
    """test_train_step_scatter_then_query: set bits for a tiny corpus on
    a (2, 4) mesh, then query them back."""
    m = mesh(2, 4)
    R, W = 128, 8  # 256 documents
    rows = np.array([3, 17, 42, 3, 99], np.int32)
    docs = np.array([7, 7, 7, 200, 200], np.int32)
    rows_idx = np.full((2, 3, 1, 1), R, np.int32)   # padding: zero row
    rows_idx[0, :, 0, 0] = [3, 17, 42]
    rows_idx[1, :2, 0, 0] = [3, 99]
    _, scores = train_step(m, shard_words(m, R, W), rows, docs, rows_idx,
                           num_hashes=1)
    s = assemble_scores(scores, W * 32)
    assert s[0, 7] == 3 and s[1, 200] == 2
    assert s[0, 200] == 1 and s[1, 7] == 1
    mask = np.ones(W * 32, bool)
    mask[[7, 200]] = False
    assert (s[:, mask] == 0).all()
    from jax.sharding import NamedSharding, PartitionSpec as P
    jmesh = jax_sharded.make_mesh(n_batch=2, n_docs=4)
    jm = jax.device_put(np.zeros((R + 1, W), np.uint32),
                        NamedSharding(jmesh, P(None, "docs")))
    _, jscores = jax_sharded.train_step(
        jmesh, jm, jnp.asarray(rows), jnp.asarray(docs),
        jnp.asarray(rows_idx), num_hashes=1)
    np.testing.assert_array_equal(
        s, jax_sharded.assemble_scores(jscores, W * 32))


def test_search_with_mesh_matches_single_chip(classic_index):
    """test_search_with_mesh_matches_single_chip."""
    s1 = cobs_tpu.Search(str(classic_index))
    s2 = Search(str(classic_index), mesh=mesh(2, 4))
    for threshold in (0.0, 0.8):
        assert _pairs([s2.search(GOLDEN_QUERY, threshold)]) == \
            _pairs([s1.search(GOLDEN_QUERY, threshold)])


def test_sequence_axis_sharding_matches_single_device(ixs):
    """test_sequence_axis_sharding_matches_single_device: a long query's
    terms split over 4 "batch" rows, the partial counts summed."""
    ix, jix = ixs
    sh = ShardedIndex(ix, mesh(4, 2), word_align=8)
    q = [random_sequence(4096 + 30, 11).encode()]
    hashes = create_hashes(q, ix.term_size, ix.num_hashes, ix.canonicalize)
    got = sh._dispatch_seq(hashes, 0).get()
    np.testing.assert_array_equal(assemble_scores(got, ix.doc_layout),
                                  _jax_scores(jix, q))


def _count_seq(monkeypatch):
    calls = []
    orig = ShardedIndex._dispatch_seq
    monkeypatch.setattr(ShardedIndex, "_dispatch_seq",
                        lambda self, h, k: calls.append(len(h))
                        or orig(self, h, k))
    return calls


def test_search_auto_seq_split_long_query(classic_index, monkeypatch):
    """test_search_auto_seq_split_long_query: Search splits a long
    query's terms over the "batch" axis (settings.seq_split_terms, which
    also sends it to host hashing), a short one it does not."""
    calls = _count_seq(monkeypatch)
    monkeypatch.setattr(settings, "seq_split_terms", 256)
    s1 = cobs_tpu.Search(str(classic_index))
    s2 = Search(str(classic_index), mesh=mesh(4, 2))
    for q in (random_sequence(1000 + 30, 23), GOLDEN_QUERY):
        assert _pairs([s2.search(q, 0.0)]) == _pairs([s1.search(q, 0.0)])
    assert calls == [1]


def test_search_auto_seq_split_topk(classic_index, monkeypatch):
    """test_search_auto_seq_split_topk: the split serves top-k too."""
    calls = _count_seq(monkeypatch)
    monkeypatch.setattr(settings, "seq_split_terms", 256)
    s1 = cobs_tpu.Search(str(classic_index))
    s2 = Search(str(classic_index), mesh=mesh(4, 2))
    for q in (random_sequence(1000 + 30, 23), GOLDEN_QUERY):
        for thr in (0.0, 0.8):
            assert _pairs([s2.search(q, thr, num_results=4)]) == \
                _pairs([s1.search(q, thr, num_results=4)])
    assert calls == [1, 1]


def test_topk_seq_sharded_matches_single_device(ixs, monkeypatch):
    """test_topk_seq_sharded_matches_single_device."""
    ix, jix = ixs
    sh = ShardedIndex(ix, mesh(4, 2), word_align=8)
    q = [random_sequence(2048 + 30, 7).encode()]
    hashes = create_hashes(q, ix.term_size, ix.num_hashes, ix.canonicalize)
    monkeypatch.setattr(settings, "seq_split_terms", 256)
    assert sh._seq_split(hashes)
    _assert_topk_equal(sh.score_topk(hashes, 5), _jax_topk(jix, q, 5))


def test_search_mesh_multi_index_federation(classic_index, tmp_path):
    """test_search_mesh_multi_index_federation: every index of a
    federation sharded over the mesh."""
    idx2 = tmp_path / "second.cobs_classic"
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(DATA / "fasta"), idx2,
        index_params=cobs_tpu.ClassicIndexParameters(clobber=True,
                                                     num_hashes=2))
    paths = [str(classic_index), str(idx2)]
    s1 = cobs_tpu.Search(paths)
    s2 = Search(paths, mesh=mesh(2, 4))
    for num_results in (0, 3):
        r1 = s1.search(GOLDEN_QUERY, 0.0, num_results)
        assert _pairs([s2.search(GOLDEN_QUERY, 0.0, num_results)]) == \
            _pairs([r1])
    assert len(s1.search(GOLDEN_QUERY, 0.0)) == 14


@pytest.mark.parametrize("n_batch,n_docs", [(1, 8), (2, 4)])
def test_sharded_topk_matches_single_device(ixs, n_batch, n_docs):
    """test_sharded_topk_matches_single_device: per-shard top-k and the
    host merge equal cobs_tpu's single-device top-k."""
    ix, jix = ixs
    queries = [GOLDEN_QUERY.encode(),
               (GOLDEN_QUERY[:40] + "ACGTACGTA").encode()]
    hashes = create_hashes(queries, ix.term_size, ix.num_hashes,
                           ix.canonicalize)
    sh = ShardedIndex(ix, mesh(n_batch, n_docs), word_align=8)
    want = _jax_topk(jix, queries, 5)
    _assert_topk_equal(sh.score_topk(hashes, 5), want)
    _assert_topk_equal(sh.score_topk(QueryBytes(queries), 5), want)


def test_sharded_topk_ties_keep_the_lower_documents(ixs):
    """More than k documents of a shard tie at the cut: each shard must
    keep its lowest documents (topk_slots' order, cobs_tpu's lax.top_k),
    or the merged answer differs. A query no document matches ties all
    seven at 0; cobs_tpu's sharded top-k on its own (1, 8) mesh gives the
    same candidates."""
    ix, jix = ixs
    q = [b"C" * 40]
    hashes = create_hashes(q, ix.term_size, ix.num_hashes, ix.canonicalize)
    for nb, nd, align in ((1, 1, 8), (1, 8, 8), (2, 4, 8), (1, 2, 128)):
        got = ShardedIndex(ix, mesh(nb, nd), word_align=align) \
            .score_topk(hashes, 3)
        _assert_topk_equal(got, _jax_topk(jix, q, 3))
    jsh = jax_sharded.ShardedIndex(jix, jax_sharded.make_mesh(1, 8),
                                   word_align=8)
    jhashes = jax_engine.create_hashes(q, jix.term_size, jix.num_hashes,
                                       jix.canonicalize)
    got = ShardedIndex(ix, mesh(1, 8), word_align=8).score_topk(hashes, 3)
    want = jsh.score_topk(jhashes, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_search_mesh_topk_matches_single_chip(classic_index):
    """test_search_mesh_topk_matches_single_chip."""
    s1 = cobs_tpu.Search(str(classic_index))
    s8 = Search(str(classic_index), mesh=mesh(1, 8))
    for thr in (0.0, 0.8):
        assert _pairs([s8.search(GOLDEN_QUERY, thr, num_results=3)]) == \
            _pairs([s1.search(GOLDEN_QUERY, thr, num_results=3)])


def test_sharded_streamed_matches_device(classic_index, ixs):
    """test_sharded_streamed_matches_device: a StreamedIndex feeds the
    shards from its mmap; scores and top-k equal the held index's and
    cobs_tpu's."""
    ix, jix = ixs
    st = StreamedIndex(classic_index, "cpu")
    q = [GOLDEN_QUERY.encode()]
    hashes = create_hashes(q, ix.term_size, ix.num_hashes, ix.canonicalize)
    m = mesh(1, 8)
    sh_dev = ShardedIndex(ix, m, word_align=8)
    sh_st = ShardedIndex(st, m, word_align=8)
    np.testing.assert_array_equal(sh_st.score_batch(hashes),
                                  sh_dev.score_batch(hashes))
    np.testing.assert_array_equal(sh_st.score_batch(hashes),
                                  _jax_scores(jix, q))
    v1, d1 = sh_dev.score_topk(hashes, 4)
    v2, d2 = sh_st.score_topk(hashes, 4)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(d1, d2)


def test_search_mesh_streamed_end_to_end(tmp_path, rng):
    """test_search_mesh_streamed_end_to_end: Search(mesh, streamed=True)
    on a compact index, full ranking and top-k."""
    docs = _random_docs(tmp_path / "docs", rng, 40, 150, 23)
    idx = tmp_path / "x.cobs_compact"
    cobs_tpu.compact_construct(
        cobs_tpu.DocumentList(docs), idx,
        index_params=cobs_tpu.CompactIndexParameters(
            num_hashes=2, page_size=1, clobber=True))
    q = BASES[rng.integers(0, 4, size=80)].tobytes().decode()
    s1 = cobs_tpu.Search(str(idx))
    sm = Search(str(idx), mesh=mesh(1, 8), streamed=True)
    assert isinstance(sm.index_files[0], StreamedIndex)
    for num_results in (0, 7):
        assert _pairs([sm.search(q, 0.0, num_results)]) == \
            _pairs([s1.search(q, 0.0, num_results)])


def test_benchmark_scaling_harness_smoke():
    """test_benchmark_scaling_harness_smoke: the harness runs on a mesh
    of one repeated device, counts no cross-device copy and no exchange,
    and predicts min(1, d / n)."""
    from cobs_tpu_torch.parallel.benchmark import benchmark_scaling

    r = benchmark_scaling(n_devices=2, sig_size=1 << 10,
                          docs_per_shard=64, B=2, T=64, iters=2,
                          devices=["cpu"] * 2)
    assert set(r["per_n"]) == {1, 2}
    assert all(q > 0 for q in r["per_n"].values())
    assert r["efficiency"] is not None and r["efficiency"] > 0
    assert r["distinct"] == {1: 1, 2: 1}
    assert r["predicted_efficiency"] == 0.5
    assert r["copies_per_batch"] == {1: 0, 2: 0}
    assert r["exchanges_per_batch"] == {1: 0, 2: 0}
    with pytest.raises(ValueError, match="mesh needs 3 devices"):
        benchmark_scaling(n_devices=3, devices=["cpu"] * 2)


def test_search_stream_over_mesh_pipelined(classic_index):
    """test_search_stream_over_mesh_pipelined: search_stream over a mesh
    equals search_batch, full ranking and top-k, and isolates an invalid
    query."""
    s1 = cobs_tpu.Search(str(classic_index))
    s2 = Search(str(classic_index), mesh=mesh(1, 4))
    queries = [GOLDEN_QUERY, GOLDEN_QUERY[3:], "ACGT",
               GOLDEN_QUERY[:40]] * 2
    for num_results in (0, 3):
        want = s1.search_batch([q for q in queries if q != "ACGT"], 0.0,
                               num_results)
        got = list(s2.search_stream(iter(queries), 0.0, num_results,
                                    batch_size=3))
        assert sum(isinstance(g, QueryError) for g in got) == 2
        good = [g for g in got if not isinstance(g, QueryError)]
        assert _pairs(good) == _pairs(want)


@pytest.mark.parametrize("kind,num_hashes", [("classic", 1),
                                             ("classic", 3),
                                             ("compact", 2)])
def test_all_backends_agree_sharded(tmp_path, rng, kind, num_hashes):
    """tests/test_backends_agree.py::test_all_backends_agree, the
    sharded case: held, streamed and (2, 4)-sharded scores equal
    cobs_tpu's held scores."""
    docs = tmp_path / "docs"
    docs.mkdir()
    for i in range(24):
        seq = BASES[rng.integers(0, 4, size=150 + 31 * i)].tobytes()
        (docs / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idx = tmp_path / f"x.cobs_{kind}"
    dl = cobs_tpu.DocumentList(docs)
    if kind == "classic":
        cobs_tpu.classic_construct(
            dl, idx, index_params=cobs_tpu.ClassicIndexParameters(
                num_hashes=num_hashes, clobber=True))
    else:
        cobs_tpu.compact_construct(
            dl, idx, index_params=cobs_tpu.CompactIndexParameters(
                num_hashes=num_hashes, page_size=1, clobber=True))
    queries = [BASES[rng.integers(0, 4, size=n)].tobytes()
               for n in (31, 50, 200, 400)]
    want = _jax_scores(jax_engine.DeviceIndex.from_file(idx), queries)
    dev = DeviceIndex.from_file(idx, "cpu")
    hashes = create_hashes(queries, dev.term_size, dev.num_hashes,
                           dev.canonicalize)
    np.testing.assert_array_equal(engine.score_batch(dev, hashes), want)
    st = StreamedIndex(idx, "cpu")
    for ix in (dev, st):
        sh = ShardedIndex(ix, mesh(2, 4), word_align=8)
        np.testing.assert_array_equal(sh.score_batch(hashes), want)


def _batches(n_batches, per_batch, seed=5):
    """test_mega_dispatch.py's variable-length query batches."""
    return [[random_sequence(40 + 13 * ((g * per_batch + b) % 7),
                             seed + g * 100 + b).encode()
             for b in range(per_batch)] for g in range(n_batches)]


@pytest.mark.parametrize("kind,num_results",
                         [("device_hash", 0), ("device_hash", 4),
                          ("host_hash", 0), ("host_hash", 4)])
def test_sharded_multi_batch_equal_per_batch(ixs, kind, num_results):
    """tests/test_mega_dispatch.py::test_sharded_multi_batch_equal_per_
    batch (and the (device_hash, 0) case it leaves out for its compile
    time): K batches as one dispatch equal the batches one by one and
    cobs_tpu's single-device answers, with one launch of each kernel
    per cell for the group."""
    ix, jix = ixs
    sh = ShardedIndex(ix, mesh(2, 4), word_align=8)
    groups = _batches(3, 4, seed=23)
    payloads = ([QueryBytes(g) for g in groups] if kind == "device_hash"
                else [create_hashes(g, ix.term_size, ix.num_hashes,
                                    ix.canonicalize) for g in groups])
    if num_results == 0:
        multi = sh.score_batch_multi_async(payloads)
        for g, p, pd in zip(groups, payloads, multi):
            got = pd.fetch()
            np.testing.assert_array_equal(got,
                                          sh.score_batch_async(p).fetch())
            np.testing.assert_array_equal(got, _jax_scores(jix, g))
    else:
        multi = sh.score_topk_multi_async(payloads, num_results)
        for g, p, pd in zip(groups, payloads, multi):
            vm, dm = pd.fetch()
            v1, d1 = sh.score_topk_async(p, num_results).fetch()
            np.testing.assert_array_equal(vm, v1)
            np.testing.assert_array_equal(dm[vm >= 0], d1[v1 >= 0])
            _assert_topk_equal((vm, dm), _jax_topk(jix, g, num_results))


def test_sharded_stream_mega_matches_batch(classic_index, monkeypatch):
    """tests/test_mega_dispatch.py::test_sharded_stream_mega_matches_
    batch: search_stream over a mesh with groups of 4 batches equals
    cobs_tpu's search_batch, error slot included."""
    monkeypatch.setattr(settings, "mega_batches", 4)
    s = Search(str(classic_index), mesh=mesh(2, 4))
    assert s._mega_k() == 4
    queries = [q.decode() for g in _batches(8, 3, seed=31) for q in g]
    queries.insert(7, "ACGT")
    want = cobs_tpu.Search(str(classic_index)).search_batch(
        [q for q in queries if q != "ACGT"], 0.0, 5)
    got = list(s.search_stream(iter(queries), 0.0, 5, batch_size=3))
    assert sum(isinstance(g, QueryError) for g in got) == 1
    assert _pairs([g for g in got if not isinstance(g, QueryError)]) == \
        _pairs(want)


def test_sharded_multi_seq_split_falls_back(ixs, monkeypatch):
    """tests/test_mega_dispatch.py::test_sharded_multi_seq_split_falls_
    back: a group holding a batch that runs the sequence split goes
    batch by batch, exactly."""
    ix, jix = ixs
    monkeypatch.setattr(settings, "seq_split_terms", 64)
    sh = ShardedIndex(ix, mesh(2, 4), word_align=8)
    groups = [_batches(1, 3, seed=40)[0],
              [random_sequence(200, 7).encode()]]   # 170 terms >= 64
    payloads = [create_hashes(g, ix.term_size, ix.num_hashes,
                              ix.canonicalize) for g in groups]
    assert sh._seq_split(payloads[1]) and not sh._seq_split(payloads[0])
    for g, p, pd in zip(groups, payloads,
                        sh.score_batch_multi_async(payloads)):
        got = pd.fetch()
        np.testing.assert_array_equal(got, sh.score_batch_async(p).fetch())
        np.testing.assert_array_equal(got, _jax_scores(jix, g))


def test_sharded_search_matches_host_hashing(tmp_path, rng):
    """tests/test_device_hash.py::test_sharded_search_matches_host_
    hashing: on a mesh, hashing on the cells' devices equals hashing on
    the host and cobs_tpu."""
    docs = tmp_path / "docs"
    docs.mkdir()
    for i in range(40):
        seq = bytes(BASES[rng.integers(0, 4, 300 + 13 * i)])
        (docs / f"doc{i:03d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    out = tmp_path / "t.cobs_classic"
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(docs), out,
        index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
    queries = [bytes(BASES[rng.integers(0, 4, rng.integers(45, 100))])
               for _ in range(6)]
    ref = cobs_tpu.Search(str(out))
    m = mesh(2, 4)
    settings.device_hash = "host"
    s = Search(str(out), mesh=m)
    assert not any(hasattr(h, "queries") for h in s._hash_batch(queries))
    host = [_pairs(s.search_batch(queries, 0.0, k)) for k in (0, 4)]
    settings.device_hash = "device"
    s = Search(str(out), mesh=m)
    assert all(hasattr(h, "queries") for h in s._hash_batch(queries))
    for i, k in enumerate((0, 4)):
        got = _pairs(s.search_batch(queries, 0.0, k))
        assert got == host[i] == _pairs(ref.search_batch(queries, 0.0, k))


def test_merge_topk_host_equals_lexsort():
    """tests/test_query_oracles.py::test_merge_topk_host_equals_lexsort:
    the vectorized merge equals a per-query (score desc, doc asc)
    lexsort and cobs_tpu's merge on random shard candidates with heavy
    ties and -1 padding."""
    rng = np.random.default_rng(41)
    W32, docs_per_page = 64, 64
    lay = engine.DocLayout(W32, np.full(4, docs_per_page, np.int64),
                           np.arange(5, dtype=np.int64) * docs_per_page)
    jlay = jax_engine._uniform_layout(4, W32 // 32, docs_per_page)
    for trial in range(5):
        B, k, shards = int(rng.integers(1, 9)), 10, 4
        S = shards * k
        g = np.stack([rng.permutation(4 * W32)[:S]
                      for _ in range(B + 1)]).astype(np.int32)
        v = rng.integers(-1, 5, size=(B + 1, S)).astype(np.int32)
        out_v, out_d = sharded._merge_topk_host(v, g, W32, lay, B, k)
        jv, jd = jax_sharded._merge_topk_host(v, g, W32, jlay, B, k)
        np.testing.assert_array_equal(out_v, jv)
        np.testing.assert_array_equal(out_d, jd)
        doc = (g[:B].astype(np.int64) // W32) * docs_per_page \
            + g[:B] % W32
        for b in range(B):
            order = np.lexsort((doc[b], -v[b, :S].astype(np.int64)))[:k]
            assert np.array_equal(out_v[b], v[b][order]), (trial, b)
            assert np.array_equal(out_d[b], doc[b][order]), (trial, b)


@pytest.mark.parametrize("n_batch,n_docs", [(1, 8), (2, 4)])
def test_per_shard_scoring_moves_nothing_between_devices(ixs, n_batch,
                                                         n_docs):
    """Replaces tests/test_hlo_collectives.py's zero-collective checks:
    per-shard scoring (full ranking and top-k, host and device hashing,
    one batch and a group) makes no device-to-device copy and no call
    into the process group; every launch reads only its cell's shard.
    The sequence split, the one path that sums across a column, is the
    positive control: its sum is counted when the cells' devices differ
    and makes no copy when they are one device."""
    import torch.distributed as dist

    ix, _ = ixs
    sh = ShardedIndex(ix, mesh(n_batch, n_docs), word_align=8)
    queries = [GOLDEN_QUERY.encode(), GOLDEN_QUERY[:45].encode()]
    hashes = create_hashes(queries, ix.term_size, ix.num_hashes,
                           ix.canonicalize)
    sharded.CROSS_DEVICE_COPIES = sharded.EXCHANGES = 0
    called = []
    calls = {name: getattr(dist, name) for name in (
        "all_gather_object", "all_gather", "all_reduce", "broadcast")}
    try:
        for name in calls:
            setattr(dist, name, lambda *a, _n=name, **k: called.append(_n))
        for payload in (hashes, QueryBytes(queries)):
            sh.score_batch(payload)
            sh.score_topk(payload, 3)
            for p in sh.score_topk_multi_async([payload, payload], 3):
                p.fetch()
    finally:
        for name, fn in calls.items():
            setattr(dist, name, fn)
    assert sharded.CROSS_DEVICE_COPIES == 0
    assert sharded.EXCHANGES == 0 and called == []
    # positive control: the sum of the sequence split on distinct devices
    parts = [torch.ones(3, dtype=torch.int32), torch.ones(3,
                                                         dtype=torch.int32)]
    sh._seq_reduce(parts, 0, 0)
    assert sharded.CROSS_DEVICE_COPIES == 0   # one device: no copy
    sharded._to(parts[0], torch.device("meta"))
    assert sharded.CROSS_DEVICE_COPIES == 1


def test_dryrun_multichip_on_cpu_mesh():
    """__graft_entry__.py's entry() and dryrun_multichip, ported: the
    whole sharded step, a grouped dispatch and the serving surface on
    [cpu] * 8, and too few devices raising."""
    from cobs_tpu_torch.parallel.dryrun import dryrun_multichip, entry

    fn, args = entry("cpu")
    assert tuple(fn(*args).shape) == (8, 128 * 32)
    dryrun_multichip(8, devices=CPU8)
    dryrun_multichip(3, devices=CPU8)
    with pytest.raises(ValueError, match="mesh needs 8 devices"):
        dryrun_multichip(8, devices=["cpu"] * 4)
