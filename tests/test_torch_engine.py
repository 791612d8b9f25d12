"""cobs_tpu_torch engine against cobs_tpu's, on the CPU.

Indexes are built with cobs_tpu (as tests/test_backends_agree.py and
tests/test_coalesce.py build them) and scored by both packages with the
same hashes: the port's `from_reference` reads cobs_tpu's matrix, its
`from_file` loads the file itself. Scores are integers: every comparison
is exact.
"""

import numpy as np
import pytest
import torch

import cobs_tpu
from cobs_tpu.query import engine as jeng
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch.core.canonical import canonicalize_batch
from cobs_tpu_torch.core.xxh64 import xxh64_multi_seed
from cobs_tpu_torch.ingest.util import sliding_windows
from cobs_tpu_torch.query import engine as teng

torch.set_num_threads(2)

BASES = np.frombuffer(b"ACGT", np.uint8)

#: kind -> (document lengths, index type, num_hashes, compact page size)
KINDS = {
    "classic_h1": ([150 + 31 * i for i in range(24)], "classic", 1, None),
    "classic_h3": ([150 + 31 * i for i in range(24)], "classic", 3, None),
    "compact_h2_pages": ([150 + 31 * i for i in range(24)], "compact", 2, 1),
    "compact_uniform_coalesced": ([300] * 64, "compact", 2, 2),
    "compact_run_coalesced": ([300] * 48 + [4000] * 16, "compact", 1, 2),
}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """kind -> (index path, one document's sequence), built once."""
    jax_settings.disable_cache = True
    rng = np.random.default_rng(0xC0B5)
    out = {}
    try:
        for kind, (lens, typ, h, page) in KINDS.items():
            root = tmp_path_factory.mktemp(kind)
            docs = root / "docs"
            docs.mkdir()
            seqs = []
            for i, n in enumerate(lens):
                seq = BASES[rng.integers(0, 4, size=n)].tobytes()
                seqs.append(seq)
                (docs / f"d{i:03d}.fasta").write_bytes(b">s\n" + seq + b"\n")
            idx = root / f"x.cobs_{typ}"
            dl = cobs_tpu.DocumentList(docs)
            if typ == "classic":
                cobs_tpu.classic_construct(
                    dl, idx, index_params=cobs_tpu.ClassicIndexParameters(
                        num_hashes=h, clobber=True))
            else:
                cobs_tpu.compact_construct(
                    dl, idx, index_params=cobs_tpu.CompactIndexParameters(
                        num_hashes=h, page_size=page, clobber=True))
            out[kind] = (idx, seqs)
    finally:
        jax_settings.disable_cache = False
    return out


def _queries(seqs, rng):
    """Random queries of several lengths plus windows of real documents
    (true positives in the first and last pages)."""
    qs = [BASES[rng.integers(0, 4, size=n)].tobytes() for n in (31, 64, 200)]
    return qs + [seqs[0][10:110], seqs[-1][:300]]


def _assert_same_scores(jix, tix, hashes):
    np.testing.assert_array_equal(teng.score_batch(tix, hashes),
                                  jeng.score_batch(jix, hashes))
    for k in (3, 10_000):
        jv, jd = jeng.score_topk(jix, hashes, k)
        tv, td = teng.score_topk(tix, hashes, k)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("kind", list(KINDS))
def test_from_reference_scores_match(built, rng, kind):
    idx, seqs = built[kind]
    jix = jeng.DeviceIndex.from_file(idx)
    tix = teng.DeviceIndex.from_reference(jix, device="cpu")
    queries = _queries(seqs, rng)
    hashes = jeng.create_hashes(queries, jix.term_size, jix.num_hashes,
                                jix.canonicalize)
    _assert_same_scores(jix, tix, hashes)


@pytest.mark.parametrize("kind,env", [
    ("classic_h1", {}),
    ("classic_h3", {}),
    ("compact_h2_pages", {}),
    ("compact_uniform_coalesced", {}),
    ("compact_run_coalesced", {}),
    ("compact_run_coalesced", {"COBS_TPU_COALESCE_PAGES": "0"}),
    ("compact_run_coalesced", {"COBS_TPU_RUN_CAP": "1"}),
])
def test_from_file_matches_reference_load(built, rng, monkeypatch, kind,
                                          env):
    """The port's own loader gives cobs_tpu's layout (same padded matrix,
    pages, coalescing) and the same public scores; one environment
    drives both loaders."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    idx, seqs = built[kind]
    jix = jeng.DeviceIndex.from_file(idx)
    tix = teng.DeviceIndex.from_file(idx, device="cpu")
    np.testing.assert_array_equal(
        tix.matrix.numpy().view(np.uint32), np.asarray(jix.matrix))
    np.testing.assert_array_equal(tix.row_offsets, jix.row_offsets)
    np.testing.assert_array_equal(tix.sig_sizes, jix.sig_sizes)
    assert (tix.word_width, tix.page_size, tix.file_names) == \
        (jix.word_width, jix.page_size, jix.file_names)
    assert (tix.page_docs is None) == (jix.page_docs is None)
    if jix.page_docs is not None:
        np.testing.assert_array_equal(tix.page_docs, jix.page_docs)
    assert tix.counts_size == jix.counts_size
    queries = _queries(seqs, rng)
    hashes = teng.create_hashes(queries, tix.term_size, tix.num_hashes,
                                tix.canonicalize)
    _assert_same_scores(jix, tix, hashes)


def test_coalescing_fixtures_coalesce(built):
    """The coalesced kinds really exercise the merged layouts."""
    uni = teng.DeviceIndex.from_file(
        built["compact_uniform_coalesced"][0], device="cpu")
    run = teng.DeviceIndex.from_file(
        built["compact_run_coalesced"][0], device="cpu")
    assert uni.num_pages == 1 and uni.page_docs is None
    assert list(run.page_docs) == [48, 16]


def test_negative_run_cap_raises(built, monkeypatch):
    monkeypatch.setenv("COBS_TPU_RUN_CAP", "-1")
    with pytest.raises(ValueError, match="COBS_TPU_RUN_CAP"):
        teng.DeviceIndex.from_file(built["compact_run_coalesced"][0],
                                   device="cpu")


@pytest.mark.parametrize("canonicalize,num_hashes", [(1, 1), (1, 3), (0, 2)])
def test_create_hashes_match(rng, canonicalize, num_hashes):
    queries = [BASES[rng.integers(0, 4, size=n)].tobytes()
               for n in (31, 32, 45, 100, 1030)]
    want = jeng.create_hashes(queries, 31, num_hashes, canonicalize)
    got = teng.create_hashes(queries, 31, num_hashes, canonicalize)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("query,match", [(b"ACGT" * 5, "too short"),
                                         (b"ACGTN" * 10, "Invalid DNA")])
def test_create_hashes_rejects_bad_queries(query, match):
    with pytest.raises(ValueError, match=match):
        teng.create_hashes([b"ACGT" * 10, query], 31, 1, 1)


def _numpy_hashes(queries, k, num_hashes, canonicalize):
    """The plain version: numpy canonicalization and XXH64, per query."""
    out = []
    for q in queries:
        w = sliding_windows(np.frombuffer(q, dtype=np.uint8), k)
        if canonicalize:
            w, _ = canonicalize_batch(w)
        out.append(xxh64_multi_seed(np.ascontiguousarray(w), num_hashes))
    return out


@pytest.mark.parametrize("k", [7, 15, 31, 32, 33, 64])
@pytest.mark.parametrize("canonicalize,num_hashes", [(1, 1), (1, 3), (0, 1),
                                                     (0, 2)])
def test_native_create_hashes_matches_numpy_and_cobs_tpu(rng, k,
                                                         canonicalize,
                                                         num_hashes):
    """The batch's windows hashed in one native call equal the numpy
    plain version and cobs_tpu's create_hashes, query by query; without
    canonicalization any byte is hashed as it is."""
    letters = BASES if canonicalize else np.frombuffer(b"ACGTNacgt$",
                                                        np.uint8)
    queries = [letters[rng.integers(0, letters.size, size=n)].tobytes()
               for n in (k, k + 1, k + 13, 100 + k, 1030)]
    got = teng.create_hashes(queries, k, num_hashes, canonicalize)
    plain = _numpy_hashes(queries, k, num_hashes, canonicalize)
    want = jeng.create_hashes(queries, k, num_hashes, canonicalize)
    assert len(got) == len(plain) == len(want) == len(queries)
    for g, p, w, q in zip(got, plain, want, queries):
        assert g.dtype == np.uint64 and g.shape == (len(q) - k + 1,
                                                    num_hashes)
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)


GOOD, SHORT, BAD = b"ACGT" * 10, b"ACGT" * 5, b"ACGTN" * 10


@pytest.mark.parametrize("batch,canonicalize,want", [
    ([SHORT], 1, "query too short"), ([BAD], 1, "Invalid DNA"),
    ([GOOD, SHORT], 1, "query too short"), ([GOOD, BAD], 1, "Invalid DNA"),
    ([GOOD, SHORT, BAD], 1, "query too short"),
    ([GOOD, BAD, SHORT], 1, "Invalid DNA"), ([BAD, GOOD], 0, None),
    ([BAD, SHORT], 0, "query too short"), ([b""], 1, "query too short"),
    ([GOOD], 2, "Unknown canonicalize value 2"), ([], 1, None)])
def test_create_hashes_errors_match_cobs_tpu(batch, canonicalize, want):
    """The same error text as cobs_tpu's for the first query at fault in
    batch order, or the same hashes when nothing is at fault (N is a
    letter like any other without canonicalization)."""
    def outcome(fn):
        try:
            return [h.tolist() for h in fn(batch, 31, 1, canonicalize)]
        except ValueError as e:
            return f"ValueError: {e}"

    got = outcome(teng.create_hashes)
    assert got == outcome(jeng.create_hashes)
    if want is None:
        assert isinstance(got, list) and len(got) == len(batch)
    else:
        assert got.startswith(f"ValueError: {want}")


def test_topk_keeps_reference_tie_order(rng):
    """The composed int64 key gives (score desc, slot asc), which
    torch.topk alone does not keep."""
    scores = rng.integers(0, 4, size=(8, 12288)).astype(np.int32)
    mask = rng.random(12288) < 0.9
    vals, slots = teng.topk_slots(torch.from_numpy(scores),
                                  torch.from_numpy(mask), 100)
    masked = np.where(mask[None, :], scores, -1)
    for b in range(8):
        order = np.lexsort((np.arange(12288), -masked[b]))[:100]
        np.testing.assert_array_equal(slots[b].numpy(), order)
        np.testing.assert_array_equal(vals[b].numpy(), masked[b, order])


def test_topk_slots_keys_in_place_on_its_own_copy(rng):
    """topk_slots builds its int64 key in place on its own masked copy:
    the caller's scores (a group's K1 output) are left as they were, and
    scores up to 2^30 rank in (score desc, slot asc) order."""
    scores = rng.integers(0, 4, size=(8, 1000)).astype(np.int32)
    scores[:, ::97] = 1 << 30
    mask = rng.random(1000) < 0.9
    t = torch.from_numpy(scores.copy())
    vals, slots = teng.topk_slots(t, torch.from_numpy(mask), 30)
    assert torch.equal(t, torch.from_numpy(scores))
    masked = np.where(mask, scores, -1).astype(np.int64)
    for b in range(8):
        order = np.lexsort((np.arange(1000), -masked[b]))[:30]
        np.testing.assert_array_equal(slots[b].numpy(), order)
        np.testing.assert_array_equal(vals[b].numpy(), masked[b, order])


def test_from_arrays_takes_numpy_and_torch(rng):
    m = rng.integers(0, 1 << 32, size=(9, 128), dtype=np.uint64) \
        .astype(np.uint32)
    m[-1] = 0
    common = dict(row_offsets=[0], sig_sizes=[8], word_width=128,
                  term_size=31, canonicalize=1, num_hashes=1, page_size=2,
                  file_names=[f"d{i}" for i in range(16)], device="cpu")
    a = teng.DeviceIndex.from_arrays(m, **common)
    b = teng.DeviceIndex.from_arrays(torch.from_numpy(m.view(np.int32)),
                                     **common)
    assert torch.equal(a.matrix, b.matrix)
    assert a.counts_size == 16 and a.zero_row == 8
    with pytest.raises(ValueError):
        teng.DeviceIndex.from_arrays(m[:, :64], **common)


@pytest.mark.parametrize("kind", ["classic_h3", "compact_run_coalesced"])
@pytest.mark.parametrize("device_hash", [True, False])
def test_multi_batch_dispatch_equals_single_batches(built, rng, monkeypatch,
                                                    kind, device_hash):
    """score_*_multi_async over K batches of different query lengths (one
    query flagged with length 0, as Search's lenient hashing flags an
    invalid query) calls each kernel once, and each batch's handle
    fetches exactly what the batch alone gives, and cobs_tpu's scores."""
    idx, seqs = built[kind]
    jix = jeng.DeviceIndex.from_file(idx)
    tix = teng.DeviceIndex.from_file(idx, device="cpu")
    batches = [_queries(seqs, rng), [seqs[3][:40], seqs[5][7:400]],
               [BASES[rng.integers(0, 4, size=33)].tobytes()]]
    hashes = [teng.create_hashes(b, tix.term_size, tix.num_hashes,
                                 tix.canonicalize) for b in batches]

    def payloads():
        if not device_hash:
            return hashes
        out = []
        for b in batches:
            qb = teng.QueryBytes(b)
            teng.prepack_query_bytes(tix, qb)
            out.append(qb)
        out[0].lens[1] = 0    # a flagged query: every term at the zero row
        return out

    calls = []
    k1 = teng.gather_and_count
    monkeypatch.setattr(teng, "gather_and_count",
                        lambda *a: calls.append(1) or k1(*a))
    multi = teng.score_batch_multi_async(tix, payloads())
    multi_k = teng.score_topk_multi_async(tix, payloads(), 5)
    assert len(calls) == 2 and len(multi) == len(multi_k) == 3
    for g, (p, pk) in enumerate(zip(multi, multi_k)):
        alone = payloads()[g]
        want = teng.score_batch(tix, alone)
        np.testing.assert_array_equal(p.fetch(), want)
        for a, b in zip(pk.fetch(), teng.score_topk(tix, alone, 5)):
            np.testing.assert_array_equal(a, b)
        jw = jeng.score_batch(jix, hashes[g])
        if device_hash and g == 0:
            assert not want[1].any()
            want, jw = np.delete(want, 1, 0), np.delete(jw, 1, 0)
        np.testing.assert_array_equal(want, jw)
