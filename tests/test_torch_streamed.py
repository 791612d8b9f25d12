"""cobs_tpu_torch's streamed (host-mmap) backend against cobs_tpu's, on the
CPU.

The port runs with device="cpu", so the gather-and-count kernel and the
hash kernel take their plain versions and the staging buffers are not
pinned; the host scorer, the row gather and the io_uring gather are the
port's own native library. Every output is an integer, so every
comparison is exact. The JAX target is tests/test_streamed.py.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cobs_tpu
from cobs_tpu.cli.main import main as jax_main
from cobs_tpu.query.engine import StreamedIndex as JaxStreamedIndex
from cobs_tpu.query.engine import create_hashes as jax_create_hashes
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import QueryError, Search, native, settings
from cobs_tpu_torch.cli.main import main as torch_main
from cobs_tpu_torch.query import engine
from cobs_tpu_torch.query.engine import (
    DeviceIndex,
    QueryBytes,
    StreamedIndex,
    create_hashes,
    score_batch,
    score_topk,
)
from cobs_tpu_torch.settings import Settings

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = {"classic": DATA / "golden" / "fasta7.cobs_classic",
          "compact": DATA / "golden" / "fasta7.cobs_compact"}
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
GOLDEN_LINES = [("sample1", 20), ("sample7", 3), ("sample2", 1),
                ("sample4", 1), ("sample6", 1), ("sample3", 0),
                ("sample5", 0)]
QUERIES = [GOLDEN_QUERY, GOLDEN_QUERY[3:], GOLDEN_QUERY[:40],
           GOLDEN_QUERY[5:]]
MODES = ["host", "device"]
KINDS = ["classic", "compact"]
#: the indexes of `built`: compact_pages has three pages of unequal
#: signature sizes (page_size=1 over 24 documents)
BUILT = ["classic", "compact", "compact_pages"]
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _settings():
    """Restore both packages' settings after every test; cobs_tpu hashes
    on the host and writes no document caches."""
    mine = (settings.streamed_host_score, settings.device_hash,
            settings.max_device_index_bytes, settings.load_complete_index)
    theirs = (jax_settings.streamed_host_score, jax_settings.device_hash,
              jax_settings.disable_cache)
    jax_settings.device_hash = "host"
    jax_settings.disable_cache = True
    yield
    (settings.streamed_host_score, settings.device_hash,
     settings.max_device_index_bytes, settings.load_complete_index) = mine
    (jax_settings.streamed_host_score, jax_settings.device_hash,
     jax_settings.disable_cache) = theirs


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Classic and compact indexes built by cobs_tpu from tests/data/fasta
    (tests/test_streamed.py::_mk), and a compact index of three pages
    over 24 random documents."""
    root = tmp_path_factory.mktemp("streamed")
    src = root / "fasta"
    shutil.copytree(DATA / "fasta", src,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    docs = root / "docs"
    docs.mkdir()
    rng = np.random.default_rng(12)
    for i in range(24):
        seq = BASES[rng.integers(0, 4, 60 + 40 * (i % 9))].tobytes()
        (docs / f"doc{i:03d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    old = jax_settings.disable_cache
    jax_settings.disable_cache = True
    try:
        out = {}
        for kind, corpus, params in (
                ("classic", src, cobs_tpu.ClassicIndexParameters(
                    clobber=True)),
                ("compact", src, cobs_tpu.CompactIndexParameters(
                    clobber=True)),
                ("compact_pages", docs, cobs_tpu.CompactIndexParameters(
                    page_size=1, clobber=True))):
            idx = root / f"{kind}.cobs_{kind.split('_')[0]}"
            construct = (cobs_tpu.classic_construct if kind == "classic"
                         else cobs_tpu.compact_construct)
            construct(cobs_tpu.DocumentList(corpus), idx,
                      index_params=params)
            out[kind] = str(idx)
    finally:
        jax_settings.disable_cache = old
    return out


def _hashes(ix, queries=QUERIES):
    return create_hashes([q.encode() for q in queries], ix.term_size,
                         ix.num_hashes, ix.canonicalize)


def _pairs(results):
    return [None if isinstance(rl, QueryError)
            else [(r.doc_name, r.score) for r in rl] for rl in results]


def _same_topk(a, b):
    """Top-k pairs equal; documents may differ only where the score is
    the -1 padding."""
    (va, da), (vb, db) = a, b
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(da[va >= 0], db[vb >= 0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", BUILT)
def test_streamed_scores_match_device_and_cobs_tpu(built, kind, mode):
    settings.streamed_host_score = jax_settings.streamed_host_score = mode
    st = StreamedIndex(built[kind], device="cpu")
    dev = DeviceIndex.from_file(built[kind], "cpu")
    ref = JaxStreamedIndex(built[kind])
    hashes = _hashes(st)
    got = st.score_batch(hashes)
    np.testing.assert_array_equal(got, score_batch(dev, hashes))
    np.testing.assert_array_equal(
        got, ref.score_batch(jax_create_hashes(
            [q.encode() for q in QUERIES], ref.term_size, ref.num_hashes,
            ref.canonicalize)))
    _same_topk(st.score_topk(hashes, 5), score_topk(dev, hashes, 5))
    _same_topk(st.score_topk(hashes, 5), ref.score_topk(hashes, 5))
    assert st.num_pages == ref.num_pages
    assert st.word_width == ref.word_width
    assert st.zero_row == ref.total_rows
    np.testing.assert_array_equal(st.row_offsets, ref.row_offsets)
    np.testing.assert_array_equal(st.sig_sizes, ref.sig_sizes)
    np.testing.assert_array_equal(st.row_indices(hashes[0]),
                                  ref.row_indices(hashes[0]))
    assert st.counts_size == ref.counts_size
    assert len(st._mms) == ref.num_pages
    assert st.num_pages == (3 if kind == "compact_pages" else 1)
    if kind == "compact_pages":
        assert len(set(st.sig_sizes.tolist())) > 1


@pytest.mark.parametrize("kind", BUILT)
def test_host_and_device_modes_agree_random(built, kind):
    """Raw random hashes with term counts 1, 7 and 130: the native host
    scorer and the gather + upload + kernel route agree bit for bit."""
    st = StreamedIndex(built[kind], device="cpu")
    rng = np.random.default_rng(5)
    hashes = [rng.integers(0, 1 << 63, size=(t, st.num_hashes),
                           dtype=np.uint64) for t in (1, 7, 130)]
    got = {}
    for mode in MODES:
        settings.streamed_host_score = mode
        got[mode] = (st.score_batch(hashes), st.score_topk(hashes, 5))
    np.testing.assert_array_equal(got["host"][0], got["device"][0])
    _same_topk(got["host"][1], got["device"][1])


@pytest.mark.parametrize("kind", BUILT)
def test_device_hash_route_matches_host_hash(built, kind):
    settings.streamed_host_score = "device"
    st = StreamedIndex(built[kind], device="cpu")
    qb = QueryBytes([q.encode() for q in QUERIES])
    np.testing.assert_array_equal(st.score_batch(qb),
                                  st.score_batch(_hashes(st)))
    _same_topk(st.score_topk(qb, 4), st.score_topk(_hashes(st), 4))
    got = {}
    for mode in ("device", "host"):
        settings.device_hash = mode
        s = Search(st)
        payload = s._hash_batch([q.encode() for q in QUERIES])[0]
        assert isinstance(payload, QueryBytes) == (mode == "device")
        got[mode] = _pairs(s.search_batch(QUERIES, 0.0))
    assert got["device"] == got["host"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", BUILT)
def test_cold_scores_match_warm(built, kind, mode):
    """drop_cache reads rows with io_uring and RWF_DONTCACHE; the scores
    equal the warm mmap path and cobs_tpu's cold path."""
    settings.streamed_host_score = jax_settings.streamed_host_score = mode
    warm = StreamedIndex(built[kind], device="cpu")
    cold = StreamedIndex(built[kind], device="cpu", drop_cache=True)
    hashes = _hashes(warm)
    want = warm.score_batch(hashes)
    np.testing.assert_array_equal(cold.score_batch(hashes), want)
    _same_topk(cold.score_topk(hashes, 5), warm.score_topk(hashes, 5))
    ref = JaxStreamedIndex(built[kind], drop_cache=True)
    np.testing.assert_array_equal(ref.score_batch(hashes), want)
    if native.uring_supported() is not True:
        pytest.skip("io_uring unavailable: cold mode read the mmap")


def test_after_score_skips_eviction_under_dontcache(built, monkeypatch):
    """Under working RWF_DONTCACHE reads the per-batch eviction does
    nothing; without them it evicts; a warm index has none."""
    cold = StreamedIndex(built["classic"], device="cpu", drop_cache=True)
    calls = []
    monkeypatch.setattr(cold, "drop_cache", lambda: calls.append(1))
    monkeypatch.setattr(native, "_dontcache_ok", True)
    cold._after_score()()
    assert calls == []
    monkeypatch.setattr(native, "_dontcache_ok", False)
    cold._after_score()()
    assert calls == [1]
    assert StreamedIndex(built["classic"], device="cpu")._after_score() \
        is None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_search_streamed_golden(kind, mode):
    settings.streamed_host_score = mode
    s = Search(str(GOLDEN[kind]), device="cpu", streamed=True)
    assert isinstance(s.index_files[0], StreamedIndex)
    for k in (0, 3):
        got = [(r.doc_name, r.score) for r in s.search(GOLDEN_QUERY, 0.0, k)]
        assert got == GOLDEN_LINES[:k or None]
    assert [(r.doc_name, r.score) for r in s.search(GOLDEN_QUERY, 0.8)] == \
        [("sample1", 20)]


def test_search_auto_streams_large_indices(built):
    settings.max_device_index_bytes = 10
    assert isinstance(Search(built["classic"], device="cpu").index_files[0],
                      StreamedIndex)
    assert isinstance(Search(built["classic"], device="cpu",
                             streamed=False).index_files[0], DeviceIndex)
    settings.load_complete_index = True
    assert isinstance(Search(built["classic"], device="cpu").index_files[0],
                      DeviceIndex)
    assert isinstance(Search(built["classic"], device="cpu",
                             streamed=True).index_files[0], StreamedIndex)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("num_results", [0, 3])
def test_search_stream_streamed_backend(built, mode, num_results):
    """search_stream over a streamed index equals search_batch and
    cobs_tpu's streamed search, both modes, full ranking and top-k."""
    settings.streamed_host_score = jax_settings.streamed_host_score = mode
    s = Search(built["compact_pages"], device="cpu", streamed=True)
    queries = QUERIES * 2
    want = s.search_batch(queries, 0.0, num_results)
    got = list(s.search_stream(iter(queries), 0.0, num_results,
                               batch_size=3))
    assert _pairs(got) == _pairs(want)
    ref = cobs_tpu.Search(built["compact_pages"], streamed=True)
    assert _pairs(want) == _pairs(ref.search_batch(queries, 0.0,
                                                   num_results))
    assert s.timer().get("and rows") > 0


@pytest.mark.parametrize("mode", MODES)
def test_search_stream_query_errors(built, mode):
    """An invalid query yields a QueryError in its slot; the rest of its
    batch ranks as search_batch does."""
    settings.streamed_host_score = mode
    s = Search(built["classic"], device="cpu", streamed=True)
    queries = [GOLDEN_QUERY, "ACGT", GOLDEN_QUERY[5:],
               "AGTCAACGCTAANGGCATTTCCCCCCTGCCTCCTGCCTGCTG"]
    got = list(s.search_stream(iter(queries), 0.0, batch_size=2))
    assert isinstance(got[1], QueryError) and "too short" in got[1].message
    assert isinstance(got[3], QueryError)
    assert "Invalid DNA base pair" in got[3].message
    want = s.search_batch([queries[0], queries[2]], 0.0)
    assert _pairs([got[0], got[2]]) == _pairs(want)
    # batches of one: some hold only an invalid query (no real row)
    assert _pairs(s.search_stream(iter(queries), 0.0, batch_size=1)) == \
        _pairs(got)


@pytest.mark.parametrize("mode", MODES)
def test_streamed_topk_matches_full(built, mode):
    settings.streamed_host_score = mode
    s = Search(built["classic"], device="cpu", streamed=True)
    for threshold in (0.0, 0.8):
        full = s.search(GOLDEN_QUERY, threshold, 0)
        for k in (1, 3, 10):
            assert _pairs([s.search(GOLDEN_QUERY, threshold, k)]) == \
                _pairs([full[:k]])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("num_results", [0, 4])
def test_federation_of_device_and_streamed(built, mode, num_results):
    """One device-held and one streamed index in one Search rank as
    cobs_tpu's federation of the same files; with host scoring the
    stream hashes ahead on its worker."""
    settings.streamed_host_score = mode
    s = Search([DeviceIndex.from_file(built["classic"], "cpu"),
                StreamedIndex(built["compact_pages"], device="cpu")])
    use = [s._use_device_hash(ix) for ix in s.index_files]
    assert use == [True, mode == "device"]
    want = _pairs(cobs_tpu.Search([built["classic"],
                                   built["compact_pages"]])
                  .search_batch(QUERIES, 0.1, num_results))
    assert _pairs(s.search_batch(QUERIES, 0.1, num_results)) == want
    assert _pairs(s.search_stream(QUERIES, 0.1, num_results,
                                  batch_size=3)) == want


def test_int32_route_choice(built, monkeypatch):
    """An index whose row ids pass int32 hashes on the host with int64
    ids, decided per index when the batch is hashed; its results do not
    change. The limit is lowered instead of writing a 2^31-row file."""
    settings.streamed_host_score = "device"
    st = StreamedIndex(built["classic"], device="cpu")
    s = Search(st)
    want = _pairs(s.search_batch(QUERIES, 0.0, 3))
    assert s._use_device_hash(st)
    monkeypatch.setattr(engine, "_MAX_ROW_ID", st.zero_row)
    assert not s._use_device_hash(st)
    assert not isinstance(s._hash_batch([GOLDEN_QUERY.encode()])[0],
                          QueryBytes)
    assert st.row_indices(_hashes(st)[0]).dtype == np.int64
    assert _pairs(s.search_batch(QUERIES, 0.0, 3)) == want
    assert _pairs(s.search_stream(QUERIES, 0.0, 3, batch_size=2)) == want
    with pytest.raises(ValueError, match="int32"):
        st.score_batch(QueryBytes([GOLDEN_QUERY.encode()]))


def test_one_buffer_staging_ring(built, monkeypatch):
    """A ring of one staging buffer, refilled for every batch and grown
    when a batch needs more rows, still scores every batch exactly."""
    settings.streamed_host_score = "device"
    queries = [GOLDEN_QUERY[:35], GOLDEN_QUERY] * 3 + QUERIES
    want = _pairs(Search(built["compact"], device="cpu", streamed=True)
                  .search_batch(queries, 0.0, 3))
    monkeypatch.setattr(engine, "STAGING_BUFFERS", 1)
    st = StreamedIndex(built["compact"], device="cpu")
    s = Search(st)
    got = _pairs(s.search_stream(queries, 0.0, 3, batch_size=1))
    assert got == want
    assert len(st._ring._bufs) == 1
    assert st.uploaded_batches == len(queries)


@pytest.mark.parametrize("kind", BUILT)
def test_stage_and_upload_counts(built, kind):
    """The device mode gathers each unique real row once, in id order,
    and uploads it with one zero row per batch; the kernel's row ids
    point into that buffer."""
    settings.streamed_host_score = "device"
    st = StreamedIndex(built[kind], device="cpu")
    hashes = _hashes(st)
    real = np.unique(np.concatenate([st.row_indices(h).ravel()
                                     for h in hashes]))
    gmat, rows = st.stage(hashes)
    assert rows.dtype == torch.int32 and rows.shape[0] == len(QUERIES)
    words = gmat.numpy().view(np.uint8)
    np.testing.assert_array_equal(words[:-1, :st.page_size],
                                  st._payload[real])
    assert not words[-1].any() and not words[:, st.page_size:].any()
    assert st.uploaded_rows == real.size and st.uploaded_batches == 1
    assert st.uploaded_bytes == (real.size + 1) * st.word_width * 4
    np.testing.assert_array_equal(
        engine._strip_word_padding(
            engine.gather_and_count(gmat, rows, st.num_hashes).numpy(),
            len(QUERIES), st.doc_layout),
        st.score_batch(hashes))


@pytest.mark.parametrize("value", ["auto", "device", "host"])
def test_streamed_score_setting(monkeypatch, value):
    monkeypatch.setenv("COBS_TPU_STREAMED_SCORE", value)
    assert Settings().streamed_host_score == value
    settings.streamed_host_score = value
    st = StreamedIndex(GOLDEN["classic"], device="cpu")
    # "auto" is "device" on a CUDA index only
    assert st.scores_on_host() is (value != "device")
    settings.streamed_host_score = "bogus"
    with pytest.raises(ValueError, match="streamed_host_score"):
        st.scores_on_host()


def test_streamed_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert settings.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamedIndex(GOLDEN["classic"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Search(str(GOLDEN["classic"]), streamed=True)


@pytest.mark.parametrize("args", [["--streamed"], ["--load-complete"],
                                  ["--streamed", "-l", "3"]])
@pytest.mark.parametrize("kind", KINDS)
def test_cmd_query_streamed_matches_cobs_tpu(capsys, kind, args):
    base = ["query", "-i", str(GOLDEN[kind]), "-t", "0", *args,
            GOLDEN_QUERY]
    assert jax_main(base) == 0
    want = capsys.readouterr().out
    assert torch_main(base + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[0] == "sample1\t20"
    assert not settings.load_complete_index


def test_cmd_query_streamed_and_load_complete_conflict(capsys):
    assert torch_main(["query", "-i", str(GOLDEN["classic"]), "--streamed",
                       "--load-complete", "--device", "cpu",
                       GOLDEN_QUERY]) == -1
    assert "at most one" in capsys.readouterr().err


def test_streamed_runs_without_jax():
    """The streamed backend and its native library import neither jax nor
    cobs_tpu (the card's machine has no JAX)."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["cobs_tpu"] = None
from cobs_tpu_torch import Search, settings
for mode in ("device", "host"):
    settings.streamed_host_score = mode
    s = Search({str(GOLDEN["compact"])!r}, device="cpu", streamed=True)
    got = [(r.doc_name, r.score) for r in s.search({GOLDEN_QUERY!r}, 0.0)]
    assert got == {GOLDEN_LINES!r}, got
assert not [m for m in sys.modules
            if m.startswith(("jax.", "jaxlib", "cobs_tpu."))]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
