"""cobs_tpu_torch's ingest, k-mer codec, parameter math and document
formats against cobs_tpu's, on the CPU.

Both packages read the same documents (copies of the tests/data corpora
under tmp_path, so no cache file lands in tests/data). Every output is
bytes or integers, so every comparison is exact. The JAX targets are
tests/test_ingest.py, tests/test_streaming_ingest.py, tests/test_formats.py
and tests/test_params.py.
"""

import math
import shutil
from pathlib import Path

import numpy as np
import pytest

from cobs_tpu.core import kmer as jax_kmer
from cobs_tpu.core import params as jax_params
from cobs_tpu.fmt import kmer_buffer as jax_kmer_buffer
from cobs_tpu.ingest import document_list as jax_dl
from cobs_tpu.ingest import util as jax_util
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch.core import kmer, params
from cobs_tpu_torch.fmt import kmer_buffer
from cobs_tpu_torch.ingest import document_list as dl
from cobs_tpu_torch.ingest import util
from cobs_tpu_torch.settings import settings

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CORPORA = ["fasta", "fastq", "fasta_multi", "text", "cortex"]


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    """No cache files unless a test turns them on; both packages' settings
    come back after every test."""
    for s in (settings, jax_settings):
        monkeypatch.setattr(s, "disable_cache", True)
        monkeypatch.setattr(s, "threads", 2)


def _copy(tmp_path, corpus: str) -> Path:
    dst = tmp_path / corpus
    shutil.copytree(DATA / corpus, dst,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    return dst


def _entries(lst, root: Path):
    return [(str(Path(e.path).relative_to(root)), e.type.name, e.name,
             e.size, e.subdoc_index, e.term_size, e.term_count)
            for e in lst.list()]


@pytest.mark.parametrize("corpus", CORPORA)
def test_document_list_windows_and_terms_match_cobs_tpu(tmp_path, corpus):
    """Every reader: the same entries in the same order, the same term
    counts, and byte-identical term windows."""
    root = _copy(tmp_path, corpus)
    mine, theirs = dl.DocumentList(root), jax_dl.DocumentList(root)
    assert _entries(mine, root) == _entries(theirs, root)
    assert len(mine) > 0
    for k in (15, 31):
        for a, b in zip(mine.list(), theirs.list()):
            if a.type == dl.FileType.KMerBuffer and k != 31:
                continue
            assert a.num_terms(k) == b.num_terms(k)
            got = a.all_term_windows(k)
            np.testing.assert_array_equal(got, b.all_term_windows(k))
            if a.type != dl.FileType.Cortex:
                assert got.shape[0] == a.num_terms(k)


@pytest.mark.parametrize("chunk", [64, 1000, 1 << 20])
@pytest.mark.parametrize("kind", ["fasta", "fastq", "text"])
def test_streamed_windows_match_cobs_tpu_at_any_chunk(tmp_path, kind, chunk):
    """Term windows streamed through bounded buffers (the carry of k-1
    bytes across chunks) equal cobs_tpu's at every chunk size."""
    from cobs_tpu.ingest.fasta import FastaFile as JFasta
    from cobs_tpu.ingest.fastq import FastqFile as JFastq
    from cobs_tpu.ingest.text import TextFile as JText
    from cobs_tpu_torch.ingest.fasta import FastaFile
    from cobs_tpu_torch.ingest.fastq import FastqFile
    from cobs_tpu_torch.ingest.text import TextFile

    rng = np.random.default_rng(chunk)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seqs = [bases[rng.integers(0, 4, n)].tobytes()
            for n in (5, 3000, 40, 777)]
    path = tmp_path / f"doc.{kind if kind != 'text' else 'txt'}"
    if kind == "fasta":
        path.write_bytes(b"".join(
            b">s\n" + b"\n".join(s[i:i + 60] for i in range(0, len(s), 60))
            + b"\n" for s in seqs))
        mine, theirs = FastaFile(path), JFasta(path)
    elif kind == "fastq":
        path.write_bytes(b"".join(b"@r\n" + s + b"\n+\n" + b"I" * len(s)
                                  + b"\n" for s in seqs))
        mine, theirs = FastqFile(path), JFastq(path)
    else:
        path.write_bytes(b"\n".join(seqs))
        mine, theirs = TextFile(path), JText(path)
    got = list(mine.term_windows(31, chunk))
    want = list(theirs.term_windows(31, chunk))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("corpus,pattern", [("fasta", "*.fasta*"),
                                            ("fastq", "*.fastq*"),
                                            ("fasta_multi", "*.mfasta")])
def test_cache_files_byte_identical_and_shared(tmp_path, monkeypatch,
                                               corpus, pattern):
    """With caching on, both packages write the same .cobs_cache bytes
    beside the same document, and each reads the other's cache to the
    same sizes."""
    for s in (settings, jax_settings):
        monkeypatch.setattr(s, "disable_cache", False)
    mine_root = _copy(tmp_path / "mine", corpus)
    theirs_root = _copy(tmp_path / "theirs", corpus)
    mine = dl.DocumentList(mine_root)
    theirs = jax_dl.DocumentList(theirs_root)
    docs = sorted(p.name for p in mine_root.glob(pattern)
                  if not p.name.endswith(".cobs_cache"))
    assert docs
    for name in docs:
        a = (mine_root / (name + ".cobs_cache")).read_bytes()
        assert a == (theirs_root / (name + ".cobs_cache")).read_bytes()
    # swap the caches: each package now reads the other's files
    for name in docs:
        shutil.copy(theirs_root / (name + ".cobs_cache"),
                    mine_root / (name + ".cobs_cache"))
    swapped = dl.DocumentList(mine_root)
    assert _entries(swapped, mine_root) == _entries(mine, mine_root)
    assert _entries(mine, mine_root) == _entries(theirs, theirs_root)


def test_batches_order_and_parallel_processing_match_cobs_tpu(tmp_path):
    """_make_batches, sort_by_size (documents of equal size tie in path
    order), process_batches and process_batches_parallel on several
    threads give cobs_tpu's batches, each exactly once; sort_by_path and
    process_terms give cobs_tpu's order and terms."""
    root = tmp_path / "docs"
    root.mkdir()
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for i in range(37):
        n = 100 + 10 * (i % 4)          # many documents of equal size
        (root / f"d{(i * 17) % 37:02d}.fa").write_bytes(
            b">x\n" + bases[rng.integers(0, 4, n)].tobytes() + b"\n")
    mine, theirs = dl.DocumentList(root), jax_dl.DocumentList(root)
    mine.sort_by_size()
    theirs.sort_by_size()
    assert _entries(mine, root) == _entries(theirs, root)
    for size in (1, 8, 10, 64):
        got = [(n, [e.name for e in b], f)
               for n, b, f in mine._make_batches(size)]
        want = [(n, [e.name for e in b], f)
                for n, b, f in theirs._make_batches(size)]
        assert got == want
        seen = []
        mine.process_batches_parallel(
            size, 4, lambda n, b, f: seen.append((n, [e.name for e in b],
                                                  f)))
        assert sorted(seen) == got
        seen = []
        mine.process_batches(
            size, lambda n, b, f: seen.append((n, [e.name for e in b], f)))
        assert seen == got
    mine.sort_by_path()
    theirs.sort_by_path()
    assert _entries(mine, root) == _entries(theirs, root)
    for k in (15, 31):
        got, want = [], []
        mine[3].process_terms(k, got.append)
        theirs[3].process_terms(k, want.append)
        assert got == want and len(got) == mine[3].num_terms(k)


def test_list_files_and_filters_match_cobs_tpu(tmp_path):
    root = _copy(tmp_path, "fasta")
    lst = tmp_path / "docs.list"
    lst.write_text("# a comment\n\nfasta/sample1.fasta\n"
                   + str(root / "sample3.fasta.gz") + "\n")
    assert (_entries(dl.DocumentList(lst), tmp_path)
            == _entries(jax_dl.DocumentList(lst), tmp_path))
    (root / "notes.xyz").write_text("not a document")
    for ft in ("any", "fasta", "text", "list"):
        mine = dl.DocumentList(root, dl.string_to_file_type(ft))
        theirs = jax_dl.DocumentList(root, jax_dl.string_to_file_type(ft))
        assert _entries(mine, root) == _entries(theirs, root)
    with pytest.raises(ValueError, match="unknown file type"):
        dl.string_to_file_type("nope")


def test_util_matches_cobs_tpu(tmp_path, monkeypatch):
    """iter_lines (getline semantics, '\\r' kept, read chunks crossed),
    gzip, base_name and pad_index."""
    import gzip

    raw = b"a\r\nbb\n\nccc\nlast"
    (tmp_path / "x.txt").write_bytes(raw)
    with gzip.open(tmp_path / "x.txt.gz", "wb") as f:
        f.write(raw + b"\n")
    for mod in (util, jax_util):
        monkeypatch.setattr(mod, "_READ_CHUNK", 3)
    for name in ("x.txt", "x.txt.gz"):
        got = util.read_lines(tmp_path / name)
        assert got == jax_util.read_lines(tmp_path / name)
        assert got == [b"a\r", b"bb", b"", b"ccc", b"last"]
    for name in ("a.b.c", "/x/y.fasta.gz", "plain", ".hidden"):
        assert util.base_name(name) == jax_util.base_name(name)
    assert util.pad_index(7) == jax_util.pad_index(7) == "000007"
    assert util.pad_index(3, 2) == "03"


def test_kmer_codec_matches_cobs_tpu():
    rng = np.random.default_rng(9)
    for k in (1, 4, 15, 31, 32, 33):
        strings = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, (200, k))]
        packed = kmer.encode(strings)
        np.testing.assert_array_equal(packed, jax_kmer.encode(strings))
        np.testing.assert_array_equal(kmer.decode(packed, k), strings)
        np.testing.assert_array_equal(kmer.mirror(packed, k),
                                      jax_kmer.mirror(packed, k))
        np.testing.assert_array_equal(
            kmer.canonicalize_packed(packed, k),
            jax_kmer.canonicalize_packed(packed, k))
        np.testing.assert_array_equal(
            kmer.random_packed(50, k, np.random.default_rng(k)),
            jax_kmer.random_packed(50, k, np.random.default_rng(k)))


def test_kmer_buffer_files_match_cobs_tpu(tmp_path):
    rng = np.random.default_rng(4)
    packed = jax_kmer.random_packed(100, 31, rng)
    kmer_buffer.write_kmer_buffer(tmp_path / "a.cobs_doc", "doc", 31, packed)
    jax_kmer_buffer.write_kmer_buffer(tmp_path / "b.cobs_doc", "doc", 31,
                                      packed)
    assert ((tmp_path / "a.cobs_doc").read_bytes()
            == (tmp_path / "b.cobs_doc").read_bytes())
    h, got = kmer_buffer.read_kmer_buffer(tmp_path / "b.cobs_doc")
    assert (h.name, h.kmer_size) == ("doc", 31)
    np.testing.assert_array_equal(got, packed)
    assert kmer_buffer.is_kmer_buffer_file(tmp_path / "b.cobs_doc")
    # a .cobs_doc is a document: both lists read its 31-mers alike
    mine = dl.DocumentList(tmp_path)
    theirs = jax_dl.DocumentList(tmp_path)
    assert _entries(mine, tmp_path) == _entries(theirs, tmp_path)
    np.testing.assert_array_equal(mine[0].all_term_windows(31),
                                  theirs[0].all_term_windows(31))


@pytest.mark.parametrize("num_hashes", [1, 2, 3, 7])
@pytest.mark.parametrize("fpr", [0.01, 0.3, 0.5, 0.9])
def test_params_match_cobs_tpu(num_hashes, fpr):
    for n in (0, 1, 1000, 20_000_000):
        assert (params.calc_signature_size(n, num_hashes, fpr)
                == jax_params.calc_signature_size(n, num_hashes, fpr))
    sig = params.calc_signature_size(1000, num_hashes, fpr)
    assert math.isclose(
        params.calc_average_set_bit_ratio(sig, num_hashes, fpr),
        jax_params.calc_average_set_bit_ratio(sig, num_hashes, fpr),
        rel_tol=0, abs_tol=0)
