"""The public behaviour that cobs_tpu's end-to-end suites check, on the
port, on the CPU: tests/test_end_to_end.py, tests/test_modes.py,
tests/test_fuzz.py (the same seeds) and tests/test_query_oracles.py.

Every index is built by both packages from the same documents (the port
on the CPU: the scatter kernel's plain version) and the files must be
byte-identical; every oracle of the JAX test is then asserted on the
port's answers, and every ranked result must equal cobs_tpu's on the same
queries. The tolerance is exact throughout.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cobs_tpu
import cobs_tpu_torch as ct
from cobs_tpu.cli.main import main as jax_main
from cobs_tpu.construct.classic import classic_combine as jax_combine
from cobs_tpu.construct.compact import \
    default_page_size as jax_default_page_size
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu.utils.misc import random_sequence as jax_random_sequence
from cobs_tpu_torch.cli.main import main as torch_main
from cobs_tpu_torch.construct.classic import classic_combine
from cobs_tpu_torch.construct.compact import (
    _round_up_pow2,
    default_page_size,
)
from cobs_tpu_torch.core.canonical import canonicalize_batch
from cobs_tpu_torch.core.kmer import encode
from cobs_tpu_torch.core.params import calc_average_set_bit_ratio
from cobs_tpu_torch.fmt import classic as fmt_classic
from cobs_tpu_torch.fmt import compact as fmt_compact
from cobs_tpu_torch.fmt.kmer_buffer import write_kmer_buffer
from cobs_tpu_torch.ingest.util import pad_index, sliding_windows
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.misc import random_sequence

torch.set_num_threads(2)

DATA = Path(__file__).parent / "data"
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
BASES = np.frombuffer(b"ACGT", np.uint8)
K = 31
#: the oracle suites' query (tests/test_query_oracles.py)
QUERY = random_sequence(50000, 2)


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    for s in (settings, jax_settings):
        monkeypatch.setattr(s, "disable_cache", True)
        monkeypatch.setattr(s, "threads", 2)
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setattr(jax_settings, "device_hash", "host")


@pytest.fixture()
def fasta_dir(tmp_path):
    d = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", d,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    return d


def _build(kind, docs, out: Path, **params) -> str:
    """Build `out` with the port and a file of its name under a `jax`
    directory beside it with cobs_tpu, from the same documents; the files
    must be identical. Returns the port's."""
    theirs = out.parent / "jax" / out.name
    if kind == "classic":
        ct.classic_construct(ct.DocumentList(docs), out,
                             index_params=ct.ClassicIndexParameters(
                                 clobber=True, **params))
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(docs), theirs,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True,
                                                         **params))
    else:
        ct.compact_construct(ct.DocumentList(docs), out,
                             index_params=ct.CompactIndexParameters(
                                 clobber=True, **params))
        cobs_tpu.compact_construct(
            cobs_tpu.DocumentList(docs), theirs,
            index_params=cobs_tpu.CompactIndexParameters(clobber=True,
                                                         **params))
    assert out.read_bytes() == theirs.read_bytes(), out.name
    return str(out)


def _pairs(results):
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


def _search_batch(paths, queries, threshold=0.0, num_results=0) -> list:
    """The port's ranked results, held equal to cobs_tpu's on the same
    files and queries."""
    got = ct.Search(paths).search_batch(queries, threshold, num_results)
    want = cobs_tpu.Search(paths).search_batch(queries, threshold,
                                               num_results)
    assert _pairs(got) == _pairs(want)
    return got


# ------------------------------------------- tests/test_end_to_end.py


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_construct_and_golden_query(fasta_dir, tmp_path, kind):
    path = _build(kind, fasta_dir, tmp_path / f"test.cobs_{kind}")
    if kind == "classic":
        h = fmt_classic.read_classic_header(path)
        assert (h.term_size, h.canonicalize, h.num_hashes) == (31, 1, 1)
        assert h.file_names == [f"sample{i}" for i in range(1, 8)]
    else:
        h, _ = fmt_compact.read_compact_header(path)
        assert len(h.file_names) == 7
    r = ct.Search(path).search(GOLDEN_QUERY)
    assert len(r) == 7
    assert (r[0].doc_name, r[0].score) == ("sample1", 20)


def test_classic_set_bit_ratio_bound(fasta_dir, tmp_path):
    """Per-document ones ratio bounded by the analytic expectation
    (reference: tests/classic_index_construction.cpp:73-92)."""
    path = _build("classic", fasta_dir, tmp_path / "r.cobs_classic",
                  num_hashes=3, false_positive_rate=0.1)
    h, rows = fmt_classic.read_classic_index(path)
    bound = calc_average_set_bit_ratio(h.signature_size, 3, 0.1)
    bits = np.unpackbits(rows, axis=1, bitorder="little")
    for d in range(len(h.file_names)):
        assert bits[:, d].mean() <= 1.01 * bound


def test_every_source_kmer_finds_its_document(fasta_dir, tmp_path):
    """No false negatives: sampled valid k-mers of every document find it
    (Bloom filters are one-sided)."""
    path = _build("classic", fasta_dir, tmp_path / "fn.cobs_classic")
    for e in ct.DocumentList(fasta_dir).list():
        windows = e.all_term_windows(31)
        windows = windows[canonicalize_batch(windows)[1]]
        if windows.shape[0] == 0:
            continue
        step = max(1, windows.shape[0] // 20)
        queries = ["".join(map(chr, w)) for w in windows[::step][:20]]
        for res_list, q in zip(_search_batch([path], queries), queries):
            found = {r.doc_name: r.score for r in res_list}
            assert found.get(e.name, 0) >= 1, (e.name, q)


def test_batch_serial_threshold_and_limit(fasta_dir, tmp_path):
    path = _build("classic", fasta_dir, tmp_path / "b.cobs_classic")
    s = ct.Search(path)
    queries = [GOLDEN_QUERY, GOLDEN_QUERY[:40], GOLDEN_QUERY[5:]]
    batch = _search_batch([path], queries, threshold=0.1)
    for q, want in zip(queries, batch):
        assert _pairs([s.search(q, threshold=0.1)]) == _pairs([want])
    # threshold 0.8: ceil(0.8 * 20) = 16 -> only sample1 (score 20)
    assert [x.doc_name for x in s.search(GOLDEN_QUERY, threshold=0.8)] == \
        ["sample1"]
    r = _search_batch([path], [GOLDEN_QUERY], num_results=3)[0]
    assert len(r) == 3 and r[0].doc_name == "sample1"


def test_multi_index_federation(fasta_dir, tmp_path):
    """Two sub-indexes federated in one search
    (reference: tests/classic_index_query.cpp:156-197)."""
    files = sorted(fasta_dir.iterdir())
    d1, d2 = tmp_path / "part1", tmp_path / "part2"
    d1.mkdir(), d2.mkdir()
    for f in files[:4]:
        shutil.copy(f, d1 / f.name)
    for f in files[4:]:
        shutil.copy(f, d2 / f.name)
    full = _build("classic", fasta_dir, tmp_path / "all.cobs_classic")
    fed = [_build("classic", d, tmp_path / f"{d.name}.cobs_classic")
           for d in (d1, d2)]
    r_fed = {x.doc_name: x.score
             for x in _search_batch(fed, [GOLDEN_QUERY])[0]}
    assert len(r_fed) == 7 and r_fed["sample1"] == 20
    r_all = {x.doc_name: x.score
             for x in _search_batch([full], [GOLDEN_QUERY])[0]}
    assert r_all["sample1"] == 20


def test_construct_refuses_existing_output_unless_clobber(fasta_dir,
                                                          tmp_path):
    """(reference: classic_index.cpp:173-174, 604-631)"""
    out = tmp_path / "c.cobs_classic"
    dl = ct.DocumentList(fasta_dir)
    P = ct.ClassicIndexParameters
    ct.classic_construct(dl, out, index_params=P())
    first = out.read_bytes()
    with pytest.raises(FileExistsError):
        ct.classic_construct(dl, out, index_params=P())
    out.write_bytes(b"")
    ct.classic_construct(dl, out, index_params=P(clobber=True))
    assert out.read_bytes() == first


# ----------------------------------------------- tests/test_modes.py


def test_text_qgram_mode(tmp_path):
    """Text documents, q-grams over the raw bytes, no canonicalization
    (reference: cobs/text_file.hpp:45-68)."""
    d = tmp_path / "text"
    shutil.copytree(DATA / "text", d,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    path = _build("classic", d, tmp_path / "t.cobs_classic", term_size=8,
                  canonicalize=0)
    q = (d / "sample1.txt").read_bytes()[5:30].decode()
    top = {r.doc_name: r.score
           for r in _search_batch([path], [q], threshold=1.0)[0]}
    assert top["sample1"] == len(q) - 8 + 1


def test_heterogeneous_federation(fasta_dir, tmp_path):
    """Indexes of different term sizes and hash counts in one search; each
    index's threshold uses its own term count
    (reference: cobs/query/classic_search.cpp:444-449)."""
    i1 = _build("classic", fasta_dir, tmp_path / "k31.cobs_classic")
    i2 = _build("classic", fasta_dir, tmp_path / "k15.cobs_classic",
                term_size=15, num_hashes=2)
    scores = {}
    for r in _search_batch([i1, i2], [GOLDEN_QUERY], threshold=0.9)[0]:
        scores.setdefault(r.doc_name, []).append(r.score)
    assert sorted(scores["sample1"], reverse=True) == [36, 20]


def test_medium_corpus_batch_query_file(tmp_path, rng, capsys):
    """~200 documents and a FASTA query file through the CLI: the port's
    stdout equals cobs_tpu's, and each query's own document scores
    80 - 31 + 1 = 50."""
    docs = tmp_path / "docs"
    docs.mkdir()
    seqs = []
    for i in range(200):
        seq = BASES[rng.integers(0, 4, size=300)].tobytes()
        seqs.append(seq)
        (docs / f"d{i:03d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    idx, theirs = tmp_path / "m.cobs_compact", tmp_path / "t.cobs_compact"
    assert torch_main(["compact-construct", str(docs), str(idx),
                       "--clobber", "--device", "cpu"]) == 0
    assert jax_main(["compact-construct", str(docs), str(theirs),
                     "--clobber"]) == 0
    assert idx.read_bytes() == theirs.read_bytes()
    qf = tmp_path / "q.fa"
    with open(qf, "wb") as f:
        for i in (0, 50, 150):
            f.write(b">q%d\n" % i + seqs[i][:80] + b"\n")
    capsys.readouterr()
    assert jax_main(["query", "-i", str(idx), "-f", str(qf), "-t",
                     "1.0"]) == 0
    want = capsys.readouterr().out
    assert torch_main(["query", "-i", str(idx), "-f", str(qf), "-t", "1.0",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out == want
    out = out.splitlines()
    for i in (0, 50, 150):
        j = out.index(next(x for x in out if x.startswith(f"*q{i}\t")))
        assert f"d{i:03d}\t50" in out[j + 1:j + 1 + int(
            out[j].split("\t")[1])]


def test_generate_queries_positives_are_findable(fasta_dir, tmp_path,
                                                 capsys):
    """Positives from generate-queries, through `query -f`, hit their
    source document at threshold 1.0, with cobs_tpu's lines
    (reference: src/cobs.cpp:734-959)."""
    qf = tmp_path / "q.fa"
    assert torch_main(["generate-queries", str(fasta_dir), "--positive",
                       "5", "-k", "31", "-s", "31", "--seed", "7", "-o",
                       str(qf)]) == 0
    path = _build("classic", fasta_dir, tmp_path / "g.cobs_classic")
    lines = qf.read_text().splitlines()
    # drop the queries with invalid letters: the query path rejects them,
    # as the reference does (reference: classic_search.cpp:93-96)
    pairs = [(lines[i], lines[i + 1]) for i in range(0, len(lines), 2)
             if not set(lines[i + 1]) - set("ACGT")]
    assert pairs and all(h.startswith(">doc:") for h, _ in pairs)
    valid = tmp_path / "valid.fa"
    valid.write_text("".join(f"{h}\n{s}\n" for h, s in pairs))
    capsys.readouterr()
    assert jax_main(["query", "-i", path, "-f", str(valid), "-t",
                     "1.0"]) == 0
    want = capsys.readouterr().out
    assert torch_main(["query", "-i", path, "-f", str(valid), "-t", "1.0",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out == want
    lines, i = out.splitlines(), 0
    for header, _ in pairs:
        comment, count = lines[i].rsplit("\t", 1)
        assert comment == "*" + header[1:]
        names = [x.split("\t")[0] for x in lines[i + 1:i + 1 + int(count)]]
        # header format: >doc:<doc_id>:term:<pos>:<name>
        assert header.split(":")[-1] in names, header
        i += 1 + int(count)
    assert i == len(lines)


def test_compact_default_page_size():
    assert [_round_up_pow2(x) for x in (1, 3, 4, 1000)] == [1, 4, 4, 1024]
    assert [default_page_size(n) for n in (1, 7, 10 ** 5, 10 ** 6, 10 ** 9)] \
        == [8, 8, 128, 512, 4096]
    ns = list(range(1, 5000)) + [10 ** 5, 10 ** 8]
    assert [default_page_size(n) for n in ns] == \
        [jax_default_page_size(n) for n in ns]


def test_multifasta_subdocuments(tmp_path):
    """Each `>` sequence of a multi-FASTA file is its own document; a
    valid term of each finds exactly that sub-document
    (reference: tests/fasta_multifile.cpp)."""
    d = tmp_path / "mf"
    shutil.copytree(DATA / "fasta_multi", d,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    dl = ct.DocumentList(d)
    assert dl.size() == 6
    assert sorted({e.name[:7] for e in dl.list()}) == ["sample1", "sample2"]
    path = _build("classic", d, tmp_path / "mf.cobs_classic", term_size=15)
    queries, names = [], []
    for e in dl.list():
        for w in e.term_windows(15):
            seq = next((row.tobytes().decode() for row in w
                        if not set(row.tobytes().decode()) - set("ACGT")),
                       None)
            if seq is not None:
                queries.append(seq)
                names.append(e.name)
                break
    assert queries  # sample2 holds protein sequences (invalid DNA)
    for res, name in zip(_search_batch([path], queries, threshold=1.0),
                         names):
        assert name in [r.doc_name for r in res], name


# ------------------------------------------------ tests/test_fuzz.py


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_config_own_substring_invariant(tmp_path, seed):
    """Random (k, h, fpr, page size, memory budget) configurations: every
    document's own substring scores all its terms, in the classic and the
    compact index (the same draws as tests/test_fuzz.py)."""
    rng = np.random.default_rng(seed)
    n_docs = int(rng.integers(9, 60))
    k = int(rng.choice([15, 21, 31]))
    h = int(rng.integers(1, 4))
    fpr = float(rng.choice([0.1, 0.3]))
    page_size = int(rng.choice([1, 2, 4]))
    docs = tmp_path / "docs"
    docs.mkdir()
    seqs = []
    tiers = (sorted(int(rng.integers(3 * k, 40 * k)) for _ in range(3))
             if rng.integers(0, 2) else None)
    for i in range(n_docs):
        n = (int(rng.choice(tiers)) if tiers
             else int(rng.integers(3 * k, 40 * k)))
        seq = BASES[rng.integers(0, 4, size=n)].tobytes()
        seqs.append(seq)
        (docs / f"d{i:03d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    common = dict(term_size=k, num_hashes=h, false_positive_rate=fpr)
    ci = _build("classic", docs, tmp_path / "x.cobs_classic",
                mem_bytes=int(rng.choice([1 << 10, 1 << 30])), **common)
    co = _build("compact", docs, tmp_path / "x.cobs_compact",
                page_size=page_size, **common)
    sample = rng.choice(n_docs, size=min(8, n_docs), replace=False)
    queries, wants = [], []
    for i in sample:
        seq = seqs[i]
        qlen = int(rng.integers(k, min(len(seq), 5 * k)))
        start = int(rng.integers(0, len(seq) - qlen + 1))
        queries.append(seq[start:start + qlen].decode())
        wants.append((f"d{i:03d}", qlen - k + 1))
    for path in (ci, co):
        for res, (name, score) in zip(
                _search_batch([path], queries, threshold=1.0), wants):
            assert {r.doc_name: r.score for r in res}.get(name) == score


@pytest.mark.parametrize("seed", [5, 6])
def test_random_text_qgram_invariant(tmp_path, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.choice([4, 8, 12]))
    docs = tmp_path / "docs"
    docs.mkdir()
    texts = []
    alphabet = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyz0123456789 _-", np.uint8)
    n_docs = int(rng.integers(5, 20))
    for i in range(n_docs):
        n = int(rng.integers(5 * k, 500))
        t = alphabet[rng.integers(0, len(alphabet), size=n)].tobytes()
        texts.append(t)
        (docs / f"t{i:02d}.txt").write_bytes(t)
    path = _build("classic", docs, tmp_path / "x.cobs_classic", term_size=k,
                  canonicalize=0, num_hashes=2)
    queries, wants = [], []
    for i in rng.choice(n_docs, size=min(5, n_docs), replace=False):
        t = texts[i]
        qlen = int(rng.integers(k, min(len(t), 6 * k)))
        start = int(rng.integers(0, len(t) - qlen + 1))
        queries.append(t[start:start + qlen].decode())
        wants.append((f"t{i:02d}", qlen - k + 1))
    for res, (name, score) in zip(
            _search_batch([path], queries, threshold=1.0), wants):
        assert {r.doc_name: r.score for r in res}.get(name) == score


# ---------------------------------------- tests/test_query_oracles.py


def _canon_kmers(query: str) -> np.ndarray:
    windows = sliding_windows(np.frombuffer(query.encode(), np.uint8), K)
    canon, good = canonicalize_batch(windows)
    assert good.all()
    return canon


def generate_documents_all(query, out_dir, num_documents=33):
    """Canonical query k-mer i lands in the documents j with
    j % (i % (n - 1) + 1) == 0 (reference: tests/test_util.hpp:42-102)."""
    canon = _canon_kmers(query)[:len(query) - K]
    packed = encode(canon)
    docs = [[] for _ in range(num_documents)]
    for i in range(canon.shape[0]):
        for j in range(0, num_documents, i % (num_documents - 1) + 1):
            docs[j].append(i)
    for j, rows in enumerate(docs):
        name = "document_" + pad_index(j)
        write_kmer_buffer(out_dir / (name + ".cobs_doc"), name, K,
                          packed[rows])
    return [len(rows) for rows in docs]


def generate_documents_one(query, out_dir, num_documents=33, prefix=""):
    """Only the query's first k-mer; document i holds it 10 i + 1 times
    (duplicates must not inflate the score)."""
    packed = encode(_canon_kmers(query)[:1])
    for i in range(num_documents):
        name = prefix + "document_" + pad_index(i)
        write_kmer_buffer(out_dir / (name + ".cobs_doc"), name, K,
                          np.repeat(packed, 10 * i + 1, axis=0))


ORACLE = dict(num_hashes=3, false_positive_rate=0.1, canonicalize=1)


def test_oracle_query_is_cobs_tpus():
    assert QUERY == jax_random_sequence(50000, 2)
    assert random_sequence(31, 9) == jax_random_sequence(31, 9)


def test_all_included(tmp_path):
    (tmp_path / "input").mkdir()
    sizes = generate_documents_all(QUERY, tmp_path / "input")
    path = _build("classic", tmp_path / "input",
                  tmp_path / "index.cobs_classic", **ORACLE)
    result = _search_batch([path], [QUERY])[0]
    assert len(result) == len(sizes)
    for r in result:
        assert r.score >= sizes[int(r.doc_name[-2:])]


def test_one_included(tmp_path):
    (tmp_path / "input").mkdir()
    generate_documents_one(QUERY, tmp_path / "input", num_documents=2000)
    path = _build("classic", tmp_path / "input",
                  tmp_path / "index.cobs_classic", **ORACLE)
    result = _search_batch([path], [QUERY])[0]
    assert len(result) == 2000
    assert all(r.score == 1 for r in result)


def test_false_positive_bound(tmp_path):
    """<= 1070 positive scores per document over 10,000 random 31-mers
    (reference: tests/classic_index_query.cpp:113-146)."""
    (tmp_path / "input").mkdir()
    generate_documents_all(QUERY, tmp_path / "input")
    path = _build("classic", tmp_path / "input",
                  tmp_path / "index.cobs_classic", **ORACLE)
    queries = [random_sequence(31, i) for i in range(10000)]
    num_positive = {}
    for results in _search_batch([path], queries):
        for r in results:
            assert r.score in (0, 1)
            num_positive[r.doc_name] = \
                num_positive.get(r.doc_name, 0) + r.score
    assert num_positive and all(v <= 1070 for v in num_positive.values())


def test_one_included_federation(tmp_path):
    """33 + 44 + 55-document indexes federated in one search
    (reference: tests/classic_index_query.cpp:156-197)."""
    paths = []
    for n in (33, 44, 55):
        (tmp_path / f"input{n}").mkdir()
        generate_documents_one(QUERY, tmp_path / f"input{n}",
                               num_documents=n, prefix=f"i{n}_")
        paths.append(_build("classic", tmp_path / f"input{n}",
                            tmp_path / f"index{n}.cobs_classic", **ORACLE))
    result = _search_batch(paths, [QUERY])[0]
    assert len(result) == 33 + 44 + 55
    assert all(r.score == 1 for r in result)


def test_classic_combine_ten_indexes(tmp_path):
    """Ten small indexes combined in one level: the same file as
    cobs_tpu's combine, and every source k-mer finds its document
    (reference: tests/classic_index_construction.cpp:95-152)."""
    index_dir = tmp_path / "index"
    index_dir.mkdir()
    doc_sets = []
    for ds in range(10):
        canon = _canon_kmers(random_sequence(10000, ds + 1))[:100]
        packed = encode(canon)
        input_dir = tmp_path / "input" / pad_index(ds)
        input_dir.mkdir(parents=True)
        kept = []
        for j in range(3):
            rows = [i for i in range(canon.shape[0]) if j % (i % 2 + 1) == 0]
            name = f"set_{pad_index(ds)}_document_{pad_index(j)}"
            write_kmer_buffer(input_dir / (name + ".cobs_doc"), name, K,
                              packed[rows])
            kept.append(canon[rows])
        doc_sets.append(kept)
        _build("classic", input_dir,
               index_dir / (pad_index(ds) + ".cobs_classic"),
               num_hashes=3, false_positive_rate=0.1)
    # cobs_tpu's first: the port's, like the JAX test, keeps no inputs
    jax_done, jax_file = jax_combine(
        index_dir, tmp_path / "combined_jax", 128 * 1024 * 1024, 4, True)
    done, result_file = classic_combine(
        index_dir, tmp_path / "combined", 128 * 1024 * 1024, 4, False)
    assert done and jax_done
    assert result_file.read_bytes() == jax_file.read_bytes()
    queries, expected = [], []
    for ds in range(10):
        for d, kmers in enumerate(doc_sets[ds]):
            for kmer in np.unique(kmers, axis=0)[:10]:
                queries.append(kmer.tobytes().decode())
                expected.append(f"set_{pad_index(ds)}_document_"
                                f"{pad_index(d)}")
    for results, want in zip(_search_batch([str(result_file)], queries),
                             expected):
        assert any(r.doc_name == want and r.score > 0 for r in results)
