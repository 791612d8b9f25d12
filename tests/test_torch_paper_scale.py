"""cobs_tpu_torch/experiments/paper_scale.py against cobs_tpu's
experiments/paper_scale.py, on the CPU, at a small size.

Both harnesses generate the corpus (300 documents of 2,000 bp, from the
same seed), compact-construct it through their own CLI with a --memory
small enough that every page is built as several classic sub-indices and
combined, and repack it. Corpora and index files must be byte-identical,
`verify` must pass in both, and the port's `Search` (device "cpu", the
kernels' plain versions) must rank the harness's random queries exactly
as cobs_tpu's does, on both files, with compact pages coalesced at load
and not. The tolerance is exact throughout.
"""

import contextlib
import io
import sys
from pathlib import Path

import pytest
import torch

import cobs_tpu
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import Search
from cobs_tpu_torch.experiments import paper_scale as ps
from cobs_tpu_torch.fmt.compact import read_compact_header
from cobs_tpu_torch.settings import settings

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "experiments"))
import paper_scale as jax_ps  # noqa: E402  (cobs_tpu's harness)
from mega_serve_bench import random_queries as jax_random_queries  # noqa: E402

torch.set_num_threads(2)

DOCS, DOC_SIZE, MEMORY = 300, 2000, "20KiB"
FILES = ("paper.cobs_compact", "paper_wide.cobs_compact")


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(port's root, cobs_tpu's root, the port's construction log): each
    harness's gen and build, with the same thread count and no document
    caches in both packages."""
    saved = [(s, s.threads, s.disable_cache)
             for s in (settings, jax_settings)]
    for s in (settings, jax_settings):
        s.threads, s.disable_cache = 2, True
    try:
        mine = tmp_path_factory.mktemp("port")
        theirs = tmp_path_factory.mktemp("cobs_tpu")
        log = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()):
            ps.gen(mine, DOCS, DOC_SIZE)
            jax_ps.gen(theirs, DOCS, DOC_SIZE)
            with contextlib.redirect_stderr(log):
                rcs = ps.build(mine, MEMORY, device="cpu")
            with contextlib.redirect_stderr(io.StringIO()):
                jax_ps.build(theirs, MEMORY)
        assert rcs["construct_rc"] == rcs["repack_rc"] == 0, rcs
        return mine, theirs, log.getvalue()
    finally:
        for s, threads, cache in saved:
            s.threads, s.disable_cache = threads, cache


def test_gen_writes_cobs_tpus_corpus(tmp_path):
    """1,100 documents (two subdirectories of the 1,000-per-directory
    layout, the planted document 0), byte for byte; and the same random
    queries."""
    with contextlib.redirect_stdout(io.StringIO()):
        ps.gen(tmp_path / "a", 1100, 120)
        jax_ps.gen(tmp_path / "b", 1100, 120)
    a, b = _tree(tmp_path / "a" / "docs"), _tree(tmp_path / "b" / "docs")
    assert len(a) == 1100 and a == b
    assert ps.PLANT_SEQ.encode() in a[Path("000/doc000000.fasta")]
    assert (ps.random_queries(40, 100)
            == jax_random_queries(40, 100))


def test_build_writes_cobs_tpus_files(built):
    mine, theirs, log = built
    assert _tree(mine / "docs") == _tree(theirs / "docs")
    for name in FILES:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()
    # the memory bound split every page: more classic sub-indices than
    # pages were written, and combined per page
    h, _ = read_compact_header(mine / FILES[0])
    wide, _ = read_compact_header(mine / FILES[1])
    assert len(h.parameters) > 1 and len(wide.parameters) == 1
    assert log.count("Construct Classic Index") > 2 * len(h.parameters)


def test_verify_passes_in_both(built, capsys):
    mine, theirs, _ = built
    ps.verify(mine, device="cpu")
    jax_ps.verify(theirs)
    out = capsys.readouterr().out
    assert out.count("planted positives exact (score 70/70) among 300 "
                     "docs") == 4


@pytest.mark.parametrize("coalesce", ["1", "0"])
@pytest.mark.parametrize("name", FILES)
def test_search_ranks_as_cobs_tpu(built, monkeypatch, name, coalesce):
    """The harness's random queries (and the planted one) at threshold 0,
    top 100 (ties among 300 documents) and at 0.3, full ranking."""
    mine, _, _ = built
    monkeypatch.setenv("COBS_TPU_COALESCE_PAGES", coalesce)
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    queries = [q.decode() for q in ps.random_queries(24, 100)]
    queries.append(ps.PLANT_SEQ)
    path = str(mine / name)
    port, ref = Search(path, device="cpu"), cobs_tpu.Search(path)
    pages = len(read_compact_header(path)[0].parameters)
    assert port.index_files[0].num_pages == (1 if coalesce == "1"
                                             else pages)
    for threshold, limit in ((0.0, 100), (0.3, 0)):
        got = port.search_batch(queries, threshold, limit)
        want = ref.search_batch(queries, threshold, limit)
        assert ([[(r.doc_name, r.score) for r in rl] for rl in got]
                == [[(r.doc_name, r.score) for r in rl] for rl in want])
    n_docs, plants = ps.planted(mine)
    assert ps.check_planted(port, n_docs, plants, name)[0] == (
        "doc000000", len(ps.PLANT_SEQ) - 30)


def test_serve_stage_held_and_streamed(built, capsys):
    """The serve stage on the CPU, held and streamed: two timed rounds
    of the RESULT line each, and the Search it served from."""
    mine, _, _ = built
    mega = settings.mega_batches
    for streamed in (False, True):
        res = ps.serve(mine, 48, 16, 2, streamed, num_kmers=100,
                       device="cpu")
        assert len(res["qps"]) == 2 and min(res["qps"]) > 0
        assert res["search"].index_files[0].file_names[0] == "doc000000"
    out = capsys.readouterr().out
    assert out.count("RESULT name=paper_serve") == 4
    assert settings.mega_batches == mega   # restored after the stage


def test_build_file_does_not_depend_on_memory(built, tmp_path):
    """The same corpus compact-constructed at 256MiB (every page one
    classic sub-index, its combine a rename) gives the file that 20KiB
    (every page several sub-indices, combined) gave."""
    mine, _, split_log = built
    (tmp_path / "docs").symlink_to(mine / "docs")
    log = io.StringIO()
    saved = settings.threads, settings.disable_cache
    settings.threads, settings.disable_cache = 2, True
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(log):
            rcs = ps.build(tmp_path, "256MiB", device="cpu")
    finally:
        settings.threads, settings.disable_cache = saved
    assert rcs["construct_rc"] == rcs["repack_rc"] == 0, rcs
    pages = len(read_compact_header(tmp_path / FILES[0])[0].parameters)
    assert log.getvalue().count("Construct Classic Index") == pages
    assert split_log.count("Construct Classic Index") > pages
    for name in FILES:
        assert (tmp_path / name).read_bytes() == (mine / name).read_bytes()
