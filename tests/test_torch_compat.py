"""The reference's Python API test through `cobs_index_torch`, the port's
counterpart of the `cobs_index` shim (reference:
python/tests/test_cobs_index.py:1-64; the JAX target is
tests/test_cobs_index_compat.py), on the CPU (settings.device = "cpu").

Each test runs the reference's calls verbatim through both shims and
holds the port to cobs_index: the same document lists, byte-identical
index files and the same ranked results.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cobs_index
import cobs_index_torch as cobs
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch.settings import settings

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    """The port on the CPU; both shims' disable_cache() as the reference
    test calls it, undone after each test."""
    monkeypatch.setattr(settings, "device", "cpu")
    monkeypatch.setattr(settings, "disable_cache", False)
    monkeypatch.setattr(jax_settings, "disable_cache", False)
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    cobs.disable_cache()
    cobs_index.disable_cache()
    assert settings.disable_cache and jax_settings.disable_cache


@pytest.fixture()
def datadir(tmp_path):
    shutil.copytree(DATA / "fasta", tmp_path / "fasta",
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    return tmp_path


def _pairs(results):
    return [(r.doc_name, r.score) for r in results]


def test_doc_list(datadir):
    l1 = cobs.DocumentList(datadir / "fasta")
    assert l1.size() == 7

    l2 = cobs.DocumentList()
    l2.add_recursive(datadir / "fasta")
    assert l2.size() == 7
    want = cobs_index.DocumentList(datadir / "fasta")
    for got in (l1, l2):
        assert [(e.name, e.size, e.type.name) for e in got.list()] == \
            [(e.name, e.size, e.type.name) for e in want.list()]


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_construct_query(datadir, kind):
    """classic_construct / compact_construct with `input` as a path, then
    Search(path).search(GOLDEN): 7 results, sample1 first with 20."""
    index_file = datadir / f"python_test.cobs_{kind}"
    P = (cobs.ClassicIndexParameters if kind == "classic"
         else cobs.CompactIndexParameters)
    p = P()
    p.clobber = True
    construct = getattr(cobs, f"{kind}_construct")
    construct(input=str(datadir / "fasta"), out_file=index_file,
              index_params=p)
    assert index_file.is_file()

    s = cobs.Search(str(index_file))
    r = s.search(GOLDEN)
    assert len(r) == 7
    assert r[0].doc_name == "sample1"
    assert r[0].score == 20

    theirs = datadir / f"theirs.cobs_{kind}"
    q = getattr(cobs_index, f"{kind.capitalize()}IndexParameters")()
    q.clobber = True
    getattr(cobs_index, f"{kind}_construct")(
        input=str(datadir / "fasta"), out_file=theirs, index_params=q)
    assert index_file.read_bytes() == theirs.read_bytes()
    want = cobs_index.Search(str(theirs))
    for threshold, num_results in ((0.0, 0), (0.5, 0), (0.0, 3)):
        assert _pairs(s.search(GOLDEN, threshold=threshold,
                               num_results=num_results)) == \
            _pairs(want.search(GOLDEN, threshold=threshold,
                               num_results=num_results))


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_construct_list(datadir, kind):
    """classic_construct_list / compact_construct_list on a DocumentList,
    positional out_file, keyword index_params."""
    dl = cobs.DocumentList(datadir / "fasta")
    index_file = datadir / f"list_test.cobs_{kind}"
    P = (cobs.ClassicIndexParameters if kind == "classic"
         else cobs.CompactIndexParameters)
    p = P()
    p.clobber = True
    getattr(cobs, f"{kind}_construct_list")(dl, index_file, index_params=p)
    assert index_file.is_file()

    theirs = datadir / f"theirs.cobs_{kind}"
    q = getattr(cobs_index, f"{kind.capitalize()}IndexParameters")()
    q.clobber = True
    getattr(cobs_index, f"{kind}_construct_list")(
        cobs_index.DocumentList(datadir / "fasta"), theirs, index_params=q)
    assert index_file.read_bytes() == theirs.read_bytes()


def test_classic_construct_random_and_search_result(tmp_path):
    """classic_construct_random through the shim writes cobs_index's file
    for the same arguments; SearchResult unpacks as (name, score)."""
    mine, theirs = tmp_path / "mine.cobs_classic", tmp_path / "t.cobs_classic"
    cobs.classic_construct_random(mine, 4096, 20, 300, 2, 7)
    cobs_index.classic_construct_random(theirs, 4096, 20, 300, 2, 7)
    assert mine.read_bytes() == theirs.read_bytes()
    r = cobs.Search(str(mine)).search("ACGT" * 20, threshold=0.0)
    assert _pairs(r) == _pairs(cobs_index.Search(str(theirs)).search(
        "ACGT" * 20, threshold=0.0))
    name, score = r[0]
    assert isinstance(r[0], cobs.SearchResult) and (name, score) == \
        _pairs(r)[0]
    assert cobs.FileType.Fasta.name == cobs_index.FileType.Fasta.name


def test_shim_without_cuda_raises(datadir, monkeypatch):
    """Without settings.device = "cpu", the shim's construction and Search
    run on the CUDA card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(settings, "device", "cuda")
    p = cobs.ClassicIndexParameters()
    with pytest.raises(RuntimeError, match="CUDA"):
        cobs.classic_construct(input=str(datadir / "fasta"),
                               out_file=datadir / "x.cobs_classic",
                               index_params=p)
    assert not (datadir / "x.cobs_classic").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        cobs.Search(str(DATA / "golden" / "fasta7.cobs_classic"))


def test_shim_imports_neither_jax_nor_cobs_tpu():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["cobs_tpu"] = None
import cobs_index_torch
assert not [m for m in sys.modules
            if m.startswith(("jax.", "jaxlib", "cobs_tpu."))]
print(sorted(n for n in dir(cobs_index_torch) if not n.startswith("_")))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(sorted(
        n for n in dir(cobs_index) if not n.startswith("_")))
