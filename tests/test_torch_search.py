"""cobs_tpu_torch Search and `cobs query` against cobs_tpu's, on the CPU.

The golden anchor (reference: python/tests/test_cobs_index.py:22-61): the
50 bp query over the 7-document FASTA corpus ranks sample1 20, sample7 3,
sample2/4/6 1, sample3/5 0. The golden index files under
tests/data/golden are committed (chip_smoke.py queries them on the card,
where there is no JAX to build them) and rebuilt here to prove they are
what cobs_tpu builds.
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
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import Search, StreamedIndex, settings
from cobs_tpu_torch.cli.main import main as torch_main

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = {"classic": DATA / "golden" / "fasta7.cobs_classic",
          "compact": DATA / "golden" / "fasta7.cobs_compact"}
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
GOLDEN_LINES = [("sample1", 20), ("sample7", 3), ("sample2", 1),
                ("sample4", 1), ("sample6", 1), ("sample3", 0),
                ("sample5", 0)]
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _host_hashing(monkeypatch):
    """cobs_tpu hashes on the host, as the port does (same results as its
    device hashing, and no device-hash compile on the CPU)."""
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    monkeypatch.setattr(jax_settings, "disable_cache", True)


def _pairs(results):
    return [[(r.doc_name, r.score) for r in rl] for rl in results]


@pytest.mark.parametrize("kind", ["classic", "compact"])
@pytest.mark.parametrize("num_results", [0, 3])
def test_golden_query(kind, num_results):
    s = Search(str(GOLDEN[kind]), device="cpu")
    got = [(r.doc_name, r.score)
           for r in s.search(GOLDEN_QUERY, 0.0, num_results)]
    assert got == GOLDEN_LINES[:num_results or None]
    # the default threshold 0.8 keeps only the true positive
    assert [(r.doc_name, r.score) for r in s.search(GOLDEN_QUERY, 0.8)] \
        == [("sample1", 20)]


def test_golden_files_are_what_cobs_tpu_builds(tmp_path, capsys):
    src = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", src,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    for kind in ("classic", "compact"):
        out = tmp_path / GOLDEN[kind].name
        assert jax_main([f"{kind}-construct", str(src), str(out)]) == 0
        assert out.read_bytes() == GOLDEN[kind].read_bytes(), kind
    capsys.readouterr()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A 24-document random corpus as one classic h=3 index, and split
    into a classic part and a compact part for federation."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("corpus")
    parts = [root / "all", root / "p1", root / "p2"]
    for d in parts:
        d.mkdir()
    seqs = []
    for i in range(24):
        seq = BASES[rng.integers(0, 4, size=150 + 29 * i)].tobytes()
        seqs.append(seq)
        doc = b">s\n" + seq + b"\n"
        (parts[0] / f"d{i:02d}.fasta").write_bytes(doc)
        (parts[1 if i < 10 else 2] / f"d{i:02d}.fasta").write_bytes(doc)
    old = jax_settings.disable_cache
    jax_settings.disable_cache = True
    try:
        full, p1, p2 = (root / "all.cobs_classic", root / "p1.cobs_classic",
                        root / "p2.cobs_compact")
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(parts[0]), full,
            index_params=cobs_tpu.ClassicIndexParameters(num_hashes=3,
                                                         clobber=True))
        cobs_tpu.classic_construct(
            cobs_tpu.DocumentList(parts[1]), p1,
            index_params=cobs_tpu.ClassicIndexParameters(clobber=True))
        cobs_tpu.compact_construct(
            cobs_tpu.DocumentList(parts[2]), p2,
            index_params=cobs_tpu.CompactIndexParameters(
                num_hashes=1, page_size=1, clobber=True))
    finally:
        jax_settings.disable_cache = old
    queries = ([BASES[rng.integers(0, 4, size=n)].tobytes().decode()
                for n in (31, 60, 200)]
               + [seqs[i][j:j + n].decode()
                  for i, j, n in ((0, 5, 80), (9, 0, 150), (10, 40, 60),
                                  (23, 100, 400), (17, 3, 31))])
    return {"single": [str(full)], "federation": [str(p1), str(p2)],
            "queries": queries}


@pytest.mark.parametrize("which", ["single", "federation"])
@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.8])
@pytest.mark.parametrize("num_results", [0, 3])
def test_search_batch_matches_cobs_tpu(corpus, which, threshold,
                                       num_results):
    paths, queries = corpus[which], corpus["queries"]
    want = cobs_tpu.Search(paths).search_batch(queries, threshold,
                                               num_results)
    got = Search(paths, device="cpu").search_batch(queries, threshold,
                                                   num_results)
    assert _pairs(got) == _pairs(want)


@pytest.mark.parametrize("args", [
    ["-t", "0", GOLDEN_QUERY],
    ["-l", "2", "-t", "0.1", GOLDEN_QUERY],
    [GOLDEN_QUERY],
    ["-f", "QUERIES", "-t", "0.2"],
])
def test_cmd_query_stdout_matches_cobs_tpu(capsys, tmp_path, args):
    qf = tmp_path / "q.fa"
    qf.write_text(f">first\n{GOLDEN_QUERY}\n>second one\n"
                  f"{GOLDEN_QUERY[3:]}\n{GOLDEN_QUERY[:20]}\n")
    args = [str(qf) if a == "QUERIES" else a for a in args]
    index = ["-i", str(GOLDEN["classic"]), "-i", str(GOLDEN["compact"])]
    assert jax_main(["query", *index, *args]) == 0
    want = capsys.readouterr().out
    assert torch_main(["query", *index, "--device", "cpu", *args]) == 0
    got = capsys.readouterr().out
    assert got == want and got


def test_imports_and_answers_without_jax():
    """Every module of the port imports with jax and cobs_tpu blocked, and
    the port builds an index from the golden corpus and answers from it:
    the card's machine has no JAX."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["cobs_tpu"] = None
import pkgutil, importlib, shutil, tempfile
from pathlib import Path
import cobs_tpu_torch
for m in pkgutil.walk_packages(cobs_tpu_torch.__path__, "cobs_tpu_torch."):
    importlib.import_module(m.name)
from cobs_tpu_torch.cli.main import main
from cobs_tpu_torch.ops import _build
cobs_tpu_torch.disable_cache()
s = cobs_tpu_torch.Search({str(GOLDEN["classic"])!r}, device="cpu")
got = [(r.doc_name, r.score) for r in s.search({GOLDEN_QUERY!r}, 0.0)]
assert got == {GOLDEN_LINES!r}, got
tmp = Path(tempfile.mkdtemp())
shutil.copytree({str(DATA / "fasta")!r}, tmp / "fasta",
                ignore=shutil.ignore_patterns("*.cobs_cache"))
for kind in ("classic", "compact"):
    out = tmp / ("x.cobs_" + kind)
    assert main([kind + "-construct", str(tmp / "fasta"), str(out),
                 "--device", "cpu"]) == 0
    s = cobs_tpu_torch.Search(str(out), device="cpu")
    got = [(r.doc_name, r.score) for r in s.search({GOLDEN_QUERY!r}, 0.0)]
    assert got == {GOLDEN_LINES!r}, got
shutil.rmtree(tmp)
assert not [m for m in sys.modules
            if m.startswith(("jax.", "jaxlib", "cobs_tpu."))]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_requested_without_cuda_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Search(str(GOLDEN["classic"]), device="cuda")
    # the CLI's default device is cuda: an error, never a CPU fallback
    assert settings.device == "cuda"
    assert torch_main(["query", "-i", str(GOLDEN["classic"]),
                       GOLDEN_QUERY]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "ERROR:" in captured.err


def test_index_over_device_budget_raises(monkeypatch):
    """A file above the device budget is served by the streamed backend,
    with the same results; without CUDA, opening it for the default
    device raises instead of carrying on on the CPU."""
    monkeypatch.setattr(settings, "max_device_index_bytes", 1000)
    s = Search(str(GOLDEN["compact"]), device="cpu")
    assert isinstance(s.index_files[0], StreamedIndex)
    assert [(r.doc_name, r.score)
            for r in s.search(GOLDEN_QUERY, 0.0)] == GOLDEN_LINES
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Search(str(GOLDEN["compact"]))


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_device_budget_counts_device_bytes(monkeypatch, kind):
    """The budget is held against the bytes the index takes on the device
    (rows + 1 of 128-word padded rows: 4,479,488 B for the golden files),
    not the file's size (8,864 B classic): a budget between the two opens
    the file as a StreamedIndex, one of the device bytes loads it."""
    from cobs_tpu_torch.query.engine import DeviceIndex, device_index_bytes

    path = GOLDEN[kind]
    need = device_index_bytes(path)
    assert need == 4_479_488 > path.stat().st_size
    ix = DeviceIndex.from_file(path, "cpu")
    assert need == ix.matrix.numel() * 4
    monkeypatch.setattr(settings, "max_device_index_bytes", need - 1)
    s = Search(str(path), device="cpu")
    assert isinstance(s.index_files[0], StreamedIndex)
    assert [(r.doc_name, r.score)
            for r in s.search(GOLDEN_QUERY, 0.0)] == GOLDEN_LINES
    monkeypatch.setattr(settings, "max_device_index_bytes", need)
    assert isinstance(Search(str(path), device="cpu").index_files[0],
                      DeviceIndex)


def test_cmd_query_threads_flag(monkeypatch, capsys):
    """-T/--threads sets settings.threads, as cobs_tpu's does."""
    monkeypatch.setattr(settings, "threads", 1)
    assert torch_main(["query", "-i", str(GOLDEN["classic"]), "-t", "0",
                       "-T", "3", "--device", "cpu", "--streamed",
                       GOLDEN_QUERY]) == 0
    assert settings.threads == 3
    assert capsys.readouterr().out.splitlines()[0] == "sample1\t20"
