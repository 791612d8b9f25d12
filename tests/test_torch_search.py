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
from cobs_tpu_torch import QueryError, Search, StreamedIndex, settings
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


@pytest.mark.parametrize("args", [
    ["-t", "0", GOLDEN_QUERY],
    ["-l", "2", "-t", "0.1", GOLDEN_QUERY],
    ["-f", "QUERIES", "-t", "0.2"],
])
def test_cmd_query_mesh_matches_cobs_tpu(capsys, tmp_path, args):
    """`query --mesh 1` shards each index over the first visible device of
    --device and prints cobs_tpu's lines; `--mesh 2` on one visible
    device (the CPU) raises in `query` and `serve`, never serving on
    fewer devices."""
    qf = tmp_path / "q.fa"
    qf.write_text(f">first\n{GOLDEN_QUERY}\n>second one\n"
                  f"{GOLDEN_QUERY[3:]}\n")
    args = [str(qf) if a == "QUERIES" else a for a in args]
    index = ["-i", str(GOLDEN["classic"]), "-i", str(GOLDEN["compact"])]
    assert jax_main(["query", *index, *args]) == 0
    want = capsys.readouterr().out
    assert torch_main(["query", *index, "--device", "cpu", "--mesh", "1",
                       *args]) == 0
    got = capsys.readouterr().out
    assert got == want and got
    for cmd in (["query", *index, *args],
                ["serve", *index, "--socket", str(tmp_path / "s.sock")]):
        assert torch_main([*cmd, "--device", "cpu", "--mesh", "2"]) == 1
        captured = capsys.readouterr()
        assert captured.out == ""
        assert "ERROR: mesh needs 2 devices, only 1 available" in \
            captured.err
    assert not (tmp_path / "s.sock").exists()


def test_cmd_benchmark_scaling(capsys):
    """`benchmark-scaling` (cobs_tpu/cli/main.py:1000): RESULT lines that
    name the distinct devices beside the shards, no cross-device copy and
    no exchange per batch; -n beyond the visible devices raises."""
    args = ["benchmark-scaling", "--device", "cpu", "--sig-size", "1024",
            "--docs-per-shard", "64", "-b", "2", "--num-kmers", "64",
            "--iterations", "2", "--batch-sweep", "1,2"]
    assert torch_main([*args, "-n", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("RESULT shards=1 distinct_devices=1 batch=2 ")
    assert out[0].endswith(" cross_device_copies_per_batch=0 "
                           "exchanges_per_batch=0")
    assert [line.split()[1] for line in out[1:]] == [
        "batch_sweep", "batch_sweep", "mesh_mega", "cost_model"]
    assert torch_main([*args, "-n", "2"]) == 1
    assert "mesh needs 2 devices, only 1 available" in \
        capsys.readouterr().err


def test_imports_and_answers_without_jax():
    """Every module of the port, parallel/* and the paper-scale and soak
    harnesses included, and the cobs_index_torch shim import with jax and
    cobs_tpu blocked; the port builds an index from the golden corpus and
    answers from it, on one device and sharded over a mesh, runs the
    subtools that read indexes and documents, and the two harnesses at a
    tiny size: the card's machine has no JAX."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["cobs_tpu"] = None
import contextlib, io, pkgutil, importlib, shutil, tempfile
from pathlib import Path
import cobs_tpu_torch
import cobs_index_torch
for m in pkgutil.walk_packages(cobs_tpu_torch.__path__, "cobs_tpu_torch."):
    importlib.import_module(m.name)
assert {{"cobs_tpu_torch.parallel." + m for m in (
    "sharded", "distributed", "benchmark", "dryrun")}} <= set(sys.modules)
assert {{"cobs_tpu_torch.experiments." + m for m in (
    "paper_scale", "server_soak")}} <= set(sys.modules)
from cobs_tpu_torch.experiments import paper_scale, server_soak
from cobs_tpu_torch.cli.main import main
from cobs_tpu_torch.ops import _build
from cobs_tpu_torch.parallel.sharded import make_mesh
cobs_tpu_torch.disable_cache()
s = cobs_tpu_torch.Search({str(GOLDEN["classic"])!r}, device="cpu")
got = [(r.doc_name, r.score) for r in s.search({GOLDEN_QUERY!r}, 0.0)]
assert got == {GOLDEN_LINES!r}, got
s = cobs_tpu_torch.Search({str(GOLDEN["compact"])!r},
                          mesh=make_mesh(2, 2, ["cpu"] * 4))
got = [(r.doc_name, r.score) for r in s.search({GOLDEN_QUERY!r}, 0.0, 3)]
assert got == {GOLDEN_LINES[:3]!r}, got
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
    for argv in (["info", str(out), "--scan"],
                 ["query", "-i", str(out), "--device", "cpu", "--profile",
                  str(tmp / "prof"), {GOLDEN_QUERY!r}]):
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv) == 0, argv
for argv in (["print-parameters", "-n", "1M"],
             ["print-kmers", {GOLDEN_QUERY!r}],
             ["generate-queries", str(tmp / "fasta"), "-p", "3", "-n", "2",
              "-s", "40"],
             ["doctor", "--device", "cpu"]):
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv) == 0, argv
with contextlib.redirect_stdout(io.StringIO()), \
        contextlib.redirect_stderr(io.StringIO()):
    paper_scale.gen(tmp / "paper", 24, 400)
    assert paper_scale.build(tmp / "paper", "64KiB", "cpu")["repack_rc"] == 0
    paper_scale.verify(tmp / "paper", "cpu")
    soak = server_soak.soak(1.0, 2, "cpu")
assert soak["ok"] and soak["exact"] > 0, soak
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


@pytest.mark.parametrize("seed", range(4))
def test_result_list_refinements_match_cobs_tpu(seed):
    """ResultList.pairs, cut and cut_per_index (the server's per-request
    refinements) equal cobs_tpu's on the same ranked arrays."""
    from cobs_tpu.query.search import ResultList as JaxResultList

    from cobs_tpu_torch.query.search import ResultList

    rng = np.random.default_rng(seed)
    names = [f"doc{i}" for i in range(40)]
    n = int(rng.integers(0, 41))
    gidx = rng.permutation(40)[:n]
    scores = rng.integers(0, 30, size=n)
    order = np.lexsort((gidx, -scores))   # (score desc, doc asc)
    g, sc = gidx[order].astype(np.int64), scores[order].astype(np.int64)
    got, want = ResultList(names, g, sc), JaxResultList(names, g, sc)
    assert got.pairs() == want.pairs()
    for min_score in (None, 0, 5, 17, 31):
        for limit in (None, 0, 1, 7, 100):
            assert got.cut(min_score, limit).pairs() == \
                want.cut(min_score, limit).pairs()
    bounds = np.cumsum([13, 9, 18])
    for mins in ([0, 0, 0], [5, 12, 1], [30, 30, 30]):
        assert got.cut_per_index(bounds, mins).pairs() == \
            want.cut_per_index(bounds, mins).pairs()


GROUP_B, GROUP_THRESHOLD = 3, 0.2


@pytest.fixture(scope="module")
def group_case(corpus):
    """48 queries (16 batches of 3) with two invalid ones, and cobs_tpu's
    rankings of the valid ones per (index set, num_results)."""
    rng = np.random.default_rng(17)
    queries = [BASES[rng.integers(0, 4, size=n)].tobytes().decode()
               for n in rng.integers(31, 120, size=16 * GROUP_B)]
    queries[4:4 + len(corpus["queries"])] = corpus["queries"]
    queries[2], queries[19] = "ACGT", "NACGT" * 10
    sets = {"single": corpus["single"],
            "compact": corpus["federation"][1:],
            "federation": corpus["federation"]}
    valid = [q for i, q in enumerate(queries) if i not in (2, 19)]
    old = jax_settings.device_hash
    jax_settings.device_hash = "host"
    try:
        want = {(which, nr): _pairs(cobs_tpu.Search(paths).search_batch(
                    valid, GROUP_THRESHOLD, nr))
                for which, paths in sets.items() for nr in (0, 3)}
    finally:
        jax_settings.device_hash = old
    return queries, sets, want


@pytest.mark.parametrize("K", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("which", ["single", "compact", "federation"])
@pytest.mark.parametrize("num_results", [0, 3])
@pytest.mark.parametrize("hashing", ["device", "host"])
def test_dispatch_group_matches_per_batch_and_cobs_tpu(
        group_case, monkeypatch, K, which, num_results, hashing):
    """_dispatch_group_async over K batches launches the gather-and-count
    once per index, the whole group at K times the batch size, and ranks
    exactly as one dispatch per batch and as cobs_tpu's search_batch;
    invalid queries keep their error in their own slot."""
    from cobs_tpu_torch.query import engine as teng

    queries, sets, want = group_case
    monkeypatch.setattr(settings, "device_hash", hashing)
    s = Search(sets[which], device="cpu")
    batches = [[q.encode() for q in queries[i:i + GROUP_B]]
               for i in range(0, K * GROUP_B, GROUP_B)]
    hashed = [s._hash_batch_lenient(b, s.timer_) for b in batches]
    calls = []
    k1 = teng.gather_and_count
    monkeypatch.setattr(teng, "gather_and_count",
                        lambda *a: calls.append(1) or k1(*a))
    group = s._dispatch_group_async([h for h, _ in hashed], num_results)
    assert len(calls) == len(s.index_files)
    single = [s._dispatch_async(h, num_results) for h, _ in hashed]
    got, alone = [], []
    for b, (_, errors), pg, ps in zip(batches, hashed, group, single):
        got += s._finish_batch(b, errors, pg, GROUP_THRESHOLD, num_results)
        alone += s._finish_batch(b, errors, ps, GROUP_THRESHOLD,
                                 num_results)
    assert [isinstance(r, QueryError) for r in got] == \
        [i in (2, 19) for i in range(K * GROUP_B)]
    assert _pairs(got) == _pairs(alone)
    valid = [r for i, r in enumerate(got) if i not in (2, 19)]
    assert _pairs(valid) == want[which, num_results][:len(valid)]


def test_mega_k_capped_binds_at_the_4_byte_budget(monkeypatch):
    """Full-ranking groups hold [K * B, slots] int32 scores: the cap is
    256 MB // (slots * 4 * B), never binding top-k; 1 for a streamed
    index or mega_batches = 1."""
    from cobs_tpu_torch import DeviceIndex
    from cobs_tpu_torch.query import search as search_mod

    def index(words, pages=1):
        m = np.zeros((pages * 2 + 1, words), dtype=np.uint32)
        return DeviceIndex.from_arrays(
            m, np.arange(pages) * 2, [2] * pages, words, term_size=31,
            canonicalize=1, num_hashes=1, page_size=words * 4,
            file_names=["d"], device="cpu")

    assert search_mod._MEGA_FULLRANK_BYTES == 256 << 20
    # 8,192 words: 262,144 slots, 64 MB per batch of 64 at 4 bytes a slot
    # (u16 would give 8)
    s = Search(index(8192))
    assert s._mega_k_capped(64, 0) == 4
    assert s._mega_k_capped(64, 5) == 16
    assert s._mega_k_capped(32, 0) == 8
    assert s._mega_k_capped(1024, 0) == 1
    # a federation sums its slot widths; phase 3's shape is not capped
    assert Search([index(4096), index(2048, pages=2)]) \
        ._mega_k_capped(64, 0) == 4
    assert Search(index(384))._mega_k_capped(64, 0) == 16
    monkeypatch.setattr(settings, "mega_batches", 2)
    assert s._mega_k_capped(64, 0) == 2
    monkeypatch.setattr(settings, "mega_batches", 1)
    assert s._mega_k_capped(64, 5) == 1
    monkeypatch.setattr(settings, "mega_batches", 16)
    streamed = Search(str(GOLDEN["classic"]), device="cpu", streamed=True)
    assert streamed._mega_k_capped(64, 5) == 1


@pytest.mark.parametrize("which", ["single", "federation"])
@pytest.mark.parametrize("num_results", [0, 3])
@pytest.mark.parametrize("batch_size", [2, 5])
def test_search_stream_mega_on_equals_off(group_case, corpus, monkeypatch,
                                          which, num_results, batch_size):
    """search_stream packs groups of batches when settings.mega_batches
    > 1 and yields exactly what one dispatch per batch yields."""
    queries = group_case[0]
    s = Search(corpus[which], device="cpu")
    groups = []
    group = s._dispatch_group_async
    monkeypatch.setattr(s, "_dispatch_group_async",
                        lambda g, n: groups.append(len(g)) or group(g, n))
    monkeypatch.setattr(settings, "mega_batches", 4)
    on = list(s.search_stream(queries, 0.1, num_results, batch_size))
    assert groups and max(groups) == 4
    monkeypatch.setattr(settings, "mega_batches", 1)
    groups.clear()
    off = list(s.search_stream(queries, 0.1, num_results, batch_size))
    assert groups and set(groups) == {1}
    assert [isinstance(r, QueryError) for r in on] == \
        [isinstance(r, QueryError) for r in off] == \
        [i in (2, 19) for i in range(len(queries))]
    assert _pairs(on) == _pairs(off)
