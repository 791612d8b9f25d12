"""cobs_tpu_torch device hashing in Search, `search_stream` and
`benchmark-fpr` against cobs_tpu, on the CPU.

With settings.device_hash "auto"/"device" the port hands Search's query
bytes to `ops.device_hash.rows_from_queries` (its plain version on CPU
tensors); "host" hashes with numpy. Both must rank exactly as cobs_tpu
does. The JAX targets are tests/test_device_hash.py:80-141,
tests/test_cli.py:103-113, tests/test_streamed.py:235-271 (device
backend) and tests/test_modes.py:78-89.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cobs_tpu
from cobs_tpu.cli.main import main as jax_main
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import QueryError, Search, settings
from cobs_tpu_torch.cli.main import main as torch_main
from cobs_tpu_torch.query import search as search_mod
from cobs_tpu_torch.query.engine import DeviceIndex, QueryBytes
from cobs_tpu_torch.settings import Settings

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "golden" / "fasta7.cobs_classic"
BASES = np.frombuffer(b"ACGT", np.uint8)
BAD = ["ACGT", "ACGTX" + "A" * 40, "AGTCAACGCTAANGGCATTTCCCCCCTGCCTCCTGCCTGCTG"]


@pytest.fixture(autouse=True)
def _settings():
    """Restore both packages' settings after every test; cobs_tpu
    hashes on the host (the same results as its device hashing, without
    its device-hash compiles on the CPU)."""
    old = (settings.device_hash, jax_settings.device_hash,
           jax_settings.disable_cache)
    jax_settings.device_hash = "host"
    jax_settings.disable_cache = True
    yield
    (settings.device_hash, jax_settings.device_hash,
     jax_settings.disable_cache) = old


def _pairs(results):
    return [None if isinstance(rl, QueryError)
            else [(r.doc_name, r.score) for r in rl] for rl in results]


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """classic h=1, classic h=3 and compact h=2 with page_size=1 (several
    pages, unequal signature sizes) over one 24-document corpus, and the
    corpus's sequences."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("stream")
    docs = root / "docs"
    docs.mkdir()
    seqs = []
    for i in range(24):
        seq = BASES[rng.integers(0, 4, 300 + 13 * i)].tobytes()
        seqs.append(seq)
        (docs / f"doc{i:03d}.fasta").write_bytes(b">s\n" + seq + b"\n")
    old = jax_settings.disable_cache
    jax_settings.disable_cache = True
    try:
        out = {}
        for name, typ, h in (("classic_h1", "classic", 1),
                             ("classic_h3", "classic", 3),
                             ("compact_h2", "compact", 2)):
            path = root / f"{name}.cobs_{typ}"
            dl = cobs_tpu.DocumentList(docs)
            if typ == "classic":
                cobs_tpu.classic_construct(
                    dl, path, index_params=cobs_tpu.ClassicIndexParameters(
                        num_hashes=h, clobber=True))
            else:
                cobs_tpu.compact_construct(
                    dl, path, index_params=cobs_tpu.CompactIndexParameters(
                        num_hashes=h, page_size=1, clobber=True))
            out[name] = str(path)
    finally:
        jax_settings.disable_cache = old
    qs = [BASES[rng.integers(0, 4, n)].tobytes().decode()
          for n in (31, 45, 80, 120)]
    qs += [seqs[i][j:j + n].decode() for i, j, n in
           ((0, 5, 60), (9, 0, 150), (17, 40, 31), (23, 100, 99))]
    return out, qs


@pytest.mark.parametrize("kind", ["classic_h1", "classic_h3", "compact_h2"])
@pytest.mark.parametrize("num_results", [0, 5])
def test_device_and_host_hashing_match_cobs_tpu(indexes, kind,
                                                num_results):
    paths, queries = indexes
    want = _pairs(cobs_tpu.Search(paths[kind]).search_batch(
        queries, 0.0, num_results))
    got = {}
    for mode in ("host", "device"):
        settings.device_hash = mode
        s = Search(paths[kind], device="cpu")
        hashed = s._hash_batch([q.encode() for q in queries])
        assert all(isinstance(h, QueryBytes) == (mode == "device")
                   for h in hashed)
        got[mode] = _pairs(s.search_batch(queries, 0.0, num_results))
    assert got["host"] == got["device"] == want


def _federation(indexes):
    paths, _ = indexes
    return [paths["classic_h1"], paths["compact_h2"]]


@pytest.mark.parametrize("which", ["single", "federation"])
@pytest.mark.parametrize("batch_size", [2, 4])
@pytest.mark.parametrize("num_results", [0, 3])
@pytest.mark.parametrize("mode", ["device", "host"])
def test_search_stream_matches_batch(indexes, which, batch_size,
                                     num_results, mode):
    """search_stream == search_batch query by query, with QueryError in
    the slots of invalid queries (too short, non-ACGT) and the rest
    ranked."""
    settings.device_hash = mode
    paths, queries = indexes
    target = (paths["classic_h3"] if which == "single"
              else _federation(indexes))
    s = Search(target, device="cpu")
    stream = queries[:3] + [BAD[0]] + queries[3:6] + BAD[1:] + queries[6:]
    got = list(s.search_stream(iter(stream), 0.2, num_results,
                               batch_size=batch_size))
    assert len(got) == len(stream)
    errors = [i for i, q in enumerate(stream) if q in BAD]
    for i in errors:
        assert isinstance(got[i], QueryError) and not got[i]
    assert "too short" in got[errors[0]].message
    assert "Invalid DNA" in got[errors[1]].message
    want = s.search_batch(queries, 0.2, num_results)
    assert [p for p in _pairs(got) if p is not None] == _pairs(want)
    jax_want = cobs_tpu.Search(target).search_batch(queries, 0.2,
                                                    num_results)
    assert _pairs(want) == _pairs(jax_want)


@pytest.mark.parametrize("mode,ahead", [("device", 2), ("host", 0)])
def test_search_stream_either_host_stage(indexes, monkeypatch, mode,
                                         ahead):
    """The host stage gives the same stream inline or on the worker
    thread, whichever hashing mode runs it."""
    settings.device_hash = mode
    monkeypatch.setitem(search_mod._HASH_AHEAD, mode, ahead)
    paths, queries = indexes
    s = Search(_federation(indexes), device="cpu")
    stream = queries[:5] + BAD + queries[5:]
    got = _pairs(s.search_stream(stream, 0.0, 4, batch_size=3))
    assert got[5:8] == [None] * 3
    assert got[:5] + got[8:] == _pairs(s.search_batch(queries, 0.0, 4))


def test_search_stream_uniform_batch_and_empty(indexes):
    """Queries of one length (the serving common case) stream like
    search_batch; an empty stream yields nothing."""
    paths, _ = indexes
    rng = np.random.default_rng(3)
    queries = [BASES[rng.integers(0, 4, 64)].tobytes().decode()
               for _ in range(7)]
    s = Search(paths["classic_h1"], device="cpu")
    got = list(s.search_stream(queries, 0.0, 0, batch_size=4))
    assert _pairs(got) == _pairs(s.search_batch(queries, 0.0, 0))
    assert list(s.search_stream([], 0.0, 0)) == []
    assert s.timer().get("hashes") > 0


def test_device_hash_errors_match_host(indexes):
    paths, _ = indexes
    for mode in ("device", "host"):
        settings.device_hash = mode
        s = Search(paths["classic_h1"], device="cpu")
        with pytest.raises(ValueError, match="Invalid DNA"):
            s.search_batch(["ACGTN" + "A" * 40])
        with pytest.raises(ValueError, match="too short"):
            s.search_batch(["ACGT"])


@pytest.mark.parametrize("value,device", [("auto", True), ("device", True),
                                          ("host", False)])
def test_device_hash_setting_reads_environment(monkeypatch, value, device):
    monkeypatch.setenv("COBS_TPU_DEVICE_HASH", value)
    assert Settings().device_hash == value
    settings.device_hash = value
    assert Search._use_device_hash(DeviceIndex.from_file(GOLDEN, "cpu")) \
        is device


def _result_keys(out: str) -> list[str]:
    line = next(ln for ln in out.splitlines()
                if ln.startswith("RESULT") and "name=benchmark " in ln)
    return re.findall(r"(\w+)=", line)


def test_benchmark_fpr_keys_match_cobs_tpu(capsys, monkeypatch):
    monkeypatch.setattr(jax_settings, "mega_batches", 1)
    args = ["benchmark-fpr", str(GOLDEN), "-q", "20", "-k", "40", "-w", "2",
            "-b", "8"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert torch_main(args + ["--device", "cpu", "-d"]) == 0
    got = capsys.readouterr().out
    assert _result_keys(got) == _result_keys(want)
    assert " backend=device " in got and " queries=20 " in got
    assert re.search(r"RESULT name=benchmark_fpr fpr=\d+ dist=\d+", got)


@pytest.mark.parametrize("flag", ["--streamed", "--cold"])
def test_benchmark_fpr_streamed_not_ported(capsys, flag):
    """--streamed and --cold run the streamed backend (once refused as
    not ported) and print cobs_tpu's RESULT keys with backend=streamed
    and how the cold run was kept cold."""
    args = ["benchmark-fpr", str(GOLDEN), "-q", "20", "-k", "40", "-w", "2",
            "-b", "8", flag]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    assert torch_main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _result_keys(got) == _result_keys(want)
    assert " backend=streamed " in got and " queries=20 " in got
    cold = re.search(r" cold=(\S+) ", got).group(1)
    assert cold == ("off" if flag == "--streamed"
                    else re.search(r" cold=(\S+) ", want).group(1))


def test_cuda_paths_raise_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        list(Search(str(GOLDEN), device="cuda").search_stream(["A" * 40]))
    assert settings.device == "cuda"
    assert torch_main(["benchmark-fpr", str(GOLDEN), "-q", "4"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "ERROR:" in captured.err
