"""The port's `cobs` subtools info, doctor, print-parameters, print-kmers,
generate-queries and `query --profile` against cobs_tpu's, on the CPU
(the counterpart of tests/test_cli.py).

print-parameters, print-kmers, generate-queries and info print the same
bytes as cobs_tpu for the same arguments and seed; info differs only in
its page-size `hint:` line, which states the port's padding. doctor
probes a torch device in a child process and fails without CUDA unless
given `--device cpu`.
"""

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cobs_tpu
from cobs_tpu.cli import main as jax_cli
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch.cli import main as torch_cli
from cobs_tpu_torch.ops import _build
from cobs_tpu_torch.settings import settings

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = {"classic": DATA / "golden" / "fasta7.cobs_classic",
          "compact": DATA / "golden" / "fasta7.cobs_compact"}
GOLDEN_QUERY = "AGTCAACGCTAAGGCATTTCCCCCCTGCCTCCTGCCTGCTGCCAAGCCCT"
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _no_cache(monkeypatch):
    monkeypatch.setattr(jax_settings, "disable_cache", True)
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    monkeypatch.setattr(settings, "disable_cache", True)


def _both(capsys, argv):
    """(rc, stdout, stderr) of cobs_tpu's main, then of the port's, on
    the same arguments."""
    rc = jax_cli.main(list(argv))
    want = capsys.readouterr()
    got_rc = torch_cli.main(list(argv))
    got = capsys.readouterr()
    return (rc, want.out, want.err), (got_rc, got.out, got.err)


class _Parsed(Exception):
    pass


def _parser_of(fn, monkeypatch) -> argparse.ArgumentParser:
    """The parser a subtool builds, caught at its parse_args call."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            fn([])
    return seen[0]


def _flags(parser) -> set:
    return {s for a in parser._actions for s in a.option_strings} | {
        a.dest for a in parser._actions if not a.option_strings}


def test_all_subtools_with_cobs_tpus_flags(monkeypatch):
    """The port has cobs_tpu's 16 subtools, each with cobs_tpu's flags and
    positionals plus --device where it uses a device."""
    assert list(torch_cli.SUBTOOLS) == [
        n for n in jax_cli.SUBTOOLS if n in torch_cli.SUBTOOLS]
    assert set(torch_cli.SUBTOOLS) == set(jax_cli.SUBTOOLS)
    assert len(torch_cli.SUBTOOLS) == 16
    no_device = {"doc-list", "doc-dump", "classic-construct-random",
                 "compact-construct-combine", "repack", "info",
                 "print-parameters", "print-kmers", "generate-queries"}
    for name, (fn, _) in torch_cli.SUBTOOLS.items():
        want = _flags(_parser_of(jax_cli.SUBTOOLS[name][0], monkeypatch))
        got = _flags(_parser_of(fn, monkeypatch))
        extra = set() if name in no_device else {"--device"}
        assert got == want | extra, name


@pytest.mark.parametrize("args", [
    [],
    ["-h", "3", "-f", "0.1"],
    ["-n", "1M"],
    ["-n", "5000", "-h", "3", "-f", "0.1"],
    ["-n", "2G", "--num-hashes", "4", "--false-positive-rate", "0.05"],
    ["-n", "100k", "-h2", "2"],
    ["-n", "1.5Mi", "-f", "0.5"],
])
def test_print_parameters_matches_cobs_tpu(capsys, args):
    want, got = _both(capsys, ["print-parameters", *args])
    assert got == want and want[0] == 0 and want[1]


@pytest.mark.parametrize("query,k", [
    (GOLDEN_QUERY, 31),
    (GOLDEN_QUERY, 7),
    ("ACGTNACGTACGTTTGCA", 7),
    ("acgtACGTnnnACGTACGATCGATCGACTAGCTAGCTAGCATCGATCGATCGAT", 31),
    ("ACGTACGT", 7),    # one window: the reference prints none
    ("ACG", 7),
])
def test_print_kmers_matches_cobs_tpu(capsys, query, k):
    want, got = _both(capsys, ["print-kmers", query, "-k", str(k)])
    assert got == want and want[0] == 0


def _write_docs(root: Path, sizes, seed: int) -> None:
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i, n in enumerate(sizes):
        seq = BASES[rng.integers(0, 4, size=n)].tobytes()
        (root / f"d{i:02d}.fasta").write_bytes(b">s\n" + seq + b"\n")


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """The golden files, and two compact files of 1-byte pages built by
    cobs_tpu: three pages of one signature size (a uniform merge factor)
    and four pages in runs of 2, 1, 1 (no uniform factor)."""
    root = tmp_path_factory.mktemp("info")
    out = {"golden_" + k: v for k, v in GOLDEN.items()}
    old = jax_settings.disable_cache
    jax_settings.disable_cache = True
    try:
        for name, sizes in (("uniform", [300] * 24),
                            ("runs", [300] * 16 + [600] * 8 + [900] * 8)):
            _write_docs(root / name, sizes, seed=len(sizes))
            out[name] = root / f"{name}.cobs_compact"
            cobs_tpu.compact_construct(
                cobs_tpu.DocumentList(root / name), out[name],
                index_params=cobs_tpu.CompactIndexParameters(
                    page_size=1, clobber=True))
    finally:
        jax_settings.disable_cache = old
    return out


def _no_hint(out: str) -> list:
    return [line for line in out.splitlines()
            if not line.startswith("hint:")]


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("which", ["golden_classic", "golden_compact",
                                   "uniform", "runs"])
def test_info_matches_cobs_tpu(capsys, indexes, which, scan):
    argv = ["info", str(indexes[which])] + (["--scan"] if scan else [])
    want, got = _both(capsys, argv)
    assert got[0] == want[0] == 0 and got[2] == want[2]
    assert _no_hint(got[1]) == _no_hint(want[1])
    hints = [line for line in got[1].splitlines() if line.startswith("hint:")]
    if which == "golden_classic":
        assert hints == []
        return
    if which == "uniform":
        assert "mergeable       groups of 3 equal-size pages" in got[1]
    if which == "runs":
        assert "mergeable       3 equal-size RUNS (longest 2 pages)" \
            in got[1]
    page = 8 if which == "golden_compact" else 1
    assert hints == [f"hint: {page} B pages pad to 128 words (512 B) each "
                     "on the device at query time; a --page-size that is "
                     "a multiple of 512 needs no padding"]
    assert "TPU" not in got[1] and "faster" not in got[1]


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_info_truncated_payload_is_an_error(capsys, tmp_path, kind):
    """A payload shorter than its header says exits 1 with `corrupt`,
    as in cobs_tpu, never with wrong statistics; so does a file the
    scan finds short, and a path that is no index."""
    trunc = tmp_path / f"trunc.cobs_{kind}"
    shutil.copy(GOLDEN[kind], trunc)
    with open(trunc, "r+b") as f:
        f.truncate(trunc.stat().st_size - 50)
    want, got = _both(capsys, ["info", str(trunc), "--scan"])
    assert got[0] == want[0] == 1 and got[2] == want[2]
    assert _no_hint(got[1]) == _no_hint(want[1])
    assert f"ERROR: corrupt {kind} index" in got[2]
    # without --scan the header alone is read: exit 0, as in cobs_tpu
    want, got = _both(capsys, ["info", str(trunc)])
    assert got[0] == want[0] == 0
    assert _no_hint(got[1]) == _no_hint(want[1])
    with pytest.raises(torch_cli.FileIOError, match="truncated"):
        torch_cli._scan_ones(trunc, 0, trunc.stat().st_size + 1, 1)
    for path in (tmp_path / "nope.cobs_classic", DATA / "fasta"
                 / "sample1.fasta"):
        want, got = _both(capsys, ["info", str(path)])
        assert got[0] == want[0] == 1 and got[2].startswith("ERROR: ")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    for name in ("fasta", "fasta_multi", "text"):
        shutil.copytree(DATA / name, root / name,
                        ignore=shutil.ignore_patterns("*.cobs_cache"))
    return root


@pytest.mark.parametrize("corpus,args", [
    ("fasta", ["-p", "5", "-S", "7"]),
    ("fasta", ["-p", "5", "-k", "31", "-s", "31", "--seed", "7"]),
    ("fasta", ["-p", "20", "-n", "10", "-s", "60", "-S", "3"]),
    ("fasta", ["-p", "4", "-n", "6", "-N", "-s", "40", "-S", "1"]),
    ("fasta", ["-n", "5", "-N", "-k", "15", "-S", "2"]),
    ("fasta", ["-p", "300", "-k", "15", "-s", "100", "-S", "9"]),
    ("fasta_multi", ["-p", "12", "-n", "3", "-k", "15", "-S", "4"]),
    ("text", ["-p", "6", "-k", "8", "-s", "20", "-S", "5"]),
    ("fasta", ["-p", "100000"]),         # more than the corpus holds
    ("fasta", ["-n", "40", "-N", "-k", "4", "-S", "2"]),   # unlucky
])
def test_generate_queries_matches_cobs_tpu(capsys, corpora, tmp_path,
                                           corpus, args):
    """The same file for the same arguments and seed: the same positive
    term ids, padding draws, true-negative elimination and order."""
    argv = ["generate-queries", str(corpora / corpus), *args]
    try:
        want = jax_cli.main(argv), None
    except SystemExit as e:
        want = None, str(e)
    want_io = capsys.readouterr()
    try:
        got = torch_cli.main(argv), None
    except SystemExit as e:
        got = None, str(e)
    got_io = capsys.readouterr()
    assert got == want
    assert (got_io.out, got_io.err) == (want_io.out, want_io.err)
    if want[0] is None:
        return
    assert want_io.out.count(">") == (
        int(args[args.index("-p") + 1]) if "-p" in args else 0) + (
        int(args[args.index("-n") + 1]) if "-n" in args else 0)
    outs = []
    for cli in (jax_cli, torch_cli):
        out = tmp_path / f"{cli.__name__}.fa"
        assert cli.main([*argv, "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == want_io.out.encode()


def test_doctor_on_the_cpu(capsys):
    assert torch_cli.main(["doctor", "--device", "cpu", "--timeout",
                           "120"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith(f"torch {torch.__version__}  cuda ")
    assert out[2].startswith("DEVICE OK: 1x ") and "(cpu)" in out[2]
    assert out[3].startswith("NATIVE OK")
    assert out[4].startswith(("IO_URING OK", "IO_URING UNAVAILABLE"))
    assert out[5].startswith("KERNELS: nvcc ")
    assert out[6] == (f"settings: device={settings.device} "
                      f"threads={settings.threads} "
                      f"device_hash={settings.device_hash} "
                      f"streamed_score={settings.streamed_host_score} "
                      f"mega_batches={settings.mega_batches}")


def test_doctor_without_cuda_fails(tmp_path):
    """Plain `doctor` probes settings.device (cuda): without CUDA it
    reports DEVICE FAILED and exits 1, and never probes the CPU instead;
    so does plain `query`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert settings.device == "cuda"
    cmd = [sys.executable, "-m", "cobs_tpu_torch.cli.main"]
    proc = subprocess.run([*cmd, "doctor", "--timeout", "120"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "DEVICE FAILED: probe of cuda exited 1 (CUDA is not available" \
        in proc.stdout
    assert "DEVICE OK" not in proc.stdout
    prof = tmp_path / "prof"
    proc = subprocess.run([*cmd, "query", "-i", str(GOLDEN["classic"]),
                           "--profile", str(prof), GOLDEN_QUERY], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "ERROR:" in proc.stderr and not prof.exists()


def test_doctor_probe_timeout_is_unreachable(capsys, monkeypatch):
    def hung(cmd, **kwargs):
        raise subprocess.TimeoutExpired(cmd, kwargs["timeout"])

    monkeypatch.setattr(subprocess, "run", hung)
    assert torch_cli.main(["doctor", "--device", "cpu", "--timeout",
                           "3"]) == 1
    out = capsys.readouterr().out
    assert "DEVICE UNREACHABLE: init and first op on cpu did not return " \
        "within 3s" in out
    assert "NATIVE OK" in out


def test_doctor_counts_kernel_builds(capsys, monkeypatch, tmp_path):
    """The KERNELS line counts the sources whose build for their current
    source hash exists, and builds nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "/opt/cuda/bin/nvcc")
    for name in _build.SOURCES[:2]:
        _build._so_path(name).write_bytes(b"")
    (tmp_path / "libdevice_hash_stale.so").write_bytes(b"")
    assert torch_cli.main(["doctor", "--device", "cpu"]) == 0
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("KERNELS:")]
    assert line == [f"KERNELS: nvcc /opt/cuda/bin/nvcc; 2 of 4 sources "
                    f"built for their current source in {tmp_path} (built "
                    "at first use otherwise)"]
    assert len(list(tmp_path.iterdir())) == 3


@pytest.mark.parametrize("form", ["verbatim", "file"])
def test_query_profile_writes_a_trace(capsys, tmp_path, form):
    """`query --profile DIR` prints what cobs_tpu's query prints and what
    the port prints without it, and writes a chrome trace that parses."""
    qf = tmp_path / "q.fa"
    qf.write_text(f">first\n{GOLDEN_QUERY}\n>second one\n"
                  f"{GOLDEN_QUERY[3:]}\n{GOLDEN_QUERY[:20]}\n")
    args = (["-t", "0", GOLDEN_QUERY] if form == "verbatim"
            else ["-f", str(qf), "-t", "0.2", "-l", "3"])
    argv = ["query", "-i", str(GOLDEN["classic"]), "-i",
            str(GOLDEN["compact"]), *args]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert torch_cli.main([*argv, "--device", "cpu"]) == 0
    plain = capsys.readouterr().out
    trace_dir = tmp_path / "prof" / "deeper"
    assert torch_cli.main([*argv, "--device", "cpu", "--profile",
                           str(trace_dir)]) == 0
    got = capsys.readouterr().out
    assert got == plain == want and got
    trace = json.loads((trace_dir / torch_cli.PROFILE_TRACE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


@pytest.mark.parametrize("mesh", [[], ["--mesh", "1"]])
def test_query_profile_records_cuda_by_the_searchs_devices(
        monkeypatch, capsys, tmp_path, mesh):
    """`--profile` asks for CUDA activity exactly when the Search it
    built scores on a CUDA device: its indexes', or its mesh's."""
    seen = []

    def profiled(trace_dir, cuda):
        seen.append(cuda)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch_cli, "_profiled", profiled)
    assert torch_cli.main(["query", "-i", str(GOLDEN["classic"]), "-t", "0",
                           "--device", "cpu", *mesh, "--profile",
                           str(tmp_path), GOLDEN_QUERY]) == 0
    assert "sample1\t20" in capsys.readouterr().out
    assert seen == [False]
    from cobs_tpu_torch.parallel.sharded import Mesh
    from cobs_tpu_torch.query.search import Search

    assert Search(str(GOLDEN["classic"]),
                  device="cpu").device_types() == {"cpu"}
    cards = Mesh(((torch.device("cuda", 0), torch.device("cuda", 1)),))
    assert Search([], mesh=cards).device_types() == {"cuda"}


def test_console_main_exits_with_mains_code(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["cobs-torch", "print-kmers", "ACGTA",
                                      "-k", "3"])
    with pytest.raises(SystemExit) as e:
        torch_cli.console_main()
    assert e.value.code == 0
    assert capsys.readouterr().out == "ACG\nACG\n"
    monkeypatch.setattr(sys, "argv", ["cobs-torch", "info", "/nonexistent"])
    with pytest.raises(SystemExit) as e:
        torch_cli.console_main()
    assert e.value.code == 1
