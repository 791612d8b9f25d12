"""cobs_tpu_torch's index construction against cobs_tpu's, on the CPU.

The port builds with `device="cpu"`, so the bit scatter takes the CUDA
kernel's plain version (a u8 plane set by index_put_, then packed), or,
with `device_construct=False`, the native host scatter; cobs_tpu builds
with its host path (and, for the scatter itself, its jitted device path
on the JAX CPU backend). The tolerance is exact bytes throughout. The JAX
targets are tests/test_device_construct.py,
tests/test_construction_semantics.py and tests/test_cli.py.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cobs_tpu
import cobs_tpu_torch as ct
from cobs_tpu import native as jax_native
from cobs_tpu.cli.main import main as jax_main
from cobs_tpu.construct.device import \
    build_batch_matrix_device as jax_build_device
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch.cli.main import main as torch_main
from cobs_tpu_torch.construct.bitmatrix import build_batch_matrix
from cobs_tpu_torch.construct.device import build_batch_matrix_device
from cobs_tpu_torch.ops import construct_scatter as cs
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
GOLDEN = {"classic": DATA / "golden" / "fasta7.cobs_classic",
          "compact": DATA / "golden" / "fasta7.cobs_compact"}
#: the port's two scatters: the kernel's plain version on the CPU, and the
#: native host scatter
MODES = {"plain": dict(device_construct=True, device="cpu"),
         "host": dict(device_construct=False)}
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    """No cache files; both packages' settings come back after every
    test (the CLI's -T sets settings.threads)."""
    for s in (settings, jax_settings):
        monkeypatch.setattr(s, "disable_cache", True)
        monkeypatch.setattr(s, "threads", 2)
    monkeypatch.setattr(jax_settings, "construct_mesh", None)
    monkeypatch.setattr(settings, "construct_mesh", None)


def _corpus(tmp_path, n_docs=20, seed=0, equal_sizes=False) -> Path:
    """FASTA documents of random ACGT (a few N) from a seed; with
    equal_sizes, each 16 documents share one size."""
    docs = tmp_path / "docs"
    docs.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n_docs):
        n = 300 + 40 * (i // 16 if equal_sizes else i)
        seq = BASES[rng.integers(0, 4, n)].copy()
        if i % 5 == 1:
            seq[rng.integers(0, n)] = ord("N")
        lines = b"\n".join(seq[j:j + 70].tobytes() for j in range(0, n, 70))
        (docs / f"d{(i * 7) % n_docs:02d}.fasta").write_bytes(
            b">doc\n" + lines + b"\n")
    return docs


def _build_both(kind, docs, out: Path, mode: str, **kw):
    """(port's bytes, cobs_tpu's bytes) of one construction."""
    mine, theirs = out / f"mine.cobs_{kind}", out / f"theirs.cobs_{kind}"
    if kind == "classic":
        ct.classic_construct(ct.DocumentList(docs), mine, index_params=(
            ct.ClassicIndexParameters(**MODES[mode], **kw)))
        cobs_tpu.classic_construct(cobs_tpu.DocumentList(docs), theirs,
                                   index_params=(
            cobs_tpu.ClassicIndexParameters(**kw)))
    else:
        ct.compact_construct(ct.DocumentList(docs), mine, index_params=(
            ct.CompactIndexParameters(**MODES[mode], **kw)))
        cobs_tpu.compact_construct(cobs_tpu.DocumentList(docs), theirs,
                                   index_params=(
            cobs_tpu.CompactIndexParameters(**kw)))
    return mine.read_bytes(), theirs.read_bytes()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("canonicalize", [0, 1])
@pytest.mark.parametrize("num_hashes", [1, 2, 3])
@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_files_match_cobs_tpu(tmp_path, kind, num_hashes, canonicalize,
                              mode):
    """Classic, and compact with pages of unequal signature sizes
    (page_size 1 over 20 documents of growing size), byte for byte."""
    docs = _corpus(tmp_path)
    kw = dict(num_hashes=num_hashes, canonicalize=canonicalize)
    if kind == "compact":
        kw["page_size"] = 1
    mine, theirs = _build_both(kind, docs, tmp_path, mode, **kw)
    assert mine == theirs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_small_memory_batches_combine_and_threads(tmp_path, kind, mode,
                                                  monkeypatch):
    """A memory budget of a few rows makes many batch files and several
    combine levels; the file equals cobs_tpu's, and does not depend on
    the thread count (batches, octets and hashing threads)."""
    docs = _corpus(tmp_path, n_docs=40, equal_sizes=True)
    kw = dict(mem_bytes=64, num_hashes=2)
    if kind == "compact":
        kw["page_size"] = 2
    mine, theirs = _build_both(kind, docs, tmp_path, mode, **kw)
    assert mine == theirs
    for threads in (1, 5):
        monkeypatch.setattr(settings, "threads", threads)
        again = tmp_path / f"t{threads}.cobs_{kind}"
        build = (ct.classic_construct if kind == "classic"
                 else ct.compact_construct)
        P = (ct.ClassicIndexParameters if kind == "classic"
             else ct.CompactIndexParameters)
        build(ct.DocumentList(docs), again, index_params=P(
            **MODES[mode], **kw, num_threads=threads))
        assert again.read_bytes() == mine


def test_device_batches_follow_cobs_tpu_budget_rule(tmp_path, monkeypatch):
    """The device batch cap (half the device budget over sig + 1 bytes
    per document) cuts the same batch files as cobs_tpu's device build,
    kept with keep_temporary, and the final file does not depend on it."""
    docs = _corpus(tmp_path, n_docs=20)
    for s in (settings, jax_settings):
        monkeypatch.setattr(s, "max_device_index_bytes", 1 << 17)
    P, JP = ct.ClassicIndexParameters, cobs_tpu.ClassicIndexParameters
    ct.classic_construct(ct.DocumentList(docs), tmp_path / "m.cobs_classic",
                         index_params=P(**MODES["plain"],
                                        keep_temporary=True))
    cobs_tpu.classic_construct(
        cobs_tpu.DocumentList(docs), tmp_path / "t.cobs_classic",
        index_params=JP(device_construct=True, keep_temporary=True))
    mine = sorted(p.relative_to(tmp_path / "m.cobs_classic.tmp")
                  for p in (tmp_path / "m.cobs_classic.tmp").rglob("*.*"))
    theirs = sorted(p.relative_to(tmp_path / "t.cobs_classic.tmp")
                    for p in (tmp_path / "t.cobs_classic.tmp").rglob("*.*"))
    assert mine == theirs and len(mine) == 2
    for rel in mine:
        assert ((tmp_path / "m.cobs_classic.tmp" / rel).read_bytes()
                == (tmp_path / "t.cobs_classic.tmp" / rel).read_bytes())
    assert ((tmp_path / "m.cobs_classic").read_bytes()
            == (tmp_path / "t.cobs_classic").read_bytes()
            == _build_both("classic", docs, tmp_path, "host")[1])


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_clobber_continue_keep_temporary_match_cobs_tpu(tmp_path, kind):
    """Without --clobber an existing output raises in both packages;
    --keep-temporary leaves the same temporary tree; --continue over it
    gives the same file; --clobber rebuilds it."""
    docs = _corpus(tmp_path, n_docs=12)
    Ps = ((ct.ClassicIndexParameters, cobs_tpu.ClassicIndexParameters)
          if kind == "classic" else
          (ct.CompactIndexParameters, cobs_tpu.CompactIndexParameters))
    builds = ((ct.classic_construct, cobs_tpu.classic_construct)
              if kind == "classic" else
              (ct.compact_construct, cobs_tpu.compact_construct))
    extra = [MODES["plain"], {}]
    kw = dict(mem_bytes=64) if kind == "classic" else dict(page_size=1)
    outs = []
    for who, (P, build, ex, DL) in enumerate(zip(
            Ps, builds, extra, (ct.DocumentList, cobs_tpu.DocumentList))):
        out = tmp_path / f"{who}" / f"x.cobs_{kind}"
        out.parent.mkdir()
        build(DL(docs), out, index_params=P(**ex, **kw,
                                            keep_temporary=True))
        first = out.read_bytes()
        with pytest.raises(FileExistsError):
            build(DL(docs), out, index_params=P(**ex, **kw))
        tmp_files = sorted((p.relative_to(out.parent), p.read_bytes())
                           for p in out.parent.rglob("*.cobs_*")
                           if p.is_file() and p != out)
        assert tmp_files
        out.unlink()
        build(DL(docs), out, index_params=P(**ex, **kw, continue_=True,
                                            keep_temporary=True))
        assert out.read_bytes() == first
        build(DL(docs), out, index_params=P(**ex, **kw, clobber=True))
        assert out.read_bytes() == first
        assert not Path(str(out) + ".tmp").exists()
        outs.append((first, tmp_files))
    assert outs[0] == outs[1]


def test_plain_scatter_matches_cobs_tpu_device_build(tmp_path):
    """The device build's plain scatter on the CPU, in chunks of 1,000
    updates through a ring of one or three buffers, against cobs_tpu's
    build_batch_matrix_device (JAX on the CPU) and the host scatter."""
    docs = _corpus(tmp_path, n_docs=21)
    entries = ct.DocumentList(docs).list()
    jentries = cobs_tpu.DocumentList(docs).list()
    sig, row_size = 4099, -(-len(entries) // 8)
    want = jax_build_device(jentries, sig, row_size, 31, 2, 1,
                            lambda m: None)
    host = build_batch_matrix(entries, sig, row_size, 31, 2, 1,
                              lambda m: None)
    np.testing.assert_array_equal(host, want)
    timer = Timer()
    for chunk in (1000, 1 << 22):
        got = build_batch_matrix_device(entries, sig, row_size, 31, 2, 1,
                                        lambda m: None, device="cpu",
                                        chunk=chunk, timer=timer)
        assert got.dtype == np.uint8 and got.shape == (sig, row_size)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_batch,n_docs", [(1, 8), (2, 4)])
def test_batch_matrix_mesh_matches_cobs_tpu(tmp_path, monkeypatch, n_batch,
                                            n_docs):
    """tests/test_device_construct.py::test_batch_matrix_device_identical
    [8]: the build over the docs shards of a mesh of the CPU device
    against cobs_tpu's build over its 8-device mesh and the host scatter.
    Each shard gets every chunk (updates of other shards' documents
    included, which its scatter drops) as word-major int32 [Wl, sig + 1],
    with its documents shifted by its base."""
    from cobs_tpu.parallel.sharded import make_mesh as jax_make_mesh
    from cobs_tpu_torch.construct import device as dev_mod
    from cobs_tpu_torch.parallel.sharded import make_mesh

    docs = _corpus(tmp_path, n_docs=20)
    entries = ct.DocumentList(docs).list()
    jentries = cobs_tpu.DocumentList(docs).list()
    sig, row_size = 4099, -(-len(entries) // 8)
    want = jax_build_device(jentries, sig, row_size, 31, 2, 1,
                            lambda m: None, mesh=jax_make_mesh(1, 8))
    np.testing.assert_array_equal(
        want, build_batch_matrix(entries, sig, row_size, 31, 2, 1,
                                 lambda m: None))
    seen = []
    real = dev_mod.construct_scatter

    def spy(words, rows, docs_):
        seen.append((tuple(words.shape), int(docs_.min()),
                     int(docs_.max())))
        return real(words, rows, docs_)

    monkeypatch.setattr(dev_mod, "construct_scatter", spy)
    mesh = make_mesh(n_batch, n_docs, ["cpu"] * 8)
    for chunk in (1000, 1 << 22):
        seen.clear()
        got = build_batch_matrix_device(entries, sig, row_size, 31, 2, 1,
                                        lambda m: None, chunk=chunk,
                                        mesh=mesh)
        np.testing.assert_array_equal(got, want)
        Wl = -(-row_size * 8 // (32 * n_docs))
        assert {shape for shape, _, _ in seen} == {(Wl, sig + 1)}
        assert len(seen) % n_docs == 0
        # the last shards' chunks hold documents below their base
        assert min(lo for _, lo, _ in seen) < 0


@pytest.mark.parametrize("kind", ["classic", "compact"])
def test_construct_mesh_setting_identical_files(tmp_path, kind):
    """tests/test_device_construct.py::test_driver_device_construct_
    identical_files: with settings.construct_mesh a mesh of 8 shards, the
    classic and compact drivers write cobs_tpu's files (built over its
    own 8-device mesh) and the host scatter's, byte for byte; without it,
    the CPU builds on its one device."""
    from cobs_tpu.parallel.sharded import make_mesh as jax_make_mesh
    from cobs_tpu_torch.construct.classic import _construct_mesh
    from cobs_tpu_torch.parallel.sharded import make_mesh

    assert _construct_mesh("cpu") is None
    docs = _corpus(tmp_path, n_docs=24)
    jax_settings.construct_mesh = jax_make_mesh(1, 8)
    settings.construct_mesh = make_mesh(1, 8, ["cpu"] * 8)
    assert _construct_mesh("cpu") is settings.construct_mesh
    out = {}
    for who, how in (("jax", "device"), ("torch", "device"),
                     ("torch", "host")):
        path = tmp_path / f"{who}-{how}.cobs_{kind}"
        pkg = cobs_tpu if who == "jax" else ct
        P = (pkg.ClassicIndexParameters if kind == "classic"
             else pkg.CompactIndexParameters)
        extra = {} if kind == "classic" else {"page_size": 1}
        if who == "torch":
            extra.update(device="cpu")
        params = P(num_hashes=2, clobber=True,
                   device_construct=how == "device", **extra)
        build = (pkg.classic_construct if kind == "classic"
                 else pkg.compact_construct)
        build(pkg.DocumentList(docs), path, index_params=params)
        out[who, how] = path.read_bytes()
    assert out["torch", "device"] == out["jax", "device"] == \
        out["torch", "host"]


def test_device_build_workers_stress(tmp_path, monkeypatch):
    """Sixteen workers stage into one ring of chunks of 97 updates with a
    short switch interval: a lost or doubled update, or a buffer reused
    before its scatter, would change the bytes."""
    import sys

    docs = _corpus(tmp_path, n_docs=23)
    entries = ct.DocumentList(docs).list()
    sig, row_size = 1009, -(-len(entries) // 8)
    want = build_batch_matrix(entries, sig, row_size, 31, 3, 1,
                              lambda m: None)
    monkeypatch.setattr(settings, "threads", 16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = build_batch_matrix_device(entries, sig, row_size, 31, 3, 1,
                                        lambda m: None, device="cpu",
                                        chunk=97)
    finally:
        sys.setswitchinterval(old)
    np.testing.assert_array_equal(got, want)


def _oracle(R1, Wc, rows, docs):
    out = np.zeros((R1, 4 * Wc), dtype=np.uint8)
    for r, d in zip(rows.tolist(), docs.tolist()):
        if 0 <= r < R1 and 0 <= d < 32 * Wc:
            out[r, d >> 3] |= 1 << (d & 7)
    return out.view(np.int32)


@pytest.mark.parametrize("D", [1, 7, 8, 31, 33, 1000])
@pytest.mark.parametrize("case", ["random", "one_row", "edges", "empty",
                                  "dropped"])
def test_scatter_plain_version_edges(D, case):
    """construct_scatter on CPU tensors (the plain version) against a
    numpy oracle, ORed into word-major words [Wc, R1] that already hold
    bits: n = 0, every update to one row, rows 0 and R1 - 1, duplicates,
    and updates outside the matrix, which are dropped."""
    rng = np.random.default_rng(D)
    R1, Wc = 97, -(-D // 32)
    n = 0 if case == "empty" else 3000
    rows = rng.integers(0, R1, n)
    docs = rng.integers(0, D, n)
    if case == "one_row":
        rows[:] = 5
    elif case == "edges":   # rows 0 and R1 - 1, every update twice
        rows = np.where(rng.random(n) < 0.5, 0, R1 - 1)
        rows[1::2], docs[1::2] = rows[::2], docs[::2]
    elif case == "dropped":
        rows[::7] = R1 + rng.integers(0, 5, rows[::7].size)
        rows[1::7] = -1
        docs[2::7] = 32 * Wc + 3
        docs[3::7] = -2
    start = rng.integers(-2**31, 2**31, (R1, Wc)).astype(np.int32)
    words = torch.from_numpy(start.T.copy())
    out = cs.construct_scatter(words, torch.from_numpy(rows.astype(np.int32)),
                               torch.from_numpy(docs.astype(np.int32)))
    assert out is words
    np.testing.assert_array_equal(
        words.numpy().T, start | _oracle(R1, Wc, rows, docs))


@pytest.mark.parametrize("D", [1, 7, 8, 31, 33, 1000])
@pytest.mark.parametrize("case", ["random", "one_row", "edges", "empty",
                                  "dropped"])
def test_scatter_plain_version_matches_cobs_tpu(D, case):
    """The plain version's word-major words, transposed back to rows,
    equal cobs_tpu's `_scatter_single` + `_pack_plane` (JAX on the CPU)
    at the edge shapes. Out-of-range ids are past the end only: JAX's
    `.at[]` wraps negative ids before mode="drop" applies, which the port
    drops instead (construction never makes a negative id)."""
    import jax.numpy as jnp

    from cobs_tpu.construct.device import _pack_plane, _scatter_single

    rng = np.random.default_rng(100 + D)
    R1, Wc = 97, -(-D // 32)
    n = 0 if case == "empty" else 3000
    rows = rng.integers(0, R1, n).astype(np.int32)
    docs = rng.integers(0, D, n).astype(np.int32)
    if case == "one_row":
        rows[:] = R1 - 1
    elif case == "edges":
        rows = np.where(rng.random(n) < 0.5, 0, R1 - 1).astype(np.int32)
        rows[1::2], docs[1::2] = rows[::2], docs[::2]
    elif case == "dropped":
        rows[::7] = R1 + rng.integers(0, 5, rows[::7].size)
        docs[2::7] = 32 * Wc + 3
    plane = _scatter_single(jnp.zeros((R1, 32 * Wc), jnp.uint8),
                            jnp.asarray(rows), jnp.asarray(docs))
    want = np.asarray(_pack_plane(plane)).view(np.int32)
    words = torch.zeros((Wc, R1), dtype=torch.int32)
    cs.construct_scatter_reference(words, torch.from_numpy(rows),
                                   torch.from_numpy(docs))
    np.testing.assert_array_equal(words.numpy().T, want)


def test_scatter_chunk_across_two_strips():
    """One chunk with documents on both sides of a strip boundary (31 and
    32) and the last document of the last strip (32 Wc - 1) sets each bit
    in its own strip."""
    R1, Wc = 11, 3
    rows = torch.tensor([0, 5, 5, 10, 3], dtype=torch.int32)
    docs = torch.tensor([31, 32, 31, 95, 64], dtype=torch.int32)
    words = cs.construct_scatter(torch.zeros((Wc, R1), dtype=torch.int32),
                                 rows, docs)
    want = np.zeros((Wc, R1), dtype=np.uint32)
    for r, d in zip(rows.tolist(), docs.tolist()):
        want[d // 32, r] |= np.uint32(1 << (d % 32))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)


def test_device_build_scatters_word_major(tmp_path, monkeypatch):
    """The device build hands the scatter word-major words
    [ceil(docs / 32), signature_size + 1] and its fetch transposes them
    back: the bytes equal the host scatter's."""
    from cobs_tpu_torch.construct import device as dev_mod

    docs = _corpus(tmp_path, n_docs=40)
    entries = ct.DocumentList(docs).list()
    sig, row_size = 1009, -(-len(entries) // 8)
    shapes = []
    real = dev_mod.construct_scatter

    def spy(words, rows, docs_):
        shapes.append(tuple(words.shape))
        return real(words, rows, docs_)

    monkeypatch.setattr(dev_mod, "construct_scatter", spy)
    got = build_batch_matrix_device(entries, sig, row_size, 31, 2, 1,
                                    lambda m: None, device="cpu",
                                    chunk=5000)
    assert shapes and set(shapes) == {(2, sig + 1)}
    np.testing.assert_array_equal(
        got, build_batch_matrix(entries, sig, row_size, 31, 2, 1,
                                lambda m: None))


@pytest.mark.parametrize("n,R1,Wc,binned", [
    (0, 4099, 1, False), ((1 << 16) - 1, 2_803_591, 32, False),
    (1 << 16, 4099, 1, True), (1 << 22, 2_803_592, 32, True),
    (1 << 22, (1 << 24) + 1, 32, True), (1 << 22, 1 << 25, 2, True),
    (1 << 22, 1 << 25, 4, True), (1 << 22, (1 << 25) + 1, 4, False)])
def test_scatter_plan(n, R1, Wc, binned):
    """plan_scatter bins full chunks while the bins fit the kernel's
    histogram (slots x row blocks <= MAX_BINS), with every row in a row
    block and room for a quarter more than a bin's share of the chunk."""
    plan = cs.plan_scatter(n, R1, Wc)
    assert plan.binned == binned
    if binned:
        assert plan.slots == min(cs.MAX_SLOTS, Wc)
        assert plan.nblk * cs.ROW_BLOCK >= R1 > (plan.nblk - 1) * cs.ROW_BLOCK
        assert plan.slots * plan.nblk <= cs.MAX_BINS
        assert plan.cap * plan.nblk >= 1.25 * n and plan.cap % 4 == 0


def test_scatter_checks_its_arguments():
    w = torch.zeros((4, 2), dtype=torch.int32)
    r = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        cs.construct_scatter(w, r.long(), r)
    with pytest.raises(ValueError, match="want words"):
        cs.construct_scatter(w, r, r[:2])
    with pytest.raises(ValueError, match="contiguous"):
        cs.construct_scatter(w.t(), r, r)
    with pytest.raises(ValueError, match="no construct_scatter kernel"):
        cs.construct_scatter(w.to("meta"), r.to("meta"), r.to("meta"))
    assert cs.LAUNCHES == 0


def test_failed_nvcc_build_raises(tmp_path, monkeypatch):
    """No nvcc, or an nvcc that fails: the kernel's build raises; nothing
    falls back to the plain version."""
    from cobs_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    if not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load("construct_scatter")
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="nvcc failed on "
                                           "construct_scatter.cu"):
        _build.load("construct_scatter")
    assert not list((tmp_path / "build").glob("*.so"))


def test_pack_plane_matches_cobs_tpu():
    from cobs_tpu.construct.device import _pack_plane

    rng = np.random.default_rng(2)
    plane = (rng.random((9, 96)) < 0.3).astype(np.uint8)
    want = np.asarray(_pack_plane(plane)).view(np.int32)
    np.testing.assert_array_equal(
        cs.pack_plane(torch.from_numpy(plane)).numpy(), want)


def test_classic_construct_random_matches_cobs_tpu(tmp_path, monkeypatch):
    """The same bytes as cobs_tpu with its native library (its numpy
    fallback draws another stream), on any thread count."""
    assert jax_native.lib() is not None
    cobs_tpu.classic_construct_random(tmp_path / "t.cobs_classic", 4099, 21,
                                      500, 2, seed=7)
    for threads in (1, 3):
        monkeypatch.setattr(settings, "threads", threads)
        ct.classic_construct_random(tmp_path / "m.cobs_classic", 4099, 21,
                                    500, 2, seed=7)
        assert ((tmp_path / "m.cobs_classic").read_bytes()
                == (tmp_path / "t.cobs_classic").read_bytes())


def test_repack_and_combine_match_cobs_tpu(tmp_path):
    """compact_repack merges equal-size pages and
    compact_combine_into_compact assembles classic sub-indices exactly as
    cobs_tpu does."""
    docs = _corpus(tmp_path, n_docs=32, equal_sizes=True)
    src = tmp_path / "src.cobs_compact"
    ct.compact_construct(ct.DocumentList(docs), src, index_params=(
        ct.CompactIndexParameters(**MODES["plain"], page_size=1)))
    for page_size in (0, 2):
        a, b = tmp_path / f"a{page_size}.cobs_compact", \
            tmp_path / f"b{page_size}.cobs_compact"
        assert (ct.compact_repack(src, a, page_size=page_size)
                == cobs_tpu.compact_repack(src, b, page_size=page_size))
        assert a.read_bytes() == b.read_bytes()
    with pytest.raises(FileExistsError):
        ct.compact_repack(src, a)
    with pytest.raises(ValueError, match="differ from input"):
        ct.compact_repack(src, src, clobber=True)
    # classic sub-indices of one byte per row, combined
    parts = tmp_path / "parts"
    entries = ct.DocumentList(docs).list()
    for i in range(0, 32, 8):
        ct.classic_construct_from_documents(
            ct.DocumentList(entries=entries[i:i + 8]), parts / f"{i:02d}",
            ct.ClassicIndexParameters(**MODES["plain"],
                                      signature_size=1000 + 10 * i))
    for who, combine in (("m", ct.compact_combine_into_compact),
                         ("t", cobs_tpu.compact_combine_into_compact)):
        copy = tmp_path / f"parts_{who}"
        shutil.copytree(parts, copy)
        combine(copy, tmp_path / f"{who}.cobs_compact", page_size=1)
    assert ((tmp_path / "m.cobs_compact").read_bytes()
            == (tmp_path / "t.cobs_compact").read_bytes())


def _cli(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


def test_cli_subcommands_match_cobs_tpu(tmp_path, capsys):
    """Each new subcommand's standard output and files against cobs_tpu's
    CLI on the same inputs."""
    fasta = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", fasta,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    for argv in (["doc-list", str(fasta)],
                 ["doc-list", str(DATA / "fastq"), "-k", "15"],
                 ["doc-dump", str(fasta / "sample1.fasta")],
                 ["doc-dump", str(fasta / "sample2.fasta"), "-k", "21",
                  "--no-canonicalize"]):
        assert _cli(torch_main, argv, capsys) == _cli(jax_main, argv, capsys)
    for cmd, ext, extra in (
            ("classic-construct", "classic", ["-h", "2", "-m", "100"]),
            ("compact-construct", "compact", ["-p", "1", "-k", "21"]),
            ("classic-construct", "classic", ["--no-canonicalize", "-T",
                                              "3", "--device-construct"])):
        mine, theirs = (tmp_path / f"{w}.cobs_{ext}" for w in "mt")
        _cli(torch_main, [cmd, str(fasta), str(mine), *extra, "--device",
                          "cpu"], capsys)
        _cli(jax_main, [cmd, str(fasta), str(theirs), *extra], capsys)
        assert mine.read_bytes() == theirs.read_bytes()
        mine.unlink()
        theirs.unlink()
    assert settings.threads == 3   # -T, restored by the fixture
    rand = ["-s", "4099", "-n", "17", "-m", "300", "-h", "2", "--seed", "5"]
    _cli(torch_main, ["classic-construct-random", str(tmp_path / "r.m"),
                      *rand], capsys)
    _cli(jax_main, ["classic-construct-random", str(tmp_path / "r.t"),
                    *rand], capsys)
    assert (tmp_path / "r.m").read_bytes() == (tmp_path / "r.t").read_bytes()
    src = tmp_path / "src.cobs_compact"
    docs = _corpus(tmp_path, n_docs=32, equal_sizes=True)
    _cli(torch_main, ["compact-construct", str(docs), str(src), "-p", "1",
                      "--device", "cpu"], capsys)
    args = [str(src), "-p", "2"]
    assert (_cli(torch_main, ["repack", *args, str(tmp_path / "p.m")],
                 capsys)
            == _cli(jax_main, ["repack", *args, str(tmp_path / "p.t")],
                    capsys))
    assert (tmp_path / "p.m").read_bytes() == (tmp_path / "p.t").read_bytes()
    parts = tmp_path / "parts"
    _cli(torch_main, ["compact-construct", str(docs), str(tmp_path / "k"
                      ".cobs_compact"), "-p", "1", "--keep-temporary",
                      "--tmp-path", str(parts), "--device", "cpu"], capsys)
    level = max(p for p in parts.iterdir() if p.is_dir())
    for who, main in (("m", torch_main), ("t", jax_main)):
        shutil.copytree(level, tmp_path / f"level_{who}")
        _cli(main, ["compact-construct-combine", str(tmp_path / f"level_"
                    f"{who}"), str(tmp_path / f"c.{who}"), "-p", "1"],
             capsys)
    assert (tmp_path / "c.m").read_bytes() == (tmp_path / "c.t").read_bytes()
    assert (tmp_path / "c.m").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("mode", MODES)
def test_golden_files_rebuilt_by_the_port(tmp_path, capsys, mode):
    """tests/data/golden/* (built by cobs_tpu from tests/data/fasta
    without cache files) come out of the port byte for byte."""
    fasta = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", fasta,
                    ignore=shutil.ignore_patterns("*.cobs_cache"))
    for kind, build, P in (
            ("classic", ct.classic_construct, ct.ClassicIndexParameters),
            ("compact", ct.compact_construct, ct.CompactIndexParameters)):
        out = tmp_path / f"x.cobs_{kind}"
        build(ct.DocumentList(fasta), out, index_params=P(**MODES[mode]))
        assert out.read_bytes() == GOLDEN[kind].read_bytes()
    assert not list(fasta.glob("*.cobs_cache"))


def test_construction_without_cuda_raises(tmp_path, capsys):
    """The default device is cuda: without it the construction entry
    points raise before they write anything; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    docs = _corpus(tmp_path, n_docs=3)
    assert settings.device == "cuda"
    for build, P, ext in (
            (ct.classic_construct, ct.ClassicIndexParameters, "classic"),
            (ct.compact_construct, ct.CompactIndexParameters, "compact")):
        out = tmp_path / f"x.cobs_{ext}"
        with pytest.raises(RuntimeError, match="CUDA"):
            build(ct.DocumentList(docs), out, index_params=P())
        assert not out.exists() and not Path(str(out) + ".tmp").exists()
        assert torch_main([f"{ext}-construct", str(docs), str(out)]) == 1
        captured = capsys.readouterr()
        assert "ERROR:" in captured.err and "CUDA" in captured.err
        assert not out.exists()
