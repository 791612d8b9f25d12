"""cobs_tpu_torch.native (the port's host C++ library) against
cobs_tpu.native and numpy oracles, on the CPU.

The port compiles its own copy of the construction hashing entry points,
the host bit scatter, the row gather, the host scorer and the io_uring
gather (cobs_tpu_torch/native/native.cpp) into cobs_tpu_torch/_build/.
Every output is an integer, so every comparison is exact. The JAX targets
are tests/test_native.py, tests/test_streaming_ingest.py:102-160 and
tests/test_streamed.py:135-174.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cobs_tpu import native as jax_native
from cobs_tpu_torch import native
from cobs_tpu_torch.ops.query_kernel import gather_and_count

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _score_oracle(payload, rows, zero_id):
    """numpy cobs_score_batch: per (b, t, p) AND the h rows and add each
    bit (LSB first) to its document slot; a term with any row == zero_id
    adds nothing."""
    B, T, h, P = rows.shape
    row_bytes = payload.shape[1]
    out = np.zeros((B, P * 8 * row_bytes), dtype=np.int32)
    for b in range(B):
        for t in range(T):
            for p in range(P):
                r = rows[b, t, :, p]
                if (r == zero_id).any():
                    continue
                w = payload[r[0]]
                for j in range(1, h):
                    w = w & payload[r[j]]
                out[b, p * 8 * row_bytes:(p + 1) * 8 * row_bytes] += \
                    np.unpackbits(w, bitorder="little")
    return out


def _k1_scores(payload, rows, zero_id):
    """The same counts from the gather-and-count kernel's plain version:
    the payload as an int32 [R + 1, W] matrix with a zero last row, and
    each page's first 8 * row_bytes slots of its W * 32."""
    R, row_bytes = payload.shape
    W = -(-row_bytes // 4)
    m = np.zeros((R + 1, W * 4), dtype=np.uint8)
    m[:R, :row_bytes] = payload
    ids = np.where(rows == zero_id, R, rows).astype(np.int32)
    got = gather_and_count(torch.from_numpy(m.view(np.int32)),
                           torch.from_numpy(ids), rows.shape[2]).numpy()
    B, P = rows.shape[0], rows.shape[3]
    return got.reshape(B, P, W * 32)[:, :, :8 * row_bytes].reshape(B, -1)


@pytest.mark.parametrize("row_bytes,T,h,P,B", [
    (3, 17, 1, 1, 5),      # tail-only rows (< 64 documents)
    (8, 255, 1, 1, 5),     # one SIMD word, exactly one 255-term chunk
    (13, 256, 2, 1, 5),    # word + tail, one term past a chunk
    (40, 600, 3, 1, 5),    # several words, several chunks, h > 1
    (9, 300, 1, 3, 5),     # several pages with padding terms
    (1250, 256, 1, 1, 2),  # the reference default row (10,000 documents)
    (1250, 600, 2, 2, 1),
])
def test_score_batch_host_matches_cobs_tpu_oracle_and_k1(row_bytes, T, h,
                                                         P, B):
    rng = np.random.default_rng(row_bytes * 1000 + T)
    sig = 211
    payload = rng.integers(0, 256, size=(sig, row_bytes), dtype=np.uint8)
    rows = rng.integers(0, sig, size=(B, T, h, P)).astype(np.int64)
    # whole padding terms and, for h > 1, single padding hashes
    rows = np.where(rng.random((B, T, 1, P)) < 0.05, sig, rows)
    if h > 1:
        rows = np.where(rng.random((B, T, h, P)) < 0.02, sig, rows)
    got = native.score_batch_host(payload, row_bytes, rows, sig, 2)
    want = _score_oracle(payload, rows, sig)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_native.score_batch_host(payload, row_bytes, rows, sig, 2))
    np.testing.assert_array_equal(got, _k1_scores(payload, rows, sig))


@pytest.mark.parametrize("row_bytes", [3, 8, 13, 40, 9, 1250])
@pytest.mark.parametrize("n,threads", [(17, 1), (3000, 4)])
def test_gather_rows_matches_cobs_tpu_and_numpy(row_bytes, n, threads):
    """n >= 1024 takes the threaded path; the stride past row_bytes is
    left as it was."""
    rng = np.random.default_rng(row_bytes + n)
    payload = rng.integers(0, 256, size=(4099, row_bytes), dtype=np.uint8)
    rows = rng.integers(0, 4099, size=n).astype(np.int64)
    stride = -(-row_bytes // 4) * 4 + 8
    got = np.full((n, stride), 0xA5, dtype=np.uint8)
    native.gather_rows(payload, row_bytes, rows, got, threads)
    want = got.copy()
    want[:, :row_bytes] = payload[rows]
    np.testing.assert_array_equal(got, want)
    ref = np.full((n, stride), 0xA5, dtype=np.uint8)
    assert jax_native.gather_rows(payload, row_bytes, rows, ref, threads)
    np.testing.assert_array_equal(got, ref)


def _payload_file(tmp_path, row_bytes, rows=4099, header=77):
    rng = np.random.default_rng(row_bytes)
    payload = rng.integers(0, 256, size=(rows, row_bytes), dtype=np.uint8)
    path = tmp_path / "payload.bin"
    path.write_bytes(b"h" * header + payload.tobytes())
    return path, header, payload


@pytest.mark.parametrize("row_bytes", [13, 1250])
@pytest.mark.parametrize("dontcache", [False, True])
def test_gather_rows_file_matches_cobs_tpu_and_numpy(tmp_path, row_bytes,
                                                     dontcache):
    path, off, payload = _payload_file(tmp_path, row_bytes)
    rng = np.random.default_rng(9)
    rows = rng.integers(0, payload.shape[0], size=300).astype(np.int64)
    got = np.zeros((300, row_bytes + 3), dtype=np.uint8)
    if not native.gather_rows_file(str(path), off, row_bytes, rows, got,
                                   dontcache=dontcache):
        pytest.skip("io_uring unavailable in this environment")
    np.testing.assert_array_equal(got[:, :row_bytes], payload[rows])
    assert not got[:, row_bytes:].any()
    ref = np.zeros_like(got)
    assert jax_native.gather_rows_file(str(path), off, row_bytes, rows, ref,
                                       dontcache=dontcache)
    np.testing.assert_array_equal(got, ref)
    assert native.uring_supported() is True
    if dontcache:
        # the probe ran, so support is a definite answer either way
        assert native.dontcache_supported() in (True, False)


def test_bad_arguments_raise(tmp_path):
    payload = np.zeros((10, 4), dtype=np.uint8)
    out = np.zeros((2, 4), dtype=np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.gather_rows(payload, 4, [3, 10], out, 1)
    with pytest.raises(ValueError, match="outside"):
        native.gather_rows(payload, 4, [-1, 0], out, 1)
    with pytest.raises(ValueError, match="out must be"):
        native.gather_rows(payload, 4, [1, 2, 3], out, 1)
    with pytest.raises(ValueError, match="base must be"):
        native.gather_rows(payload[:, :3], 4, [1, 2], out, 1)
    with pytest.raises(ValueError, match="outside"):
        native.score_batch_host(payload, 4, np.full((1, 2, 1, 1), 11), 10, 1)
    # the zero id may be the virtual row one past the payload
    assert not native.score_batch_host(payload, 4, np.full((1, 2, 1, 1), 10),
                                       10, 1).any()
    path, off, _ = _payload_file(tmp_path, 4, rows=10)
    with pytest.raises(ValueError, match="outside"):
        native.gather_rows_file(str(path), off, 4, [0, 10], out)


def test_build_lands_in_the_port_and_failure_raises(tmp_path, monkeypatch):
    native.lib()
    built = sorted((ROOT / "cobs_tpu_torch" / "_build")
                   .glob("libcobs_native_*.so"))
    assert any(p == native._so_path(native._SRC.read_bytes(), flags)
               for p in built for flags in native.FLAG_SETS)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "FLAG_SETS", (("-O3", "-fno-such-flag"),))
    with pytest.raises(RuntimeError, match="host library"):
        native._build()
    assert not list(tmp_path.iterdir())


def test_concurrent_builds_share_one_library(tmp_path):
    """Processes that build at once (the test workers) each write a
    temporary file and rename it into place: all of them load a whole
    library."""
    code = f"""
import numpy as np
from pathlib import Path
from cobs_tpu_torch import native
native.BUILD_DIR = Path({str(tmp_path)!r})
p = np.arange(64, dtype=np.uint8).reshape(8, 8)
out = native.score_batch_host(p, 8, np.array([[[[1]], [[8]]]]), 8, 1)
assert (out == np.unpackbits(p[1], bitorder="little")).all()
print("ok")
"""
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "ok"
    assert len(list(tmp_path.glob("*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))


def _dna(rng, n: int, invalid: bool = False) -> np.ndarray:
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    if invalid:
        seq[rng.integers(0, n, max(1, n // 500))] = ord("N")
    return seq


@pytest.fixture()
def jax_lib():
    """cobs_tpu's native library: its numpy fallback hashes differently
    in classic_construct_random, so a comparison needs the library."""
    assert jax_native.lib() is not None
    return jax_native


@pytest.mark.parametrize("k", [15, 31, 32, 33])
@pytest.mark.parametrize("num_hashes", [1, 3])
@pytest.mark.parametrize("canonical", [0, 1])
@pytest.mark.parametrize("n,threads", [(500, 1), ((1 << 16) + 123, 4)])
def test_window_rows_match_cobs_tpu(jax_lib, monkeypatch, k, num_hashes,
                                    canonical, n, threads):
    """Both routes of window_rows (a sliding-window view takes
    cobs_sequence_rows_mt, a contiguous copy cobs_window_rows_mt), on one
    thread and on four (n past the 2^16 threading floor), equal cobs_tpu's
    and each other."""
    from cobs_tpu.settings import settings as jax_settings
    from cobs_tpu_torch.ingest.util import sliding_windows

    monkeypatch.setattr(jax_settings, "threads", threads)
    rng = np.random.default_rng(k * 7 + num_hashes + canonical)
    seq = _dna(rng, n + k - 1, invalid=True)
    view = sliding_windows(seq, k)
    want, want_good = jax_lib.window_rows(view, num_hashes, 1000003,
                                          canonical)
    for windows in (view, np.ascontiguousarray(view)):
        got, good = native.window_rows(windows, num_hashes, 1000003,
                                       canonical, threads)
        np.testing.assert_array_equal(got, want)
        assert good == want_good
    assert native.window_rows(view[:, :k], num_hashes, 7, canonical)[0] \
        .max() < 7


def test_window_rows_all_good_flag():
    good_seq = np.frombuffer(b"ACGTTGCAACGT" * 5, np.uint8)
    from cobs_tpu_torch.ingest.util import sliding_windows

    assert native.window_rows(sliding_windows(good_seq, 31), 1, 99, 1)[1]
    bad = good_seq.copy()
    bad[40] = ord("N")
    assert not native.window_rows(sliding_windows(bad, 31), 1, 99, 1)[1]
    assert native.window_rows(np.empty((0, 31), np.uint8), 2, 99, 1)[0] \
        .shape == (0,)
    with pytest.raises(ValueError, match="canonicalize"):
        native.window_rows(sliding_windows(good_seq, 31), 1, 99, 2)


@pytest.mark.parametrize("canonical", [0, 1])
def test_window_hashes_and_xxh64_batch_match_cobs_tpu(jax_lib, canonical):
    rng = np.random.default_rng(11)
    windows = _dna(rng, 31 * 300, invalid=True).reshape(300, 31)
    got = native.window_hashes(windows, 3, canonical)
    want = jax_lib.window_hashes(windows, 3, canonical)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    lib = jax_lib.lib()
    for seed in (0, 1, 2**63 + 5):
        for length in (1, 7, 31, 64, 100):
            data = rng.integers(0, 256, (50, length), dtype=np.uint8)
            want = np.empty(50, dtype=np.uint64)
            lib.cobs_xxh64_batch(jax_lib._ptr8(data), 50, length, seed,
                                 jax_lib._ptr64(want))
            np.testing.assert_array_equal(native.xxh64_batch(data, seed),
                                          want)


@pytest.mark.parametrize("k", [1, 15, 31, 32])
def test_random_rows_match_cobs_tpu(jax_lib, k):
    for seed in (0, 12345, 2**62 + 3):
        np.testing.assert_array_equal(
            native.random_rows(seed, 1000, k, 2, 4099),
            jax_lib.random_rows(seed, 1000, k, 2, 4099))
    with pytest.raises(ValueError, match="k <= 32"):
        native.random_rows(0, 10, 33, 1, 99)


def test_set_bits_matches_cobs_tpu_and_numpy(jax_lib):
    rng = np.random.default_rng(3)
    sig, row_size = 257, 5
    got = np.zeros((sig, row_size), np.uint8)
    want = np.zeros_like(got)
    oracle = np.zeros_like(got)
    for doc in range(8 * row_size):
        rows = rng.integers(0, sig, 300).astype(np.uint64)
        native.set_bits(got, rows, doc)
        jax_lib.set_bits(want, rows, doc)
        oracle[rows.astype(np.int64), doc >> 3] |= np.uint8(1 << (doc & 7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    with pytest.raises(ValueError, match="row ids outside"):
        native.set_bits(got, np.array([sig], np.uint64), 0)
    with pytest.raises(ValueError, match="outside a row"):
        native.set_bits(got, np.array([0], np.uint64), 8 * row_size)
    with pytest.raises(ValueError, match="writeable"):
        native.set_bits(got[:, :2], np.array([0], np.uint64), 0)


#: document names a server must quote: quotes, backslashes, control
#: characters, non-ASCII letters and a character outside the BMP
FORMAT_NAMES = ['plain', 'with "quotes"', "back\\slash", "tab\there",
                "nl\nand\x00nul\x1f", "café", "日本語", "emoji \U0001F9EC",
                "", "x" * 300]


@pytest.mark.parametrize("n", [0, 1, 37])
def test_result_formatter_matches_cobs_tpu(n):
    """The port's ResultFormatter gives cobs_tpu's bytes, and JSON that
    loads to what json.dumps of the same pairs loads to; negative and
    large scores included."""
    import json

    rng = np.random.default_rng(n)
    names = FORMAT_NAMES * 3
    gidx = rng.integers(0, len(names), size=n)
    scores = rng.integers(-5, 1 << 40, size=n)
    if n:
        scores[0] = -(1 << 63)
    got = native.ResultFormatter(names)(gidx, scores)
    want = jax_native.ResultFormatter(names)(gidx, scores)
    assert want is not None and got == want
    pairs = [[names[g], int(s)] for g, s in zip(gidx, scores)]
    assert json.loads(got) == json.loads(json.dumps(pairs))


def test_result_formatter_rejects_unknown_documents():
    f = native.ResultFormatter(["a", "b"])
    assert f(np.array([1, 0]), np.array([3, 2])) == b'[["b",3],["a",2]]'
    with pytest.raises(ValueError, match="outside"):
        f(np.array([2]), np.array([1]))
    with pytest.raises(ValueError, match="scores"):
        f(np.array([0, 1]), np.array([1]))
