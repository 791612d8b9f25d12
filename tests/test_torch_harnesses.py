"""The port's ports of cobs_tpu's measurement harnesses against cobs_tpu
on the CPU: bench_torch.py (bench.py), and cobs_tpu_torch/experiments'
runcap_serve_bench, batch_sweep, width_sweep, score_batch_bench,
mega_serve_bench and serve_bench (experiments/*.py). The tolerance is
exact throughout: counts, totals, scores and rankings are integers.

The runcap corpus is cut to small tiers here (5,632 documents; the
harness's default is 20,480) chosen so that the default compact page
(32 B, 256 documents) gives a dominant run of 17 equal-Bloom pages and
short tails: the run cap then splits the dominant run (merged pages
wider than 512 B pay), so the capped load is run-coalesced with runs of
unequal length, each merged page padded to the widest.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cobs_tpu
from cobs_tpu.native import score_batch_host as jax_score_batch_host
from cobs_tpu.query.engine import _gather_and_count as jax_gather_and_count
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import native
from cobs_tpu_torch.experiments import (
    batch_sweep,
    hot_loop,
    mega_serve_bench,
    runcap_serve_bench as rb,
    score_batch_bench,
    serve_bench,
    width_sweep,
)
from cobs_tpu_torch.query.search import Search
from cobs_tpu_torch.settings import settings

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "experiments"))
import bench_torch  # noqa: E402
import runcap_serve_bench as jax_rb  # noqa: E402  (cobs_tpu's harness)

torch.set_num_threads(2)

GOLDEN = ROOT / "tests" / "data" / "golden" / "fasta7.cobs_classic"
SMALL_TIERS = ((4352, 100), (512, 300), (512, 900), (256, 2000))


def pairs(results) -> list:
    return [[(r.doc_name, int(r.score)) for r in rl] for rl in results]


def jax_totals(matrix, ids, num_hashes: int) -> np.ndarray:
    """cobs_tpu's per-query totals of one batch of ids [B, T, h, P]."""
    m = jnp.asarray(matrix.numpy().view(np.uint32))
    return np.asarray(jax_gather_and_count(
        m, jnp.asarray(ids.numpy()), num_hashes).sum(axis=1))


@contextlib.contextmanager
def quiet():
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        yield


# ---- runcap_serve_bench -------------------------------------------------


def test_runcap_corpus_equals_cobs_tpus(tmp_path, monkeypatch):
    """The default tiers' 20,480 documents, byte for byte (cobs_tpu's
    listing and build stubbed: only the corpora are compared here)."""
    for name in ("compact_construct", "DocumentList"):
        monkeypatch.setattr(cobs_tpu, name, lambda *a, **k: None)
    rb.write_corpus(tmp_path / "port")
    jax_rb.build_corpus(tmp_path / "jax")
    a = sorted((tmp_path / "port" / "docs").iterdir())
    b = sorted((tmp_path / "jax" / "docs").iterdir())
    assert len(a) == sum(n for n, _ in rb.TIERS) == 20_480
    assert [p.name for p in a] == [p.name for p in b]
    assert all(x.read_bytes() == y.read_bytes() for x, y in zip(a, b))


@pytest.fixture(scope="module")
def runcap(tmp_path_factory):
    """(port's index, cobs_tpu's index) over one small-tier corpus: the
    port's build_corpus (the scatter's plain version), and
    cobs_tpu.compact_construct with the harness's parameters."""
    saved = [(s, s.threads, s.disable_cache)
             for s in (settings, jax_settings)]
    for s in (settings, jax_settings):
        s.threads, s.disable_cache = 2, True
    try:
        root = tmp_path_factory.mktemp("runcap")
        with quiet():
            mine = rb.build_corpus(root, SMALL_TIERS, device="cpu")
            theirs = root / "cobs_tpu.cobs_compact"
            cobs_tpu.compact_construct(
                cobs_tpu.DocumentList(root / "docs"), theirs,
                index_params=cobs_tpu.CompactIndexParameters(
                    num_hashes=1, clobber=True))
        return mine, theirs
    finally:
        for s, threads, cache in saved:
            s.threads, s.disable_cache = threads, cache


def test_runcap_index_equals_cobs_tpus(runcap):
    mine, theirs = runcap
    assert mine.read_bytes() == theirs.read_bytes()


def _runcap_queries(root: Path, n_random: int = 32) -> list[bytes]:
    """Random queries of 100 k-mers, then a document's sequence (up to
    130 bases) from each tier, so the top hits fall in pages of every
    run."""
    qs = rb.random_queries(n_random, 100)
    starts = np.cumsum([0] + [n for n, _ in SMALL_TIERS])
    rng = np.random.default_rng(3)
    for lo, hi in zip(starts[:-1], starts[1:]):
        for d in rng.integers(lo, hi, size=8):
            seq = (root / "docs" / f"d{d:05d}.fasta").read_bytes()
            qs.append(seq.split(b"\n")[1][:130])
    return qs


@pytest.mark.parametrize("variant", list(rb.VARIANTS))
def test_runcap_variant_matches_cobs_tpu(runcap, variant):
    """Layout (pages, word width, page_docs) and rankings (top 100 at
    threshold 0 and at the harness's 0.8, and the full ranking) of one
    variant's load equal cobs_tpu's Search under the same environment;
    the capped load is run-coalesced with runs of unequal length."""
    mine, theirs = runcap
    s = rb.load_variants(mine, "cpu")[variant]
    with rb._environ(rb.VARIANTS[variant]):
        js = cobs_tpu.Search(str(theirs))
    ix, jx = s.index_files[0], js.index_files[0]
    assert (ix.num_pages, ix.word_width) == (jx.num_pages, jx.word_width)
    if jx.page_docs is None:
        assert ix.page_docs is None
    else:
        assert list(ix.page_docs) == [int(d) for d in jx.page_docs]
    if variant == "capped":
        assert ix.page_docs is not None and len(set(ix.page_docs)) >= 2
        assert ix.num_pages != rb.load_variants(mine, "cpu")[
            "uncapped"].index_files[0].num_pages
    queries = _runcap_queries(mine.parent)
    assert len(queries) == 64
    for t, limit in ((0.0, 100), (rb.THRESHOLD, rb.LIMIT)):
        got = pairs(s.search_batch(queries, t, limit))
        assert got == pairs(js.search_batch(queries, t, limit))
    assert sum(bool(r) for r in got) >= 32   # every document query hits
    full = pairs(s.search_batch(queries[:2], 0.0, 0))
    assert [len(r) for r in full] == [len(ix.file_names)] * 2
    assert full == pairs(js.search_batch(queries[:2], 0.0, 0))


def test_runcap_serve_variants_rank_alike(runcap):
    """serve()'s passes and rep(keep=True): all three variants rank the
    document queries alike through search_stream, as search_batch does."""
    mine, _ = runcap
    searches = rb.load_variants(mine, "cpu")
    queries = _runcap_queries(mine.parent, 8)
    logs = []
    best = rb.serve(searches, queries, 16, 1, 16, log=logs.append)
    assert set(best) == set(rb.VARIANTS) and min(best.values()) > 0
    assert len(logs) == 6
    ranked = {name: pairs(rb.rep(s, queries, 16, keep=True)[1])
              for name, s in searches.items()}
    want = pairs(searches["plain"].search_batch(queries, rb.THRESHOLD,
                                                rb.LIMIT))
    assert all(r == want for r in ranked.values())
    line = rb.result_line("capped", 16, best["capped"])
    assert line.startswith("RESULT name=runcap_serve variant=capped B=16 ")


# ---- bench_torch, batch_sweep, width_sweep ------------------------------


@pytest.mark.parametrize("h", [1, 3])
def test_bench_torch_totals_match_cobs_tpu(h):
    """bench_torch's per-query totals (hot_loop.batch_totals) on fixed
    ids equal cobs_tpu's _gather_and_count(...).sum(axis=1)."""
    m = hot_loop.reference_matrix(torch, 1 << 12, 128, device="cpu")
    assert not m[-1].any()
    ids = hot_loop.random_ids(torch, np.random.default_rng(5), 2, 8, 128, h,
                              1 << 12, "cpu")
    got = hot_loop.run_totals(torch, m, ids, h)
    for k in range(2):
        assert np.array_equal(got[k].numpy(), jax_totals(m, ids[k], h))


def test_bench_torch_cpu_prints_result_line(capsys):
    assert bench_torch.main(["--device", "cpu"]) == 0
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "query_throughput"
    assert last["unit"] == "queries/s" and last["value"] > 0
    assert last["vs_baseline"] == 0.0
    assert "no device number" in out.err
    assert bench_torch.reference_qps(1000, 1, 10_000) == 40_000.0


def test_bench_torch_without_a_card_prints_no_number():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA card" in proc.stderr


@pytest.mark.parametrize("config", width_sweep.CPU_CONFIGS)
def test_width_sweep_totals_match_cobs_tpu(config):
    """Each tiny config's matrix and timed ids: K1's totals equal
    cobs_tpu's; the sweep's table has a row per config."""
    st = width_sweep.setups(torch, [config], width_sweep.CPU_B,
                            width_sweep.CPU_T, "cpu")[0]
    assert st["matrix"].shape == ((1 << config[0]) + 1, config[1])
    ids = st["run"].ids_s
    got = hot_loop.run_totals(torch, st["matrix"], ids, 1)
    for k in range(ids.shape[0]):
        assert np.array_equal(got[k].numpy(),
                              jax_totals(st["matrix"], ids[k], 1))
    rows = width_sweep.sweep(torch, [config], 1, width_sweep.CPU_B,
                             width_sweep.CPU_T, "cpu", log=lambda s: None)
    assert len(width_sweep.table(rows)) == 2
    assert rows[0]["docs"] == 32 * config[1] and rows[0]["gbps"] > 0


def test_batch_sweep_lines_and_totals(capsys):
    assert batch_sweep.main(["--device", "cpu", "4", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[:2] for line in lines] == [
        ["RESULT", "B=4"], ["RESULT", "B=8"]]
    sig, docs, T = batch_sweep.CPU_SHAPE
    W = hot_loop.words_for(docs)
    for line in lines:
        kv = dict(f.split("=") for f in line.split()[1:])
        qps = float(kv["queries_per_s"])
        # rows gathered: T rows of W words a query (printed to 0.1 GB/s)
        assert qps > 0
        assert abs(float(kv["gather_GBps"]) - qps * T * W * 4 / 1e9) <= 0.051
    m = hot_loop.reference_matrix(torch, sig, W, device="cpu")
    ids = hot_loop.random_ids(torch, np.random.default_rng(1), 1, 4, T, 1,
                              sig, "cpu")
    assert np.array_equal(hot_loop.run_totals(torch, m, ids, 1)[0].numpy(),
                          jax_totals(m, ids[0], 1))


# ---- score_batch_bench --------------------------------------------------


@pytest.mark.parametrize("h", [1, 2])
def test_score_batch_matches_cobs_tpu(h):
    payload, rows, zero_id, row_bytes = score_batch_bench.synthetic(
        B=4, T=50, docs=300, h=h, sig_log2=10)
    rows[0, :5] = zero_id      # padding terms
    out = np.zeros((4, 8 * row_bytes), dtype=np.int32)
    score_batch_bench.score(payload, rows, zero_id, row_bytes, out)
    want = jax_score_batch_host(payload, row_bytes, rows, zero_id, 4)
    assert want is not None and np.array_equal(out, want)
    assert np.array_equal(out, native.score_batch_host(
        payload, row_bytes, rows, zero_id, 2))


@pytest.mark.parametrize("file_backed", [0, 1])
def test_score_batch_bench_runs(capsys, file_backed):
    best = score_batch_bench.bench(4, 50, 300, 1, 0.3, 2, 10, file_backed)
    assert best > 0
    assert capsys.readouterr().out.startswith("B=4 T=50 docs=300 h=1: ")


# ---- mega_serve_bench ---------------------------------------------------


def test_mega_serve_bench_lines_and_results(capsys):
    assert mega_serve_bench.main(
        [str(GOLDEN), "--device", "cpu", "--queries", "48",
         "--num-kmers", "40", "--rounds", "1", "--configs",
         "16:1,16:2"]) == 0
    res = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("RESULT")]
    assert [line.split()[2:4] for line in res] == [
        ["B=16", "mega=1"], ["B=16", "mega=2"]]
    for line in res:
        kv = dict(f.split("=") for f in line.split()[1:])
        assert kv["threshold"] == "0.8" and kv["limit"] == "100"
        assert float(kv["queries_per_s"]) > 0
    s = Search(str(GOLDEN), device="cpu")
    queries = mega_serve_bench.random_queries(48, 40)
    want = pairs(s.search_batch(queries, 0.0, 3))
    for B, mega in mega_serve_bench.parse_configs("8:1,8:4,16:2"):
        got = mega_serve_bench.rep(s, settings, B, mega, queries, 0.0, 3,
                                   keep=True)[2]
        assert pairs(got) == want


@pytest.mark.parametrize("config", ["64:1:1", "64:1:1:4", "64:1:1:4:2",
                                    "64:1:1:4:2:1"])
def test_mega_serve_bench_refuses_tpu_knobs(config, capsys):
    with pytest.raises(ValueError, match="Port behaviour"):
        mega_serve_bench.parse_configs(config)
    with pytest.raises(SystemExit) as e:
        mega_serve_bench.main([str(GOLDEN), "--device", "cpu",
                               "--configs", "64:1," + config])
    assert e.value.code == 2 and "tier" in capsys.readouterr().err


# ---- serve_bench --------------------------------------------------------


def test_serve_bench_lines(capsys):
    assert serve_bench.main(
        [str(GOLDEN), "--device", "cpu", "--queries", "32", "--kmers",
         "40", "--batch", "8", "--clients", "2", "--pin-clients"]) == 0
    out = capsys.readouterr().out.splitlines()
    res = {line.split()[1]: dict(f.split("=", 1) for f in line.split()[1:])
           for line in out if line.startswith("RESULT")}
    assert set(res) == {"mode=direct", "mode=served", "mode=served_pinned"}
    served = res["mode=served"]
    for key in ("queries_per_s", "lat_p50_ms", "lat_p99_ms",
                "overhead_pct"):
        float(served[key])
    assert served["backend"] == "device" and served["clients"] == "2"
    assert sum(line.startswith("DIAG") for line in out) == 3


@pytest.mark.parametrize("fail", [False, True])
def test_serve_bench_leaves_no_process_running(monkeypatch, fail):
    """drive_served ends the client processes, the forkserver and the
    resource tracker that it starts, also when it fails with a client
    connected and waiting."""
    import gc

    import chip_smoke

    before = set(chip_smoke.live_children())
    if fail:
        real = serve_bench._collect

        def collect(out_q, procs, n, seconds=600.0):
            real(out_q, procs, n, seconds)
            raise RuntimeError("the parent failed")

        monkeypatch.setattr(serve_bench, "_collect", collect)
    s = Search(str(GOLDEN), device="cpu")
    queries = serve_bench.random_queries(8, 40)
    with quiet(), contextlib.ExitStack() as stack:
        if fail:
            stack.enter_context(pytest.raises(RuntimeError,
                                              match="the parent failed"))
        serve_bench.drive_served(s, queries, 0.0, 5, 8, 2, 1.0,
                                 queries[:4])
    gc.collect()
    assert set(chip_smoke.live_children()) <= before


def test_serve_bench_served_equals_search_batch():
    s = Search(str(GOLDEN), device="cpu")
    queries = serve_bench.random_queries(24, 40)
    with quiet():
        qps, p50, p99, got = serve_bench.drive_served(
            s, queries, 0.0, 5, 8, 3, 1.0, queries[:8], keep=True)
    assert qps > 0 and p50 is not None and p99 is not None
    assert got == pairs(s.search_batch(queries, 0.0, 5))
