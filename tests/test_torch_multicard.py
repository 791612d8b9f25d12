"""The document-sharded index across several cards, on the CPU.

chip_smoke.py's phase 12 takes four distinct cards when four are visible
and cuda:0 four times otherwise; here `torch.cuda.device_count` is
monkeypatched to 1, 2 and 4 (a torch.device names a card without CUDA).
`cobs_tpu_torch/experiments/multicard_bench.py` runs at a tiny size on
`[cpu] * 4`: its index file is read by cobs_tpu's `Search` and the
port's, and the rankings are held equal, exactly (integer scores, tie
order included). A streamed shard is uploaded in row chunks through two
host buffers; it is held to the shard cut from the held matrix. Phase
14's out-of-core check takes its baseline once every page worker has
built a page.
"""


import numpy as np
import pytest
import torch

import chip_smoke
import cobs_tpu
from cobs_tpu.settings import settings as jax_settings
from cobs_tpu_torch import Search, settings
from cobs_tpu_torch.experiments import multicard_bench as mb
from cobs_tpu_torch.experiments.common import acgt_queries, pairs
from cobs_tpu_torch.parallel import sharded
from cobs_tpu_torch.parallel.sharded import ShardedIndex, make_mesh
from cobs_tpu_torch.query.engine import DeviceIndex, StreamedIndex

torch.set_num_threads(2)

CPU4 = [torch.device("cpu")] * 4


@pytest.mark.parametrize("count,line", [
    (1, "phase 12 mesh: 1 card x 4 shards"),
    (2, "phase 12 mesh: 1 card x 4 shards"),
    (4, "phase 12 mesh: 4 distinct cards")])
def test_phase12_cards_by_visible_count(monkeypatch, capsys, count, line):
    """Four distinct cards when four are visible, cuda:0 repeated
    otherwise; the phase prints which; each of the two processes takes
    two of them (cards 2r and 2r + 1 on four)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    cards = chip_smoke.announce_mesh(torch)
    assert capsys.readouterr().out.splitlines() == [line]
    if count >= 4:
        want = [torch.device("cuda", i) for i in range(4)]
    else:
        want = [torch.device("cuda", 0)] * 4
    assert cards == want
    assert [cards[2 * r:2 * r + 2] for r in range(2)] == [want[:2],
                                                          want[2:]]
    assert chip_smoke.mesh_cards(torch, 1) == [torch.device("cuda", 0)]


def test_cards_line_names_the_layout():
    dev = torch.device
    assert chip_smoke.cards_line([dev("cuda", i) for i in range(4)]) \
        == "4 distinct cards"
    assert chip_smoke.cards_line([dev("cuda", 0)] * 4) == \
        "1 card x 4 shards"
    assert chip_smoke.cards_line([dev("cuda", 0)] * 2) == \
        "1 card x 2 shards"


@pytest.fixture
def cpu_mesh_cli(monkeypatch):
    """`query --mesh 4 --device cpu` over [cpu] * 4 (a CPU has one
    device, so the CLI's mesh would otherwise raise), and a small device
    budget, so that the tiny file streams as the full one does."""
    monkeypatch.setattr(sharded, "visible_devices",
                        lambda device=None: list(CPU4))
    monkeypatch.setattr(settings, "max_device_index_bytes", 1 << 20)
    monkeypatch.setattr(jax_settings, "device_hash", "host")
    monkeypatch.setattr(jax_settings, "disable_cache", True)


def test_multicard_index_tiny_matches_cobs_tpu(tmp_path, cpu_mesh_cli):
    """The index part at 2,000 rows x 13,000 documents (every one of the
    four 128-word shards holds documents): `query --mesh 4` equals the
    one-device streamed search at top k and the mesh Search in full;
    then cobs_tpu reads the same file and ranks the same queries alike."""
    r = mb.run_index(torch, "cpu", 4, tmp_path, rows=2000, docs=13_000,
                     seed=3, queries=8, batch=4, k=5, full=4, passes=1,
                     keep=True)
    assert r["equal_top_k"] and r["equal_full"]
    assert r["rows"] == 2000 and r["file_bytes"] > 2000 * 1625
    assert r["devices"] == ["cpu"] * 4
    path = str(tmp_path / "multicard.cobs_classic")
    queries = acgt_queries(np.random.default_rng(4), 8, mb.QUERY_LEN)
    want = cobs_tpu.Search(path)
    got = Search(path, device="cpu")
    for k in (5, 0):
        w = pairs(want.search_batch(queries[:4], 0.0, k))
        assert pairs(got.search_batch(queries[:4], 0.0, k)) == w
        assert pairs(Search(path, mesh=make_mesh(1, 4, CPU4))
                      .search_batch(queries[:4], 0.0, k)) == w
    assert len(w[0]) == 13_000


def test_multicard_write_index_is_seeded(tmp_path):
    """The payload is the seed's: two writes are byte-identical, another
    seed differs; the header is ClassicIndexHeader's."""
    from cobs_tpu_torch.fmt.classic import read_classic_index

    sizes = [mb.write_index(torch, tmp_path / f"{i}.cobs_classic", 300,
                            100, seed, torch.device("cpu"))
             for i, seed in enumerate((5, 5, 6))]
    assert sizes[0] == sizes[1] == sizes[2]
    data = [(tmp_path / f"{i}.cobs_classic").read_bytes() for i in range(3)]
    assert data[0] == data[1] != data[2]
    h, payload = read_classic_index(tmp_path / "0.cobs_classic")
    assert (h.signature_size, h.row_size, h.term_size) == (300, 13, 31)
    assert 0.4 < np.unpackbits(payload).mean() < 0.6


def test_index_part_refuses_a_disk_without_room(tmp_path):
    """The df line and MemAvailable come back when the file fits with 5 %
    to spare; a file the disk cannot hold raises before any write. The
    default file is larger than one card's 80 GB."""
    import shutil

    free = shutil.disk_usage(tmp_path).free
    df, got_free, mem = mb.disk_and_memory(tmp_path, 1 << 20)
    assert df and got_free > 0 and mem > 0
    with pytest.raises(OSError):
        mb.disk_and_memory(tmp_path, free)
    assert not list(tmp_path.iterdir())
    assert mb.ROWS * ((mb.DOCS + 7) // 8) > 80e9


def test_multicard_processes_tiny_on_cpu(tmp_path):
    """Four processes (gloo, file store) build their slices, federate and
    score over the global mesh: equal to one process, every process
    exits 0."""
    r = mb.run_processes(torch, "cpu", 4, tmp_path / "proc",
                         corpus_docs=64, lengths=(1200, 3000), queries=8,
                         k=5, full=2)
    assert r["equal"] and r["rcs"] == [0] * 4
    assert [c["rank"] for c in r["ranks"]] == [0, 1, 2, 3]
    # one exchange per index of the federation per fetched batch: four
    # shards' indexes, two batches
    assert all(c["exchanges"] == 4 * 2 for c in r["ranks"])


def test_multicard_scaling_tiny_on_cpu():
    r = mb.run_scaling(torch, "cpu", 4, iters=2, docs_per_shard=(64,),
                       sig_size=1 << 8)
    runs = r["runs"]
    assert set(runs) == {"64 distinct", "64 one card"}
    for run in runs.values():
        assert set(run["per_n"]) == {1, 2, 4}
        assert run["copies_per_batch"] == {1: 0.0, 2: 0.0, 4: 0.0}


@pytest.mark.parametrize("stage_bytes", [4 * 128 * 7, 1 << 30])
def test_streamed_shards_upload_in_row_chunks(tmp_path, monkeypatch,
                                              stage_bytes):
    """A streamed shard goes through two host buffers of STAGE_BYTES of
    rows (7 rows of a 128-word shard here: many chunks and a ragged
    last one), and equals the shard cut from the held matrix, the last
    shard's padding columns and the zero row zero."""
    monkeypatch.setattr(sharded, "STAGE_BYTES", stage_bytes)
    path = tmp_path / "x.cobs_classic"
    mb.write_index(torch, path, 101, 9_000, 7, torch.device("cpu"))
    held = DeviceIndex.from_file(str(path), "cpu")
    streamed = StreamedIndex(str(path), "cpu")
    mesh = make_mesh(1, 4, CPU4)
    a, b = ShardedIndex(held, mesh), ShardedIndex(streamed, mesh)
    for d in range(4):
        assert torch.equal(a.shard(0, d), b.shard(0, d))
    # 9,000 documents: 1,125 B a row, 101 B of them in shard 2
    assert not b.shard(0, 0)[-1].any()
    assert not b.shard(0, 2)[:, 26:].any() and not b.shard(0, 3).any()


def _build_samples(step_at: int, step: int, pages: int = 98) -> list:
    """(seconds, RSS, pages written) every second, one page a second,
    10 GB resident with `step` more bytes from page `step_at` on."""
    return [(float(n), 10_000_000_000 + (step if n >= step_at else 0), n)
            for n in range(pages + 1)]


@pytest.mark.parametrize("threads,step_at,first,late", [
    # one card: 8 page workers, the baseline at a quarter of the pages
    (8, 20, 24, 0),
    (8, 30, 24, 535_000_000),
    # four cards' host: 32 page workers, whose buffers are in place
    # once each has built a page; growth after that still counts
    (32, 30, 32, 0),
    (32, 40, 32, 535_000_000),
    # more workers than half the pages: half the pages are still judged
    (64, 30, 49, 0),
    (64, 60, 49, 535_000_000)])
def test_paper_build_rss_baseline_follows_the_workers(threads, step_at,
                                                      first, late):
    """Phase 14's out-of-core check: a one-time RSS step while the page
    workers set up (a 32-worker build on one H100 grew 0.493 GB between
    a quarter and half of its 98 pages, then stayed flat) falls before
    the baseline; a step after it is late growth."""
    res = {"threads": threads, "base_rss": 9_000_000_000,
           "samples": _build_samples(step_at, 535_000_000),
           "steps": {"construct_s": 98.0}}
    got_first, settled, peak = chip_smoke.build_rss(res, 98)
    assert got_first == first
    assert peak - settled == late
    assert peak == 10_535_000_000
