"""The port's index and document file formats against cobs_tpu's, on the
CPU (the counterpart of tests/test_formats.py; reference: tests/file.cpp):
each header and payload written by the port is byte-identical to the one
cobs_tpu writes, reads back equal, and a bad magic word raises.
"""

import io

import numpy as np
import pytest

from cobs_tpu.core import kmer as jax_kmer
from cobs_tpu.fmt import classic as jax_classic
from cobs_tpu.fmt import compact as jax_compact
from cobs_tpu.fmt import kmer_buffer as jax_kmer_buffer
from cobs_tpu_torch.core import kmer as kmer_codec
from cobs_tpu_torch.fmt import classic, compact, kmer_buffer, magic
from cobs_tpu_torch.ingest.util import base_name


def test_classic_roundtrip(tmp_path, rng):
    h = classic.ClassicIndexHeader(
        term_size=31, canonicalize=1, signature_size=200, num_hashes=3,
        file_names=[f"file_{i}" for i in range(33)])
    assert h.row_size == 5
    data = rng.integers(0, 256, size=(200, 5), dtype=np.uint8)
    p, q = tmp_path / "t.cobs_classic", tmp_path / "jax.cobs_classic"
    classic.write_classic_index(p, h, data)
    jax_classic.write_classic_index(q, jax_classic.ClassicIndexHeader(
        **h.__dict__), data)
    assert p.read_bytes() == q.read_bytes()

    h2, data2 = classic.read_classic_index(q)
    assert h2 == h
    np.testing.assert_array_equal(data, data2)
    assert classic.is_classic_file(p)
    assert not compact.is_compact_file(p)


def test_compact_roundtrip(tmp_path, rng):
    page_size = 16
    params = [compact.CompactSubIndexParams(100, 2),
              compact.CompactSubIndexParams(317, 2)]
    h = compact.CompactIndexHeader(
        term_size=31, canonicalize=1, page_size=page_size,
        parameters=params,
        file_names=[f"doc_{i}" for i in range(2 * 8 * page_size)])
    pages = [rng.integers(0, 256, size=(p.signature_size, page_size),
                          dtype=np.uint8) for p in params]
    p, q = tmp_path / "t.cobs_compact", tmp_path / "jax.cobs_compact"
    compact.write_compact_index(p, h, pages)
    jax_compact.write_compact_index(q, jax_compact.CompactIndexHeader(
        term_size=31, canonicalize=1, page_size=page_size,
        parameters=[jax_compact.CompactSubIndexParams(x.signature_size,
                                                      x.num_hashes)
                    for x in params],
        file_names=h.file_names), pages)
    assert p.read_bytes() == q.read_bytes()

    h2, pages2 = compact.read_compact_index(q)
    assert h2 == h
    for a, b in zip(pages, pages2):
        np.testing.assert_array_equal(a, b)
    # the payload starts page-aligned (reference:
    # tests/compact_index_construction.cpp:39-58)
    buf = io.BytesIO(p.read_bytes())
    compact.CompactIndexHeader.deserialize(buf)
    assert buf.tell() % page_size == 0
    assert compact.read_compact_header(p)[1] == buf.tell()
    assert compact.is_compact_file(p) and not classic.is_classic_file(p)


def test_kmer_buffer_roundtrip(tmp_path, rng):
    packed = jax_kmer.random_packed(50, 31, rng)
    p, q = tmp_path / "t.cobs_doc", tmp_path / "jax.cobs_doc"
    kmer_buffer.write_kmer_buffer(p, "mydoc", 31, packed)
    jax_kmer_buffer.write_kmer_buffer(q, "mydoc", 31, packed)
    assert p.read_bytes() == q.read_bytes()
    h, packed2 = kmer_buffer.read_kmer_buffer(q)
    assert (h.name, h.kmer_size) == ("mydoc", 31)
    np.testing.assert_array_equal(packed, packed2)
    np.testing.assert_array_equal(kmer_codec.decode(packed2, 31),
                                  jax_kmer.decode(packed, 31))
    assert kmer_buffer.is_kmer_buffer_file(p)


@pytest.mark.parametrize("kind", ["classic", "compact", "kmer_buffer"])
def test_bad_magic(tmp_path, kind):
    p = tmp_path / f"bad.{kind}"
    p.write_bytes(b"NOT A COBS FILE")
    read, is_kind = {
        "classic": (classic.read_classic_index, classic.is_classic_file),
        "compact": (compact.read_compact_index, compact.is_compact_file),
        "kmer_buffer": (kmer_buffer.read_kmer_buffer,
                        kmer_buffer.is_kmer_buffer_file)}[kind]
    assert not is_kind(p)
    with pytest.raises(magic.FileIOError):
        read(p)


def test_base_name_strips_all_extensions():
    """reference: tests/file.cpp:21-24 + cobs/util/file.hpp:69-76"""
    assert base_name("data/out/file/classic_index.cobs_doc") == \
        "classic_index"
    assert base_name("/a/b/sample3.fasta.gz") == "sample3"
    assert base_name("plain") == "plain"


@pytest.mark.parametrize("page_size", [1, 8, 4096])
def test_compact_header_page_alignment_empty(page_size):
    """The payload starts page-aligned even with no pages or files
    (reference: tests/file.cpp:122-144)."""
    h = compact.CompactIndexHeader(term_size=31, canonicalize=1,
                                   page_size=page_size, parameters=[],
                                   file_names=[])
    buf, want = io.BytesIO(), io.BytesIO()
    h.serialize(buf)
    jax_compact.CompactIndexHeader(term_size=31, canonicalize=1,
                                   page_size=page_size, parameters=[],
                                   file_names=[]).serialize(want)
    assert buf.tell() % page_size == 0
    assert buf.getvalue() == want.getvalue()
