"""Compact index file format (.cobs_compact): read and write, and page
coalescing arithmetic.

Byte-compatible with the reference (reference:
cobs/file/compact_index_header.{hpp,cpp}). Layout:

  COBS:COMPACT_INDEX <u32 version=1>
  <u32 term_size> <u8 canonicalize> <u32 #parameters> <u32 #file_names>
  <u64 page_size>
  (<u64 signature_size> <u64 num_hashes>) × #parameters
  file_name '\\n' × #file_names
  zero padding so that (pos + len("COMPACT_INDEX")) % page_size == 0
  COMPACT_INDEX
  payload: for each sub-index i: signature_size_i × page_size bytes

Documents are grouped into pages of 8*page_size documents; each page is its
own classic bit matrix with a Bloom size fitted to the page's largest
document (reference: cobs/construction/compact_index.cpp:171-340).
"""

import dataclasses
import io
import math
import struct
from pathlib import Path

import numpy as np

from cobs_tpu_torch.fmt import magic

MAGIC = b"COMPACT_INDEX"
VERSION = 1
FILE_EXTENSION = ".cobs_compact"


@dataclasses.dataclass
class CompactSubIndexParams:
    signature_size: int
    num_hashes: int


@dataclasses.dataclass
class CompactIndexHeader:
    term_size: int = 0
    canonicalize: int = 0
    page_size: int = 0
    parameters: list[CompactSubIndexParams] = dataclasses.field(
        default_factory=list)
    file_names: list[str] = dataclasses.field(default_factory=list)

    def padding_size(self, pos: int) -> int:
        return (self.page_size
                - ((pos + len(MAGIC)) % self.page_size)) % self.page_size

    def serialize(self, os_: io.BufferedIOBase) -> None:
        magic.write_magic_begin(os_, MAGIC, VERSION)
        os_.write(struct.pack("<IBIIQ", self.term_size, self.canonicalize,
                              len(self.parameters), len(self.file_names),
                              self.page_size))
        for p in self.parameters:
            os_.write(struct.pack("<QQ", p.signature_size, p.num_hashes))
        for name in self.file_names:
            os_.write(name.encode("utf-8", errors="surrogateescape") + b"\n")
        os_.write(b"\0" * self.padding_size(os_.tell()))
        magic.write_magic_end(os_, MAGIC)

    @classmethod
    def deserialize(cls, is_: io.BufferedIOBase) -> "CompactIndexHeader":
        magic.read_magic_begin(is_, MAGIC, VERSION)
        term_size, canonicalize, n_params, n_files, page_size = struct.unpack(
            "<IBIIQ", is_.read(4 + 1 + 4 + 4 + 8))
        params = []
        for _ in range(n_params):
            sig, nh = struct.unpack("<QQ", is_.read(16))
            params.append(CompactSubIndexParams(sig, nh))
        names = [magic.read_line(is_) for _ in range(n_files)]
        h = cls(term_size=term_size, canonicalize=canonicalize,
                page_size=page_size, parameters=params, file_names=names)
        is_.seek(h.padding_size(is_.tell()), io.SEEK_CUR)
        magic.read_magic_end(is_, MAGIC)
        return h


def read_compact_header(path) -> tuple[CompactIndexHeader, int]:
    """Return (header, payload_offset)."""
    with open(path, "rb") as f:
        h = CompactIndexHeader.deserialize(f)
        return h, f.tell()


def read_compact_index(path) -> tuple[CompactIndexHeader, list[np.ndarray]]:
    """Read header and per-page payload matrices
    uint8 [signature_size_i, page_size]."""
    with open(path, "rb") as f:
        h = CompactIndexHeader.deserialize(f)
        pages = []
        for p in h.parameters:
            size = p.signature_size * h.page_size
            raw = f.read(size)
            if len(raw) != size:
                raise magic.FileIOError("compact index payload truncated")
            pages.append(np.frombuffer(raw, dtype=np.uint8).reshape(
                p.signature_size, h.page_size))
    return h, pages


def write_compact_index(path, header: CompactIndexHeader,
                        pages: list[np.ndarray]) -> None:
    path = Path(path)
    if path.parent != Path(""):
        path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        header.serialize(f)
        for p, page in zip(header.parameters, pages):
            page = np.ascontiguousarray(page, dtype=np.uint8)
            if page.shape != (p.signature_size, header.page_size):
                raise ValueError(
                    f"page of shape {page.shape}, header says "
                    f"{(p.signature_size, header.page_size)}")
            page.tofile(f)


def is_compact_file(path) -> bool:
    return magic.file_has_header(path, MAGIC, VERSION)


def coalesce_factor(sig_sizes) -> int:
    """Largest m dividing the page count such that every group of m
    consecutive pages shares ONE signature size.

    Pages with equal Bloom sizes probe the same row per hash
    (row = hash % sig), so their matrices concatenate column-wise into
    one wider page bit-exactly: gathered bits, per-document scores,
    document numbering and the public counts_size are all unchanged
    (documents are laid out page-major in construction order,
    reference: cobs/construction/compact_index.cpp:171-340). Requiring
    m | page_count keeps every group full, which preserves the
    8*page_size*num_pages score layout. Uniform sizes give m = page count.
    """
    P = len(sig_sizes)
    m = P
    for i in range(1, P):
        if sig_sizes[i] != sig_sizes[i - 1]:
            m = math.gcd(m, i)
    return m


def coalesce_runs(sig_sizes) -> list[tuple[int, int]]:
    """Maximal runs of consecutive equal signature sizes:
    [(start, length), ...] covering every page in order.

    The run-length generalization of coalesce_factor for corpora whose
    size tiers straddle page boundaries: each equal-Bloom run still
    merges column-wise bit-exactly, and the merged pages span different
    numbers of original pages, which the query layer handles through
    per-page doc offsets (engine.DocLayout)."""
    runs = []
    i = 0
    P = len(sig_sizes)
    while i < P:
        j = i
        while j + 1 < P and sig_sizes[j + 1] == sig_sizes[i]:
            j += 1
        runs.append((i, j - i + 1))
        i = j + 1
    return runs
