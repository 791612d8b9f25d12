"""Classic index file format (.cobs_classic): read and write.

Byte-compatible with the reference (reference:
cobs/file/classic_index_header.{hpp,cpp}). Layout:

  COBS:CLASSIC_INDEX <u32 version=1>
  <u32 term_size> <u8 canonicalize> <u32 #file_names>
  <u64 signature_size> <u64 num_hashes>
  file_name '\\n'  (× #file_names)
  CLASSIC_INDEX
  payload: signature_size rows × row_size bytes, row-major;
           row_size = ceil(#docs / 8); bit d of byte b of a row is
           document 8*b + d (LSB first, reference:
           cobs/construction/classic_index.cpp:40-43)

The payload bytes viewed little-endian as 32-bit words give document
index == word * 32 + bit, so no bit shuffling is needed between disk and
the device matrix.
"""

import dataclasses
import io
import struct
from pathlib import Path

import numpy as np

from cobs_tpu_torch.fmt import magic

MAGIC = b"CLASSIC_INDEX"
VERSION = 1
FILE_EXTENSION = ".cobs_classic"


@dataclasses.dataclass
class ClassicIndexHeader:
    term_size: int = 0
    canonicalize: int = 0
    signature_size: int = 0
    num_hashes: int = 0
    file_names: list[str] = dataclasses.field(default_factory=list)

    @property
    def row_bits(self) -> int:
        return len(self.file_names)

    @property
    def row_size(self) -> int:
        return (len(self.file_names) + 7) // 8

    def serialize(self, os_: io.BufferedIOBase) -> None:
        magic.write_magic_begin(os_, MAGIC, VERSION)
        os_.write(struct.pack("<IBIQQ", self.term_size, self.canonicalize,
                              len(self.file_names), self.signature_size,
                              self.num_hashes))
        for name in self.file_names:
            os_.write(name.encode("utf-8", errors="surrogateescape") + b"\n")
        magic.write_magic_end(os_, MAGIC)

    @classmethod
    def deserialize(cls, is_: io.BufferedIOBase) -> "ClassicIndexHeader":
        magic.read_magic_begin(is_, MAGIC, VERSION)
        term_size, canonicalize, n_files, sig, num_hashes = struct.unpack(
            "<IBIQQ", is_.read(4 + 1 + 4 + 8 + 8))
        names = [magic.read_line(is_) for _ in range(n_files)]
        magic.read_magic_end(is_, MAGIC)
        return cls(term_size=term_size, canonicalize=canonicalize,
                   signature_size=sig, num_hashes=num_hashes,
                   file_names=names)


def write_classic_index(path, header: ClassicIndexHeader,
                        data: np.ndarray) -> None:
    """Write header + payload. data: uint8 [signature_size, row_size] or
    flat bytes."""
    path = Path(path)
    if path.parent != Path(""):
        path.parent.mkdir(parents=True, exist_ok=True)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    with open(path, "wb") as f:
        header.serialize(f)
        data.tofile(f)  # no second in-memory copy of a large payload


def read_classic_header(path) -> ClassicIndexHeader:
    with open(path, "rb") as f:
        return ClassicIndexHeader.deserialize(f)


def read_classic_index(path) -> tuple[ClassicIndexHeader, np.ndarray]:
    """Read header and payload matrix uint8 [signature_size, row_size]."""
    with open(path, "rb") as f:
        h = ClassicIndexHeader.deserialize(f)
        payload = f.read()
    data = np.frombuffer(payload, dtype=np.uint8)
    if h.signature_size * h.row_size != data.size:
        raise magic.FileIOError(
            f"classic index payload size mismatch: expected "
            f"{h.signature_size}x{h.row_size}, got {data.size}")
    return h, data.reshape(h.signature_size, h.row_size)


def is_classic_file(path) -> bool:
    return magic.file_has_header(path, MAGIC, VERSION)
