"""KMerBuffer document format (.cobs_doc).

Byte-compatible with the reference (reference:
cobs/file/kmer_buffer_header.{hpp,cpp}, cobs/kmer_buffer.hpp):

  COBS:DOCUMENT <u32 version=1> <u32 kmer_size> name '\\0' DOCUMENT
  payload: packed k-mers, (kmer_size+3)/4 bytes each (core/kmer.py layout)
"""

import dataclasses
import io
import struct
from pathlib import Path

import numpy as np

from cobs_tpu_torch.core import kmer as kmer_codec
from cobs_tpu_torch.fmt import magic

MAGIC = b"DOCUMENT"
VERSION = 1
FILE_EXTENSION = ".cobs_doc"


@dataclasses.dataclass
class KMerBufferHeader:
    name: str = ""
    kmer_size: int = 0

    def serialize(self, os_: io.BufferedIOBase) -> None:
        magic.write_magic_begin(os_, MAGIC, VERSION)
        os_.write(struct.pack("<I", self.kmer_size))
        os_.write(self.name.encode("utf-8", errors="surrogateescape") + b"\0")
        magic.write_magic_end(os_, MAGIC)

    @classmethod
    def deserialize(cls, is_: io.BufferedIOBase) -> "KMerBufferHeader":
        magic.read_magic_begin(is_, MAGIC, VERSION)
        kmer_size = struct.unpack("<I", is_.read(4))[0]
        name = magic.read_cstring(is_)
        magic.read_magic_end(is_, MAGIC)
        return cls(name=name, kmer_size=kmer_size)


def write_kmer_buffer(path, name: str, kmer_size: int,
                      packed: np.ndarray) -> None:
    """packed: uint8 [n, (kmer_size+3)//4]."""
    path = Path(path)
    if path.parent != Path(""):
        path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        KMerBufferHeader(name=name, kmer_size=kmer_size).serialize(f)
        np.ascontiguousarray(packed, dtype=np.uint8).tofile(f)


def read_kmer_buffer(path) -> tuple[KMerBufferHeader, np.ndarray]:
    """Return (header, packed uint8 [n, P])."""
    with open(path, "rb") as f:
        h = KMerBufferHeader.deserialize(f)
        payload = f.read()
    P = kmer_codec.packed_size(h.kmer_size)
    data = np.frombuffer(payload, dtype=np.uint8)
    n = data.size // P
    return h, data[:n * P].reshape(n, P)


def read_kmer_buffer_header(path) -> tuple[KMerBufferHeader, int]:
    """Return (header, payload size in bytes)."""
    with open(path, "rb") as f:
        h = KMerBufferHeader.deserialize(f)
        pos = f.tell()
        f.seek(0, io.SEEK_END)
        return h, f.tell() - pos


def is_kmer_buffer_file(path) -> bool:
    return magic.file_has_header(path, MAGIC, VERSION)
