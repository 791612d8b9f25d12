"""COBS file framing: magic words and version checks.

Byte-compatible with the reference container framing
(reference: cobs/file/header.hpp:22-59): every file starts with
``b"COBS:" + magic_word + u32le version`` and the header section ends with
``magic_word`` again. Index files written by either implementation
interoperate.
"""

import io
import struct


class FileIOError(Exception):
    pass


def write_magic_begin(os_: io.BufferedIOBase, magic_word: bytes,
                      version: int) -> None:
    os_.write(b"COBS:")
    os_.write(magic_word)
    os_.write(struct.pack("<I", version))


def write_magic_end(os_: io.BufferedIOBase, magic_word: bytes) -> None:
    os_.write(magic_word)


def check_magic_word(is_: io.BufferedIOBase, magic_word: bytes) -> None:
    got = is_.read(len(magic_word))
    if got != magic_word:
        raise FileIOError("invalid file type")


def read_magic_begin(is_: io.BufferedIOBase, magic_word: bytes,
                     version: int) -> None:
    check_magic_word(is_, b"COBS:")
    check_magic_word(is_, magic_word)
    raw = is_.read(4)
    if len(raw) != 4 or struct.unpack("<I", raw)[0] != version:
        raise FileIOError("invalid file version")


def read_magic_end(is_: io.BufferedIOBase, magic_word: bytes) -> None:
    check_magic_word(is_, magic_word)


def file_has_header(path, magic_word: bytes, version: int) -> bool:
    """True iff the file begins with the given COBS magic framing
    (reference: cobs/util/file.hpp:44-66)."""
    try:
        with open(path, "rb") as f:
            read_magic_begin(f, magic_word, version)
        return True
    except (OSError, FileIOError):
        return False


def read_line(is_: io.BufferedIOBase) -> str:
    """Read a '\\n'-terminated string (like std::getline)."""
    out = bytearray()
    while True:
        c = is_.read(1)
        if not c or c == b"\n":
            return out.decode("utf-8", errors="surrogateescape")
        out += c

