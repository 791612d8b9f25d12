"""Document discovery and batching (reference: cobs/document_list.hpp).

A DocumentEntry names one (sub)document and streams its q-grams as
batched numpy window matrices (the construction path). DocumentList scans
directories / .list files, sorts, and splits into construction batches.
"""

import concurrent.futures
import dataclasses
import enum
import os
from pathlib import Path

import numpy as np

from cobs_tpu_torch.fmt import kmer_buffer as fmt_doc
from cobs_tpu_torch.core import kmer as kmer_codec
from cobs_tpu_torch.ingest.cortex import CortexFile
from cobs_tpu_torch.ingest.fasta import FastaFile
from cobs_tpu_torch.ingest.fasta_multi import FastaMultifile
from cobs_tpu_torch.ingest.fastq import FastqFile
from cobs_tpu_torch.ingest.text import TextFile
from cobs_tpu_torch.ingest.util import base_name, pad_index
from cobs_tpu_torch.settings import settings


class FileType(enum.Enum):
    Any = "any"
    Text = "text"
    Cortex = "cortex"
    KMerBuffer = "cobs"
    Fasta = "fasta"
    Fastq = "fastq"
    FastaMulti = "fasta_multi"
    FastqMulti = "fastq_multi"
    List = "list"


_STRING_TO_FILETYPE = {
    "any": FileType.Any,
    "text": FileType.Text,
    "cortex": FileType.Cortex,
    "cobs": FileType.KMerBuffer,
    "fasta": FileType.Fasta,
    "fastq": FileType.Fastq,
    "fasta_multi": FileType.FastaMulti,
    "fastq_multi": FileType.FastqMulti,
    "list": FileType.List,
}

_FASTA_EXTS = (".fa", ".fa.gz", ".fasta", ".fasta.gz", ".fna", ".fna.gz",
               ".ffn", ".ffn.gz", ".faa", ".faa.gz", ".frn", ".frn.gz")
_FASTQ_EXTS = (".fq", ".fq.gz", ".fastq", ".fastq.gz")


def string_to_file_type(s: str) -> FileType:
    try:
        return _STRING_TO_FILETYPE[s]
    except KeyError:
        raise ValueError(f"unknown file type {s!r}") from None


def identify_filetype(path) -> FileType:
    s = str(path)
    if s.endswith(".txt"):
        return FileType.Text
    if s.endswith(".ctx") or s.endswith(".cortex"):
        return FileType.Cortex
    if s.endswith(".cobs_doc"):
        return FileType.KMerBuffer
    if s.endswith(_FASTA_EXTS):
        return FileType.Fasta
    if s.endswith(_FASTQ_EXTS):
        return FileType.Fastq
    if s.endswith(".mfasta"):
        return FileType.FastaMulti
    if s.endswith(".mfastq"):
        return FileType.FastqMulti
    if s.endswith(".list"):
        return FileType.List
    return FileType.Any


_DOCUMENT_TYPES = {FileType.Text, FileType.Cortex, FileType.KMerBuffer,
                   FileType.Fasta, FileType.Fastq, FileType.FastaMulti,
                   FileType.FastqMulti}


def accept(path, filt: FileType) -> bool:
    ft = identify_filetype(path)
    if filt == FileType.Any:
        return ft in _DOCUMENT_TYPES
    return ft == filt


@dataclasses.dataclass
class DocumentEntry:
    path: str
    type: FileType
    name: str
    size: int
    subdoc_index: int = 0
    term_size: int = 0
    term_count: int = 0

    def _sort_key(self):
        return (self.path, self.subdoc_index)

    def num_terms(self, k: int) -> int:
        t = self.type
        if t == FileType.Text:
            return 0 if self.size < k else self.size - k + 1
        if t in (FileType.Cortex, FileType.KMerBuffer):
            return (self.term_count * (self.term_size - k + 1)
                    if self.term_size >= k else 0)
        if t == FileType.Fasta:
            return FastaFile(self.path).num_terms(k)
        if t == FileType.FastaMulti:
            return 0 if self.size < k else self.size - k + 1
        if t == FileType.Fastq:
            return FastqFile(self.path).num_terms(k)
        raise ValueError("DocumentEntry: unknown file type")

    def term_windows(self, term_size: int):
        """Yield [n, term_size] uint8 window batches (the batched
        ingestion path)."""
        t = self.type
        if t == FileType.Text:
            yield from TextFile(self.path).term_windows(term_size)
        elif t == FileType.Cortex:
            yield from CortexFile(self.path).term_windows(term_size)
        elif t == FileType.KMerBuffer:
            if term_size != 31:
                raise ValueError(".cobs_doc requires term_size 31")
            _, packed = fmt_doc.read_kmer_buffer(self.path)
            if packed.shape[0]:
                yield kmer_codec.decode(packed, 31)
        elif t == FileType.Fasta:
            yield from FastaFile(self.path).term_windows(term_size)
        elif t == FileType.FastaMulti:
            yield from FastaMultifile(self.path).term_windows(
                self.subdoc_index, term_size)
        elif t == FileType.Fastq:
            yield from FastqFile(self.path).term_windows(term_size)
        else:
            raise ValueError("DocumentEntry: unknown file type")

    def all_term_windows(self, term_size: int) -> np.ndarray:
        """All term windows concatenated, [total_terms, term_size]."""
        batches = list(self.term_windows(term_size))
        if not batches:
            return np.empty((0, term_size), dtype=np.uint8)
        if len(batches) == 1:
            return batches[0]
        return np.concatenate(batches, axis=0)


def load(path) -> list[DocumentEntry]:
    """Identify and load DocumentEntries for a path
    (reference: cobs/document_list.hpp:260-334)."""
    path = str(path)
    ft = identify_filetype(path)
    if ft == FileType.Text:
        return [DocumentEntry(path=path, type=ft, name=base_name(path),
                              size=os.path.getsize(path))]
    if ft == FileType.Cortex:
        ctx = CortexFile(path)
        return [DocumentEntry(path=path, type=ft, name=ctx.name,
                              size=os.path.getsize(path),
                              term_size=ctx.kmer_size,
                              term_count=ctx.num_kmers())]
    if ft == FileType.KMerBuffer:
        h, payload_size = fmt_doc.read_kmer_buffer_header(path)
        P = kmer_codec.packed_size(h.kmer_size)
        return [DocumentEntry(path=path, type=ft, name=h.name,
                              size=os.path.getsize(path),
                              term_size=h.kmer_size,
                              term_count=payload_size // P)]
    if ft == FileType.Fasta:
        fasta = FastaFile(path)
        return [DocumentEntry(path=path, type=ft, name=base_name(path),
                              size=fasta.size())]
    if ft == FileType.FastaMulti:
        mfasta = FastaMultifile(path)
        return [DocumentEntry(path=path, type=ft,
                              name=base_name(path) + "_" + pad_index(i),
                              size=mfasta.size(i), subdoc_index=i)
                for i in range(mfasta.num_documents())]
    if ft == FileType.Fastq:
        fastq = FastqFile(path)
        return [DocumentEntry(path=path, type=ft, name=base_name(path),
                              size=fastq.size())]
    raise ValueError(f"DocumentList: unknown document file to add: {path}")


class DocumentList:
    """Scans directories / .list files and batches documents."""

    def __init__(self, root=None, filter: FileType = FileType.Any,
                 entries: list[DocumentEntry] | None = None):
        self._list: list[DocumentEntry] = []
        if entries is not None:
            self._list = sorted(entries, key=DocumentEntry._sort_key)
        if root is not None:
            self.add_recursive(root, filter)

    def add(self, path) -> None:
        self._list.extend(load(path))

    def add_recursive(self, root, filter: FileType = FileType.Any) -> None:
        root = Path(root)
        paths: list[str] = []
        if root.is_dir():
            for dirpath, _dirnames, filenames in os.walk(root):
                for fn in filenames:
                    p = os.path.join(dirpath, fn)
                    if accept(p, filter):
                        paths.append(p)
        elif str(root).endswith(".list") or filter == FileType.List:
            with open(root) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#"):
                        continue
                    p = Path(line)
                    if not p.is_absolute():
                        p = root.parent / p
                    paths.append(str(p))
        elif root.is_file():
            paths.append(str(root))

        paths.sort()
        threads = max(1, settings.threads)
        if threads > 1 and len(paths) > 1:
            # parallel load so index caches are built in parallel
            with concurrent.futures.ThreadPoolExecutor(threads) as pool:
                for entries in pool.map(_load_quiet, paths):
                    self._list.extend(entries)
        else:
            for p in paths:
                self._list.extend(_load_quiet(p))
        self._list.sort(key=DocumentEntry._sort_key)

    def list(self) -> list[DocumentEntry]:
        return self._list

    def size(self) -> int:
        return len(self._list)

    def __len__(self) -> int:
        return len(self._list)

    def __getitem__(self, i: int) -> DocumentEntry:
        return self._list[i]

    def sort_by_size(self) -> None:
        self._list.sort(key=lambda d: (d.size, d.path))

    def _make_batches(self, batch_size: int):
        batches = []
        batch: list[DocumentEntry] = []
        first_filename = ""
        batch_num = 0
        for i, entry in enumerate(self._list):
            if not first_filename:
                first_filename = entry.name
            last_filename = entry.name
            batch.append(entry)
            if len(batch) == batch_size or (batch and
                                            i + 1 == len(self._list)):
                out_file = (pad_index(batch_num) + "_" +
                            "[" + first_filename + "-" + last_filename + "]")
                batches.append((batch_num, batch, out_file))
                batch = []
                first_filename = ""
                batch_num += 1
        return batches

    def process_batches_parallel(self, batch_size: int, num_threads: int,
                                 func) -> None:
        batches = self._make_batches(batch_size)
        if num_threads <= 1 or len(batches) <= 1:
            for batch_num, batch, out_file in batches:
                func(batch_num, batch, out_file)
            return
        with concurrent.futures.ThreadPoolExecutor(num_threads) as pool:
            futures = [pool.submit(func, bn, b, of)
                       for bn, b, of in batches]
            for fut in futures:
                fut.result()


def _load_quiet(path) -> list[DocumentEntry]:
    try:
        return load(path)
    except Exception as e:  # mirror reference: log and skip bad documents
        print(f"EXCEPTION: {e}")
        return []
