"""Compact index construction.

Documents are sorted by size and grouped into pages of 8*page_size; each
page gets a classic sub-index whose Bloom size fits the page's largest
document; the sub-indices are concatenated into one .cobs_compact file with
the last page's rows zero-padded to page_size
(reference: cobs/construction/compact_index.cpp:51-340).
"""

import math
import os
from pathlib import Path

import numpy as np

from cobs_tpu_torch.construct.classic import (
    _check_out_and_tmp,
    _try_rmdir,
    classic_combine,
    classic_construct_from_documents,
)
from cobs_tpu_torch.construct.params import (
    ClassicIndexParameters,
    CompactIndexParameters,
)
from cobs_tpu_torch.core.params import calc_signature_size
from cobs_tpu_torch.fmt import classic as fmt_classic
from cobs_tpu_torch.fmt import compact as fmt_compact
from cobs_tpu_torch.ingest.document_list import DocumentList
from cobs_tpu_torch.ingest.util import pad_index
from cobs_tpu_torch.query.engine import resolve_device
from cobs_tpu_torch.utils.timer import Timer


def _round_up_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def default_page_size(num_documents: int) -> int:
    """The reference's space-optimal compact page size
    (round_up_pow2(sqrt(docs/8)) clamped to [8, 4096], reference:
    cobs/construction/compact_index.cpp:184-189)."""
    page_size = _round_up_pow2(int(math.sqrt(num_documents / 8)))
    return min(max(page_size, 8), 4096)


def compact_combine_into_compact(in_dir, out_file, page_size: int = 4096,
                                 memory: int = 8 << 30,
                                 keep_temporary: bool = False) -> None:
    """Assemble classic sub-indices under in_dir into one compact file
    (reference: cobs/construction/compact_index.cpp:51-169)."""
    in_dir = Path(in_dir)
    paths = sorted(p for p in in_dir.rglob("*")
                   if p.is_file() and fmt_classic.is_classic_file(p))

    parameters = []
    file_names = []
    term_size = 0
    canonicalize = 0
    headers = []
    for i, p in enumerate(paths):
        h = fmt_classic.read_classic_header(p)
        headers.append(h)
        parameters.append(fmt_compact.CompactSubIndexParams(
            h.signature_size, h.num_hashes))
        file_names.extend(h.file_names)
        if term_size == 0:
            term_size, canonicalize = h.term_size, h.canonicalize
        if (h.term_size, h.canonicalize) != (term_size, canonicalize):
            raise ValueError("compact combine: inconsistent sub-indices")
        if i < len(paths) - 1:
            if h.row_size != page_size:
                raise ValueError("compact combine: row_size != page_size")
        elif h.row_size > page_size:
            raise ValueError("compact combine: last row_size > page_size")

    t = Timer()
    header = fmt_compact.CompactIndexHeader(
        term_size=term_size, canonicalize=canonicalize,
        page_size=page_size, parameters=parameters, file_names=file_names)

    out_file = Path(out_file)
    if out_file.parent != Path(""):
        out_file.parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "wb") as ofs:
        header.serialize(ofs)
        stripe_rows = max(1, int(memory) // max(1, page_size) // 2)
        for p, h in zip(paths, headers):
            t.active("copy")
            with open(p, "rb") as ifs:
                fmt_classic.ClassicIndexHeader.deserialize(ifs)
                done = 0
                while done < h.signature_size:
                    nr = min(stripe_rows, h.signature_size - done)
                    raw = ifs.read(nr * h.row_size)
                    if len(raw) != nr * h.row_size:
                        raise RuntimeError(
                            "compact combine: truncated sub-index")
                    if h.row_size == page_size:
                        ofs.write(raw)
                    else:
                        t.active("expand")
                        rows = np.frombuffer(raw, dtype=np.uint8) \
                            .reshape(nr, h.row_size)
                        padded = np.zeros((nr, page_size),
                                          dtype=np.uint8)
                        padded[:, :h.row_size] = rows
                        t.active("write")
                        np.ascontiguousarray(padded).tofile(ofs)
                        t.active("copy")
                    done += nr
            t.stop()
            if not keep_temporary:
                os.remove(p)
                _try_rmdir(p.parent)
    if not keep_temporary:
        _try_rmdir(in_dir)
    t.print("compact_combine_into_compact()")


def compact_construct(doc_list: DocumentList, index_file, tmp_path=None,
                      index_params: CompactIndexParameters | None = None,
                      **kwargs) -> None:
    """Full compact construction driver
    (reference: cobs/construction/compact_index.cpp:171-340)."""
    params = index_params or CompactIndexParameters(**kwargs)
    if params.device_construct:
        resolve_device(params.device)  # no CUDA: raise before any file

    index_file = Path(index_file)
    doc_list.sort_by_size()

    page_size = params.page_size
    if page_size == 0:
        page_size = default_page_size(doc_list.size())

    num_pages = -(-doc_list.size() // (8 * page_size))
    num_threads = max(1, params.num_threads)
    if num_threads > num_pages:
        num_threads = max(1, doc_list.size() // (8 * page_size))

    tmp_path = _check_out_and_tmp(index_file, tmp_path, params,
                                  fmt_compact.FILE_EXTENSION)

    iteration = 1

    def process(batch_num, entries, _out_file):
        max_doc_size = max(
            (e.num_terms(params.term_size) for e in entries), default=0)
        if max_doc_size == 0:
            return
        signature_size = calc_signature_size(
            max_doc_size, params.num_hashes, params.false_positive_rate)
        classic_params = ClassicIndexParameters(
            term_size=params.term_size, canonicalize=params.canonicalize,
            num_hashes=params.num_hashes,
            false_positive_rate=params.false_positive_rate,
            signature_size=signature_size,
            mem_bytes=params.mem_bytes // max(1, num_threads),
            num_threads=-(-params.num_threads // num_threads),
            log_prefix=f"[{pad_index(batch_num, 2)}/"
                       f"{pad_index(num_pages, 2)}] ",
            keep_temporary=params.keep_temporary,
            device_construct=params.device_construct,
            device=params.device)
        batch_list = DocumentList(entries=entries)
        classic_construct_from_documents(
            batch_list, tmp_path / pad_index(iteration) /
            pad_index(batch_num), classic_params)

    doc_list.process_batches_parallel(8 * page_size, num_threads, process)

    # hierarchically combine each page directory
    while True:
        all_combined = True
        level_dir = tmp_path / pad_index(iteration)
        next_dir = tmp_path / pad_index(iteration + 1)
        if level_dir.exists():
            for page_dir in sorted(level_dir.iterdir()):
                if not page_dir.is_dir():
                    continue
                done, _ = classic_combine(
                    page_dir, next_dir / page_dir.name,
                    params.mem_bytes, params.num_threads,
                    params.keep_temporary)
                all_combined = all_combined and done
            if not params.keep_temporary:
                _try_rmdir(level_dir)
        if all_combined:
            break
        iteration += 1

    compact_combine_into_compact(
        tmp_path / pad_index(iteration + 1), index_file,
        page_size, params.mem_bytes, params.keep_temporary)

    if not params.keep_temporary:
        _try_rmdir(tmp_path)


def compact_construct_list(input, out_file, index_params=None,
                           tmp_path=None) -> None:
    compact_construct(input, out_file, tmp_path, index_params)


def compact_repack(in_file, out_file, page_size: int = 0,
                   clobber: bool = False, memory: int = 1 << 30) -> int:
    """Merge consecutive equal-signature pages of a compact index into
    wider pages, bit-preserving per document, and write a new file.

    Pages with equal Bloom sizes (and equal num_hashes) probe the same
    row per hash, so their matrices concatenate column-wise without
    changing a single gathered bit, score, or document number — the
    streaming analog of the load-time merge in
    query/engine._load_matrix_coalesced. A reference-default index
    (space-optimal small pages, compact_index.cpp:184-189) over a
    similar-size corpus repacks into >= 512 B pages in one pass;
    DeviceIndex then gathers one wide row per term instead of one padded
    row per page. Page layout being preserved (reference:
    cobs/construction/compact_index.cpp:171-340).

    page_size: target page size in bytes (0 = merge maximally). The
    achievable sizes are old_page_size * d for divisors d of the merge
    factor; the largest achievable size <= page_size is used.
    Returns the new page size in bytes.
    """
    in_file, out_file = Path(in_file), Path(out_file)
    if out_file.exists():
        if os.path.samefile(in_file, out_file):
            # same INODE (symlinks and hardlinks included): the payload
            # is memory-mapped from in_file while the output is
            # written — truncating it would SIGBUS mid-copy AND
            # destroy the input
            raise ValueError(
                "compact repack: output must differ from input "
                "(the input is read while the output is written)")
        if not clobber:
            raise FileExistsError(f"{out_file} exists (use --clobber)")
    h, payload_off = fmt_compact.read_compact_header(in_file)
    keys = [(p.signature_size, p.num_hashes) for p in h.parameters]
    m = fmt_compact.coalesce_factor(keys)
    if m == 1 and len(keys) > 1:
        raise ValueError(
            "compact repack: adjacent pages have unequal Bloom sizes — "
            "nothing merges bit-exactly; rebuild with a larger "
            "--page-size instead")
    if page_size:
        # valid factors are exactly the divisors of the maximal one
        # (any all-uniform grouping's breaks are multiples of its m)
        want = max(1, page_size // h.page_size)
        m = max(d for d in range(1, m + 1) if m % d == 0 and d <= want)

    new_page = h.page_size * m
    new_params = [h.parameters[i] for i in range(0, len(keys), m)]
    header = fmt_compact.CompactIndexHeader(
        term_size=h.term_size, canonicalize=h.canonicalize,
        page_size=new_page, parameters=new_params,
        file_names=list(h.file_names))

    offs = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(np.asarray([k[0] for k in keys], dtype=np.int64)
              * h.page_size, out=offs[1:])
    mm = np.memmap(in_file, dtype=np.uint8, mode="r", offset=payload_off,
                   shape=(int(offs[-1]),))
    if out_file.parent != Path(""):
        out_file.parent.mkdir(parents=True, exist_ok=True)
    stripe_rows = max(1, int(memory) // max(1, new_page) // 2)
    with open(out_file, "wb") as ofs:
        header.serialize(ofs)
        for g0, p in zip(range(0, len(keys), m), new_params):
            r = 0
            while r < p.signature_size:
                n = min(stripe_rows, p.signature_size - r)
                stripe = np.empty((n, new_page), dtype=np.uint8)
                for j in range(m):
                    blk = mm[offs[g0 + j] + r * h.page_size:
                             offs[g0 + j] + (r + n) * h.page_size]
                    stripe[:, j * h.page_size:(j + 1) * h.page_size] = \
                        blk.reshape(n, h.page_size)
                stripe.tofile(ofs)
                r += n
    return new_page
