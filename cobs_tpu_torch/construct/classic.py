"""Classic index construction.

Same observable behavior as the reference pipeline
(reference: cobs/construction/classic_index.cpp):

- documents are processed in memory-bounded batches; each batch yields one
  `.cobs_classic` file in a temporary directory; existing batch files are
  skipped, which makes construction resumable (--continue);
- batches are hierarchically combined by row interleaving until a single
  index remains;
- the signature size is computed from the largest document's term count
  and the false positive rate.

The inner loop is the batched bit-matrix builder instead of the
reference's per-term scalar chain: by default the bit scatter runs on a
torch device (construct/device.py, the hand-written CUDA kernel on a
card), with `device_construct=False` in native host threads
(construct/bitmatrix.py). Both write the same bytes.
"""

import concurrent.futures
import os
import shutil
import sys
from pathlib import Path

import numpy as np

from cobs_tpu_torch import native
from cobs_tpu_torch.construct.bitmatrix import build_batch_matrix
from cobs_tpu_torch.construct.device import build_batch_matrix_device
from cobs_tpu_torch.construct.params import ClassicIndexParameters
from cobs_tpu_torch.core.params import calc_signature_size
from cobs_tpu_torch.fmt import classic as fmt_classic
from cobs_tpu_torch.ingest.document_list import DocumentList
from cobs_tpu_torch.ingest.util import pad_index
from cobs_tpu_torch.query.engine import resolve_device
from cobs_tpu_torch.settings import settings
from cobs_tpu_torch.utils.timer import Timer


#: set bits of each byte value
_POPCOUNT = np.array([bin(v).count("1") for v in range(256)], np.uint8)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def classic_construct_from_documents(
        doc_list: DocumentList, out_dir,
        params: ClassicIndexParameters) -> None:
    """Construct one or more classic batch indices into out_dir
    (reference: cobs/construction/classic_index.cpp:132-189)."""
    num_threads = max(1, params.num_threads)
    if params.num_hashes == 0:
        raise ValueError("num_hashes must not be zero")
    if params.signature_size == 0:
        raise ValueError("signature_size must not be zero")
    if params.device_construct:
        resolve_device(params.device)  # no CUDA: raise before any file
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    t = Timer()

    batch_size = (params.mem_bytes // max(1, params.signature_size // 8)
                  // num_threads)
    batch_size = max(8, _round_up(max(1, batch_size), 8))

    if params.device_construct:
        # cobs_tpu's device batch rule, kept so that --keep-temporary and
        # --continue see the same batch files: its plane held a byte per
        # document, (sig+1) x docs bytes within half the device budget
        # (the packed words here take an eighth of that)
        cap = (settings.max_device_index_bytes // 2
               // (params.signature_size + 1))
        batch_size = min(batch_size, max(8, cap // 8 * 8))
        # one batch at a time on the device; the builder hashes its
        # documents on worker threads
        num_threads = 1

    num_batches = (doc_list.size() + batch_size - 1) // batch_size

    def process(batch_num, entries, out_file):
        out_path = out_dir / (out_file + fmt_classic.FILE_EXTENSION)
        if out_path.exists():
            return  # resume: skip finished batches
        header = fmt_classic.ClassicIndexHeader(
            term_size=params.term_size, canonicalize=params.canonicalize,
            signature_size=params.signature_size,
            num_hashes=params.num_hashes,
            file_names=[e.name for e in entries])
        thr_t = Timer()
        if params.device_construct:
            data = build_batch_matrix_device(
                entries, params.signature_size, header.row_size,
                params.term_size, params.num_hashes,
                params.canonicalize, _log, device=params.device,
                timer=thr_t)
        else:
            thr_t.active("process")
            data = build_batch_matrix(
                entries, params.signature_size, header.row_size,
                params.term_size, params.num_hashes,
                params.canonicalize, _log)
        thr_t.active("write")
        fmt_classic.write_classic_index(out_path, header, data)
        thr_t.stop()
        t.merge(thr_t)
        ones = int(_POPCOUNT[data].sum(dtype=np.int64))
        ratio = ones / (data.size * 8)
        _log(f"{params.log_prefix}Construct Classic Index "
             f"{pad_index(batch_num)}/{pad_index(num_batches)} "
             f"documents {len(entries)} "
             f"signature_size {params.signature_size} "
             f"ratio_of_ones {ratio:.6f}")

    doc_list.process_batches_parallel(batch_size, num_threads, process)
    t.print("classic_construct_from_documents")


def _interleave_rows(mats: list[np.ndarray],
                     row_bits: list[int]) -> np.ndarray:
    """Concatenate per-index rows side by side, bit exact with
    classic_combine_streams (reference: classic_index.cpp:194-327):
    byte-aligned fast path when all but the last index have row_bits % 8
    == 0, bit-packing slow path otherwise."""
    aligned = all(rb % 8 == 0 for rb in row_bits[:-1])
    if aligned:
        return np.hstack(mats)
    # general path: unpack LSB-first bits, take the real row_bits of each,
    # concatenate, repack
    nrows = mats[0].shape[0]
    bit_parts = []
    for mat, rb in zip(mats, row_bits):
        bits = np.unpackbits(mat, axis=1, bitorder="little")[:, :rb]
        bit_parts.append(bits)
    all_bits = np.hstack(bit_parts)
    return np.packbits(all_bits, axis=1, bitorder="little")


def classic_combine(in_dir, out_dir, mem_bytes: int, num_threads: int,
                    keep_temporary: bool) -> tuple[bool, Path | None]:
    """One level of the hierarchical combine
    (reference: cobs/construction/classic_index.cpp:329-516).

    Returns (done, result_file): done is True when at most one output
    remains.
    """
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    num_threads = max(1, num_threads)

    index_paths = sorted(
        p for p in in_dir.rglob("*" + fmt_classic.FILE_EXTENSION))
    if not index_paths:
        raise RuntimeError(
            "classic_combine() could not find any cobs_classic to combine")

    if len(index_paths) == 1:
        out_path = out_dir / index_paths[0].name
        if keep_temporary:
            shutil.copy(index_paths[0], out_path)
        else:
            os.replace(index_paths[0], out_path)
            _try_rmdir(in_dir)
        return True, out_path

    headers = {p: fmt_classic.read_classic_header(p) for p in index_paths}

    # group into batches bounded by memory and open-file count; the
    # ~512 file-handle budget is GLOBAL, shared across worker threads
    # (reference: cobs/construction/classic_index.cpp:385-423), so the
    # per-batch cap times the concurrency below never exceeds it
    _FD_BUDGET = 512
    target_row_bits = 8 * mem_bytes // num_threads
    batch_cap = max(2, _FD_BUDGET // num_threads)
    batches: list[list[Path]] = []
    batch: list[Path] = []
    new_row_bits = 0
    for p in index_paths:
        rb = headers[p].row_bits
        # progress guarantee: a batch must merge at least two inputs
        # (a memory budget smaller than two rows would otherwise make
        # every level a pure rename and the combine loop never finish)
        if len(batch) >= 2 and (new_row_bits + rb > target_row_bits or
                                len(batch) >= batch_cap):
            batches.append(batch)
            batch, new_row_bits = [], 0
        batch.append(p)
        new_row_bits += rb
    if batch:
        batches.append(batch)
    # concurrency bound enforcing the global budget even when the
    # progress floor (2 inputs + 1 output per batch) dominates the cap
    max_open = max(len(b) for b in batches) + 1
    combine_workers = min(num_threads, max(1, _FD_BUDGET // max_open))

    def combine_one(b: int) -> None:
        files = batches[b]
        out_path = out_dir / (pad_index(b) + fmt_classic.FILE_EXTENSION)
        if len(files) == 1:
            if keep_temporary:
                shutil.copy(files[0], out_path)
            else:
                os.replace(files[0], out_path)
            return
        if out_path.exists():
            return
        hs = [headers[p] for p in files]
        h0 = hs[0]
        for h in hs[1:]:
            if (h.term_size, h.canonicalize, h.signature_size,
                    h.num_hashes) != (h0.term_size, h0.canonicalize,
                                      h0.signature_size, h0.num_hashes):
                raise ValueError(
                    "classic_combine: incompatible index parameters")
        file_names = [n for h in hs for n in h.file_names]
        new_header = fmt_classic.ClassicIndexHeader(
            term_size=h0.term_size, canonicalize=h0.canonicalize,
            signature_size=h0.signature_size, num_hashes=h0.num_hashes,
            file_names=file_names)
        row_bits = [h.row_bits for h in hs]
        row_bytes = [h.row_size for h in hs]
        new_row_bytes = new_header.row_size

        # stream rows in memory-bounded stripes
        stripe = max(1, mem_bytes // max(1, new_row_bytes) // 2)
        sig = h0.signature_size
        with open(out_path, "wb") as ofs:
            new_header.serialize(ofs)
            streams = [open(p, "rb") for p in files]
            try:
                for s, p in zip(streams, files):
                    fmt_classic.ClassicIndexHeader.deserialize(s)
                done_rows = 0
                while done_rows < sig:
                    this = min(stripe, sig - done_rows)
                    mats = []
                    for s, rbytes in zip(streams, row_bytes):
                        raw = s.read(rbytes * this)
                        if len(raw) != rbytes * this:
                            raise RuntimeError(
                                "classic_combine: truncated input")
                        mats.append(np.frombuffer(
                            raw, dtype=np.uint8).reshape(this, rbytes))
                    out = _interleave_rows(mats, row_bits)
                    assert out.shape == (this, new_row_bytes)
                    np.ascontiguousarray(out).tofile(ofs)
                    done_rows += this
            finally:
                for s in streams:
                    s.close()
        if not keep_temporary:
            for p in files:
                os.remove(p)

    if combine_workers > 1 and len(batches) > 1:
        with concurrent.futures.ThreadPoolExecutor(
                combine_workers) as pool:
            for fut in [pool.submit(combine_one, b)
                        for b in range(len(batches))]:
                fut.result()
    else:
        for b in range(len(batches)):
            combine_one(b)

    if not keep_temporary:
        _try_rmdir(in_dir)
    result = (out_dir / (pad_index(0) + fmt_classic.FILE_EXTENSION)
              if len(batches) == 1 else None)
    if len(batches) == 1 and not result.exists():
        # single input was moved under its original name
        remaining = sorted(out_dir.glob("*" + fmt_classic.FILE_EXTENSION))
        result = remaining[0] if remaining else None
    return len(batches) <= 1, result


def _try_rmdir(path: Path) -> None:
    try:
        path.rmdir()
    except OSError:
        pass


def _check_out_and_tmp(out_file: Path, tmp_path, params, extension: str):
    if not str(out_file).endswith(extension):
        raise ValueError(f"index file must end with {extension}")
    if out_file.exists():
        if params.clobber:
            out_file.unlink()
        elif not params.continue_:
            raise FileExistsError(
                "Output file exists, will not overwrite without clobber")
    if not tmp_path:
        tmp_path = Path(str(out_file) + ".tmp")
    tmp_path = Path(tmp_path)
    if tmp_path.exists():
        if params.clobber:
            shutil.rmtree(tmp_path)
        elif not params.continue_:
            raise FileExistsError(
                "Temporary directory exists, will not delete without clobber")
    tmp_path.mkdir(parents=True, exist_ok=True)
    return tmp_path


def get_max_file_size(doc_list: DocumentList, term_size: int) -> int:
    """Term count of the largest document
    (reference: classic_index.cpp:520-563)."""
    entries = doc_list.list()
    if not entries:
        return 0
    largest = max(entries, key=lambda e: (e.size, e.path))
    return largest.num_terms(term_size)


def classic_construct(filelist: DocumentList, out_file, tmp_path=None,
                      index_params: ClassicIndexParameters | None = None,
                      **kwargs) -> None:
    """Full classic construction driver
    (reference: cobs/construction/classic_index.cpp:565-659)."""
    params = index_params or ClassicIndexParameters(**kwargs)
    if params.num_hashes == 0:
        raise ValueError("num_hashes must not be zero")
    if params.signature_size != 0:
        raise ValueError("signature_size is computed, must be zero")
    if params.device_construct:
        resolve_device(params.device)  # no CUDA: raise before any file

    max_doc_size = get_max_file_size(filelist, params.term_size)
    params = ClassicIndexParameters(**{
        **params.__dict__,
        "signature_size": calc_signature_size(
            max_doc_size, params.num_hashes, params.false_positive_rate)})
    out_file = Path(out_file)
    tmp_path = _check_out_and_tmp(out_file, tmp_path, params,
                                  fmt_classic.FILE_EXTENSION)

    classic_construct_from_documents(
        filelist, tmp_path / pad_index(1), params)

    t = Timer()
    t.active("combine")
    i = 1
    while True:
        done, result_file = classic_combine(
            tmp_path / pad_index(i), tmp_path / pad_index(i + 1),
            params.mem_bytes, params.num_threads, params.keep_temporary)
        if done:
            break
        i += 1

    os.replace(result_file, out_file)
    if not params.keep_temporary:
        _try_rmdir(tmp_path / pad_index(i + 1))
        _try_rmdir(tmp_path)
    t.stop()
    t.print("classic_combine")


def classic_construct_list(input, out_file, index_params=None,
                           tmp_path=None) -> None:
    """Python-API variant taking a DocumentList
    (reference: python/module.cpp classic_construct_list)."""
    classic_construct(input, out_file, tmp_path, index_params)


def classic_construct_random(out_file, signature_size: int = 2 * 1024 * 1024,
                             num_documents: int = 10000,
                             document_size: int = 1000000,
                             num_hashes: int = 1, seed: int = 0) -> None:
    """Synthetic random index for benchmarks
    (reference: cobs/construction/classic_index.cpp:661-725).

    Each document is `document_size` random canonical 31-mers made,
    hashed and modded in one native pass (`native.random_rows`, a
    splitmix64 stream from a per-octet seed drawn from NumPy's PRNG) and
    set by the host scatter: the bytes of cobs_tpu with its native
    library. The reference draws from std::mt19937, so the outputs are
    statistically, not bitwise, equivalent to its.
    """
    t = Timer()
    term_size = 31
    rng = np.random.default_rng(seed)
    file_names = [f"file_{pad_index(i)}" for i in range(num_documents)]
    header = fmt_classic.ClassicIndexHeader(
        term_size=term_size, canonicalize=1, signature_size=signature_size,
        num_hashes=num_hashes, file_names=file_names)
    data = np.zeros((signature_size, header.row_size), dtype=np.uint8)

    t.active("generate")

    # octet groups: docs 8i..8i+7 share one byte column of `data`, so
    # groups never race; within a group the docs run serially. The native
    # calls release the GIL, so a thread pool gives real parallelism.
    def do_octet(g, seed_g):
        grng = np.random.default_rng(seed_g)
        for i in range(8 * g, min(8 * g + 8, num_documents)):
            rows = native.random_rows(
                int(grng.integers(0, 1 << 62)), document_size,
                term_size, num_hashes, signature_size)
            native.set_bits(data, rows, i)

    n_groups = -(-num_documents // 8)
    seeds = rng.integers(0, 1 << 62, size=n_groups)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, settings.threads)) as ex:
        list(ex.map(do_octet, range(n_groups), seeds))

    t.active("write")
    fmt_classic.write_classic_index(out_file, header, data)
    t.stop()
    t.print("classic_construct_random")
