"""Several processes: process-group setup, the global mesh, and
construction and federation per process.

The port of `cobs_tpu/parallel/distributed.py`. The reference is strictly
single-node (a pthread pool and mmap, no network layer, reference:
cobs/util/parallel_for.hpp:24-63); cobs_tpu adds the scale-out, and so
does this module:

1. every process calls :func:`initialize` (a `torch.distributed` process
   group: TCP rendezvous at host:port, or a shared file);
2. :func:`global_mesh` builds the ("batch", "docs") mesh over every
   process's devices; `Search(..., mesh=global_mesh())` then shards each
   index over it, each process uploading and scoring only its own cells,
   and each fetch exchanges the fetched candidates or counts once, so
   every process holds the whole answer. Scoring on such a mesh is SPMD:
   every process makes the same calls in the same order;
3. construction stays local to a process: each builds the index of its
   own slice of the documents (:func:`construct`), and the indexes
   federate at query time as the reference's multi-index search does
   (:func:`open_federated`), bit-identical to one build.

The process group uses the gloo backend. What crosses processes is host
data, already fetched for the host merge: per-shard top-k candidates, or
the [B, docs] counts of full ranking, kilobytes to megabytes per batch,
which gloo moves without a GPU; and NCCL refuses two ranks on one GPU,
the layout that tests several processes on a machine with one card.
"""

import dataclasses
import datetime
from pathlib import Path

import torch

from cobs_tpu_torch.parallel.sharded import Mesh, visible_devices


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: float | None = None) -> None:
    """Join the process group of `num_processes` processes as rank
    `process_id` (a no-op for one process). coordinator_address is
    "host:port" (TCP rendezvous at rank 0's address) or "file://PATH"
    (a file every process can reach); None reads torch's environment
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). `timeout`:
    seconds a collective waits for the others (torch's default when
    None)."""
    if num_processes is not None and num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator_address is None:
        init = "env://"
    elif coordinator_address.startswith("file://"):
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kwargs = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        "gloo", init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id, **kwargs)


def shutdown() -> None:
    """Leave the process group (a no-op for one process)."""
    if process_count() > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


def process_count() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def process_index() -> int:
    import torch.distributed as dist

    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def barrier(name: str = "cobs") -> None:
    """Cross-process sync point (a no-op for one process); `name` is for
    the reader, as in cobs_tpu."""
    del name
    if process_count() > 1:
        import torch.distributed as dist

        dist.barrier()


def global_mesh(n_batch: int = 1, devices=None) -> Mesh:
    """("batch", "docs") mesh over every process's devices, in rank order.

    `devices`: this process's devices (default: every visible CUDA card;
    a device may repeat, as in make_mesh). Each process's list is
    gathered with all_gather_object, so every process builds the same
    grid; its cells record the rank that owns them. With one process it
    is make_mesh's mesh over `devices`."""
    local = [str(d) for d in (visible_devices("cuda") if devices is None
                              else devices)]
    n = process_count()
    if n > 1:
        import torch.distributed as dist

        lists = [None] * n
        dist.all_gather_object(lists, local)
    else:
        lists = [local]
    flat = [(r, torch.device(d)) for r, devs in enumerate(lists)
            for d in devs]
    n_docs = len(flat) // n_batch
    if n_batch < 1 or n_docs < 1:
        raise ValueError(f"mesh needs {max(1, n_batch)} devices, only "
                         f"{len(flat)} available")
    grid = [flat[b * n_docs:(b + 1) * n_docs] for b in range(n_batch)]
    return Mesh(tuple(tuple(d for _, d in row) for row in grid),
                ranks=(tuple(tuple(r for r, _ in row) for row in grid)
                       if n > 1 else None),
                rank=process_index())


def partition_documents(doc_list, num_processes: int, process_id: int,
                        by_size: bool = False, align: int = 8):
    """Deterministic contiguous document slice for one process.

    The list is sorted (by path, or by size for compact construction so
    pages stay size-coherent) and split into `num_processes` contiguous
    chunks rounded up to `align` documents. The default 8 is the octet
    alignment the batch machinery uses (reference:
    classic_index.cpp:143-148), so a shard boundary never splits a byte
    column; compact construction passes align = 8*page_size so a shard
    boundary never splits a PAGE either — each shard's pages are then
    exactly the pages a single-process build would form, which is what
    makes federated compact scores bit-identical (see construct()).
    """
    from cobs_tpu_torch.ingest.document_list import DocumentList

    entries = list(doc_list.list())
    entries.sort(key=(lambda e: (e.size, e.path)) if by_size
                 else (lambda e: e.path))
    chunk = -(-len(entries) // max(1, num_processes))
    chunk = max(align, -(-chunk // align) * align)
    lo = min(process_id * chunk, len(entries))
    hi = min(lo + chunk, len(entries))
    part = DocumentList(entries=entries[lo:hi])
    if by_size:
        part.sort_by_size()
    return part


def shard_path(out_prefix, process_id: int, kind: str = "classic"):
    from cobs_tpu_torch.fmt import classic as fmt_classic
    from cobs_tpu_torch.fmt import compact as fmt_compact

    ext = (fmt_classic.FILE_EXTENSION if kind == "classic"
           else fmt_compact.FILE_EXTENSION)
    return Path(f"{out_prefix}.shard{process_id:04d}{ext}")


def shard_paths(out_prefix, num_processes: int | None = None,
                kind: str = "classic") -> list:
    if num_processes is None:
        num_processes = process_count()
    return [shard_path(out_prefix, i, kind)
            for i in range(num_processes)]


def construct(doc_list, out_prefix, kind: str = "classic",
              index_params=None, tmp_path=None,
              num_processes: int | None = None,
              process_id: int | None = None):
    """Construction across processes: this process builds the index of
    its own document slice, `<out_prefix>.shardNNNN.<ext>`.

    Every process computes the same partition from the same list, so the
    slices need no coordination; each process runs the ordinary
    construction over its slice, whose batch files double as checkpoints
    (reference machinery being scaled: cobs/construction/
    classic_index.cpp:143-189 batch splitting, resume semantics
    cpp:173-174). Query-time federation over the shards is the
    reference's multi-index search (reference:
    cobs/query/classic_search.cpp:413-435): open with
    :func:`open_federated`.

    Classic shards take the Bloom signature size of the global largest
    document, so every shard has the geometry one build would use and
    federated scores are bit-identical to it. Compact shards take the
    page size one build over the whole corpus would pick, and slice
    boundaries on multiples of 8 * page_size documents in global size
    order, so each shard's pages are one build's pages.

    Returns this process's shard path.
    """
    if num_processes is None:
        num_processes = process_count()
    if process_id is None:
        process_id = process_index()

    out = shard_path(out_prefix, process_id, kind)
    if kind == "classic":
        from cobs_tpu_torch.construct.classic import (
            _classic_construct_sized,
            get_max_file_size,
        )
        from cobs_tpu_torch.construct.params import ClassicIndexParameters
        from cobs_tpu_torch.core.params import calc_signature_size

        params = index_params or ClassicIndexParameters()
        if params.num_hashes == 0:
            raise ValueError("num_hashes must not be zero")
        if params.signature_size != 0:
            raise ValueError("signature_size is computed, must be zero")
        part = partition_documents(doc_list, num_processes, process_id)
        # global geometry: size from the global largest document
        max_doc = get_max_file_size(doc_list, params.term_size)
        params = dataclasses.replace(params, signature_size=(
            calc_signature_size(max_doc, params.num_hashes,
                                params.false_positive_rate)))
        if len(part) == 0:
            raise ValueError(
                f"process {process_id} has no documents: corpus of "
                f"{len(doc_list)} over {num_processes} processes")
        _classic_construct_sized(part, out, tmp_path, params)
    elif kind == "compact":
        from cobs_tpu_torch.construct.compact import (
            compact_construct,
            default_page_size,
        )
        from cobs_tpu_torch.construct.params import CompactIndexParameters

        params = index_params or CompactIndexParameters()
        page_size = params.page_size
        if page_size == 0:
            page_size = default_page_size(len(doc_list))
            params = dataclasses.replace(params, page_size=page_size)
        part = partition_documents(doc_list, num_processes, process_id,
                                   by_size=True, align=8 * page_size)
        if len(part) == 0:
            raise ValueError(
                f"process {process_id} has no documents: corpus of "
                f"{len(doc_list)} over {num_processes} processes is "
                f"fewer than one {8 * page_size}-document page per "
                "process — use a smaller page_size or fewer processes")
        compact_construct(part, out, tmp_path=tmp_path,
                          index_params=params)
    else:
        raise ValueError(f"unknown index kind {kind!r}")
    return out


def open_federated(out_prefix, num_processes: int | None = None,
                   kind: str = "classic", mesh=None, streamed=None,
                   device=None):
    """Every process's shard as one federated Search.

    All shards must be on this process's filesystem. With `mesh` (for
    example :func:`global_mesh`) each shard is document-sharded over
    the mesh; on a mesh that spans processes, scoring is then collective
    (every process makes the same calls in the same order)."""
    from cobs_tpu_torch.query.search import Search

    paths = shard_paths(out_prefix, num_processes, kind)
    missing = [p for p in paths if not p.is_file()]
    if missing:
        raise FileNotFoundError(
            f"missing index shards (construction incomplete?): "
            f"{[str(p) for p in missing]}")
    return Search([str(p) for p in paths], device=device,
                  streamed=streamed, mesh=mesh)
