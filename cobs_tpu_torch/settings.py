"""Global runtime settings of the PyTorch port.

A subset of `cobs_tpu.settings` (reference: cobs/settings.hpp:16-23):
the device that holds the index and runs construction's bit scatter, the
host worker threads, whether document caches are written, when an index
is streamed from host mmap instead of held on the device, where the
streamed backend scores, where query hashing runs, and how many batches
one multi-batch dispatch packs, the mesh of device construction and the
term count at which a query on a mesh splits its terms over the mesh's
"batch" axis. The TPU package's other dispatch knobs
(hash-ahead depth, dispatch groups, tier fetch) worked around its slow
host link and have no counterpart here.
"""

import dataclasses
import os


@dataclasses.dataclass
class Settings:
    #! torch device that holds the index matrix and runs the kernels
    device: str = "cuda"
    #! host worker threads (ingest, hashing and the host scatter of
    #! construction; the streamed backend's row gather and host scorer)
    threads: int = os.cpu_count() or 1
    #! disable reading and writing of `.cobs_cache` document caches
    disable_cache: bool = False
    #! load every index file onto the device, whatever its size (the
    #! reference's --load-complete)
    load_complete_index: bool = False
    #! index files larger than this are served by the streamed backend
    #! (StreamedIndex: the payload stays in a host mmap and each batch
    #! reads only the rows it touches) instead of held on the device
    max_device_index_bytes: int = int(os.environ.get(
        "COBS_TPU_DEVICE_INDEX_BYTES", 64 << 30))
    #! where the streamed backend scores a batch: "device" = gather the
    #! batch's unique rows on the host, upload them and run the
    #! gather-and-count kernel; "host" = the native host scorer
    #! (native.score_batch_host) off the mmap, with no device work;
    #! "auto" = "device" when the index's device is CUDA, else "host"
    streamed_host_score: str = dataclasses.field(
        default_factory=lambda: os.environ.get("COBS_TPU_STREAMED_SCORE",
                                               "auto"))
    #! where query hashing runs: "auto"/"device" = on the index's device
    #! (upload the raw query bytes; the device_hash kernel computes the
    #! row ids before the gather-and-count kernel), "host" = the numpy
    #! pipeline (create_hashes + row_indices, then upload the row ids).
    #! A streamed index that scores on the host, or whose row ids
    #! exceed int32, always hashes on the host.
    device_hash: str = dataclasses.field(default_factory=lambda: os.environ
                                         .get("COBS_TPU_DEVICE_HASH",
                                              "auto"))
    #! multi-batch dispatch ceiling: when the server's queue or a query
    #! stream is deep, up to this many batches go to the device as one
    #! payload (one upload, one launch of the hash kernel, of the
    #! gather-and-count kernel and of the top-k), dividing the host's
    #! per-batch dispatch and fetch cost; 1 disables. Applies when every
    #! index is a DeviceIndex.
    mega_batches: int = dataclasses.field(default_factory=lambda: int(
        os.environ.get("COBS_TPU_MEGA_BATCHES", "16")))
    #! mesh for device construction (parallel.sharded.Mesh): each "docs"
    #! shard of a batch's words lives on its own device and takes the
    #! updates of its documents; None = every visible CUDA card on the
    #! docs axis when more than one is visible, else the one device
    construct_mesh: object = None
    #! sequence split: a query on a mesh whose term count reaches this is
    #! split over the mesh's "batch" axis (each "batch" row counts a
    #! slice of its terms; the partial counts are summed), so a long
    #! query keeps the whole mesh busy. Terms per query are L - k + 1,
    #! so this triggers for ~64 kbp queries by default.
    seq_split_terms: int = dataclasses.field(default_factory=lambda: int(
        os.environ.get("COBS_TPU_SEQ_SPLIT_TERMS", 1 << 16)))


settings = Settings()


def disable_cache(disable: bool = True) -> None:
    """Disable reading and writing of document cache files
    (`cobs_index.disable_cache()`, reference: python/module.cpp:389-394)."""
    settings.disable_cache = disable
